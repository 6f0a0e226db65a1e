"""OLMoE 1B-7B — sparse MoE, 64 experts top-8. [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50_304,
        n_experts=64,
        experts_per_token=8,
        rope_theta=10_000.0,
        act="silu",
        fsdp=False,
        source="[arXiv:2409.02060]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab_size=512,
        n_experts=4,
        experts_per_token=2,
        act="silu",
        remat=False,
        source="[arXiv:2409.02060]",
    )
