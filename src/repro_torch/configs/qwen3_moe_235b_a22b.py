"""Qwen3-MoE 235B-A22B — 128 experts top-8, 94 layers. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,
        vocab_size=151_936,
        head_dim=128,
        n_experts=128,
        experts_per_token=8,
        rope_theta=1_000_000.0,
        act="silu",
        fsdp=True,               # 470 GB bf16 params: 2D (model x data) sharding required
        source="[hf:Qwen/Qwen3-30B-A3B]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        head_dim=32,
        n_experts=4,
        experts_per_token=2,
        act="silu",
        remat=False,
        source="[hf:Qwen/Qwen3-30B-A3B]",
    )
