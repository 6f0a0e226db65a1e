"""StableLM-2 1.6B — dense decoder. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "stablelm-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100_352,
        rope_theta=10_000.0,
        act="silu",
        fsdp=False,
        source="[hf:stabilityai/stablelm-2-1_6b]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=352,
        vocab_size=512,
        act="silu",
        remat=False,
        source="[hf:stabilityai/stablelm-2-1_6b]",
    )
