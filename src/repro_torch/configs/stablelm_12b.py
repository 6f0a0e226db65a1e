"""StableLM-2 12B — dense decoder. [hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "stablelm-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=100_352,
        head_dim=160,
        rope_theta=10_000.0,
        act="silu",
        fsdp=True,
        source="[hf:stabilityai/stablelm-2-1_6b]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=352,
        vocab_size=512,
        head_dim=32,
        act="silu",
        remat=False,
        source="[hf:stabilityai/stablelm-2-1_6b]",
    )
