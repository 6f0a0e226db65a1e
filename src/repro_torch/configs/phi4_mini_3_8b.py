"""Phi-4-mini 3.8B — dense, RoPE + SwiGLU + GQA. [arXiv:2412.08905]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "phi4-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200_064,
        rope_theta=10_000.0,
        act="silu",
        tie_embeddings=True,
        fsdp=False,
        source="[arXiv:2412.08905]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=120,
        n_heads=4,
        n_kv_heads=2,
        d_ff=320,
        vocab_size=512,
        act="silu",
        tie_embeddings=True,
        remat=False,
        source="[arXiv:2412.08905]",
    )
