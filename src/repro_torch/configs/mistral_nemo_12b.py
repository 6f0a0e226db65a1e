"""Mistral-Nemo 12B — dense, 128k context. [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "mistral-nemo-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=131_072,
        head_dim=128,
        rope_theta=1_000_000.0,   # 128k-context rope base
        act="silu",
        fsdp=True,
        source="[hf:mistralai/Mistral-Nemo-Base-2407]",
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
        rope_theta=1_000_000.0,
        act="silu",
        remat=False,
        source="[hf:mistralai/Mistral-Nemo-Base-2407]",
    )
