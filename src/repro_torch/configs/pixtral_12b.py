"""Pixtral-12B — VLM: mistral-nemo-style decoder consuming stub patch
embeddings from a (stubbed) pixtral-ViT frontend. [hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "pixtral-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=131_072,
        head_dim=128,
        rope_theta=1_000_000.0,
        vision_seq=256,          # stub: one 1024x1024 image → 256 merged patch embeds
        act="silu",
        fsdp=True,
        source="[hf:mistralai/Pixtral-12B-2409]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=352,
        vocab_size=512,
        head_dim=32,
        vision_seq=16,
        act="silu",
        remat=False,
        source="[hf:mistralai/Pixtral-12B-2409]",
    )
