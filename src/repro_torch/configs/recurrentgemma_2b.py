"""RecurrentGemma-2B — Griffin: RG-LRU recurrent blocks + local attention,
repeating (recurrent, recurrent, local-attn). [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "recurrentgemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,             # MQA in the local-attention blocks
        d_ff=7680,
        vocab_size=256_000,
        head_dim=256,
        block_pattern=("rglru", "rglru", "attn"),
        lru_width=2560,
        conv_width=4,
        local_attn_window=2048,
        act="gelu",               # GeGLU MLP per Griffin
        fsdp=False,
        source="[arXiv:2402.19427]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="hybrid",
        n_layers=3,               # one full (rglru, rglru, attn) pattern
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        d_ff=384,
        vocab_size=512,
        head_dim=32,
        block_pattern=("rglru", "rglru", "attn"),
        lru_width=128,
        conv_width=4,
        local_attn_window=64,
        act="gelu",
        remat=False,
        source="[arXiv:2402.19427]",
    )
