"""xLSTM-125M — sLSTM + mLSTM blocks (every 4th block sLSTM). [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "xlstm-125m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,                   # xLSTM blocks carry their own projections
        vocab_size=50_304,
        slstm_every=4,            # blocks 3, 7, 11 are sLSTM; rest mLSTM
        act="gelu",
        fsdp=False,
        # 125M params / 16-way TP = sliver matmuls (768x96) whose gather/
        # reduce traffic dominates the roofline (~120 GB/dev/step measured).
        # Pure DP replicates the 250 MB of params and runs batch over both
        # axes: the only collective left is one grad all-reduce (~1 GB/dev).
        pure_dp=True,
        source="[arXiv:2405.04517]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="ssm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        slstm_every=2,            # one mLSTM + one sLSTM block
        act="gelu",
        remat=False,
        source="[arXiv:2405.04517]",
    )
