"""Causal GQA flash attention on the card: wrapper of ``csrc/flash_prefill.cu``.

Replaces the TPU kernel ``repro/kernels/flash_prefill.py::flash_prefill``
(causal mode, optional sliding window), used here for cold prefill. Plain
version: ``ref.flash_prefill_ref``.

The C entry point picks its body by dtype. bfloat16 (the serving paths)
runs on the tensor cores: ``wgmma`` for Q·Kᵀ and P·V, K/V tiles brought in
by TMA through an mbarrier ring (``csrc/prefill_tc.cuh``); P enters P·V as
three bf16 terms (hi + mid + lo, ~24 bits), so the output stays within the
bf16 gate of the plain fp32 version (one bf16 rounding of P would not: see
``tests/test_torch_kernels.py``). float32 (the
reference-parity runs, whose golden tokens must match the JAX engine's
exactly) runs on the SIMT body of ``csrc/common.cuh`` in fp32 FMAs. Each
dtype has one body: nothing falls back from one to the other."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import HEAD_DIMS, WIDE_HEAD_DIMS

# Query heads per kv head a block can hold: a block's rows are BQ positions
# times the G heads, at most 64 in the SIMT body (32 at hd 256, where 64
# fp32 rows and their tiles overflow shared memory) and 64 per consumer
# warpgroup in the tensor-core body (BQ = 64·W // G >= 1).
MAX_GROUP = 64
MAX_GROUP_HD256 = 32


def check_group(name: str, hd: int, g: int, head_dims=HEAD_DIMS) -> None:
    if hd not in head_dims:
        raise ValueError(f"{name}: head dim {hd} unsupported (need {head_dims})")
    most = MAX_GROUP_HD256 if hd == 256 else MAX_GROUP
    if not 1 <= g <= most:
        raise ValueError(f"{name}: group {g} unsupported: a block holds at most {most} "
                         f"query heads per kv head at hd {hd}")


def flash_prefill(
    q: torch.Tensor,  # (B, S, Hkv, G, hd)
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,
    *,
    window: int = 0,
    scale: float | None = None,  # None: hd**-0.5
) -> torch.Tensor:
    build.check_cuda("flash_prefill", q=q, k=k, v=v)
    b, s, hkv, g, hd = q.shape
    t = k.shape[1]
    check_group("flash_prefill", hd, g, WIDE_HEAD_DIMS)
    if k.shape != (b, t, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_prefill: k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_prefill: q, k and v must share one dtype")
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        build.check_tma("flash_prefill", q=q, k=k, v=v, out=out)
    build.launch(
        "flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.dtype_code(q), b, s, t, hkv, g, hd, window,
        hd**-0.5 if scale is None else scale,
    )
    return out
