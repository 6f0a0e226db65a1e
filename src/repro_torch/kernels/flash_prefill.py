"""Causal GQA flash attention on the card: wrapper of ``csrc/flash_prefill.cu``.

Replaces the TPU kernel ``repro/kernels/flash_prefill.py::flash_prefill``
(causal mode, optional sliding window), used here for cold prefill. Plain
version: ``ref.flash_prefill_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import HEAD_DIMS

MAX_GROUP = 64  # query heads per kv head a block can hold (rows = BQ*G <= 64)


def flash_prefill(
    q: torch.Tensor,  # (B, S, Hkv, G, hd)
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    build.check_cuda("flash_prefill", q=q, k=k, v=v)
    b, s, hkv, g, hd = q.shape
    t = k.shape[1]
    if hd not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"flash_prefill: head dim {hd} (need {HEAD_DIMS}) / group {g} "
                         f"(need <= {MAX_GROUP}) unsupported")
    if k.shape != (b, t, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_prefill: k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_prefill: q, k and v must share one dtype")
    out = torch.empty_like(q)
    build.launch(
        "flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.dtype_code(q), b, s, t, hkv, g, hd, window, hd**-0.5,
    )
    return out
