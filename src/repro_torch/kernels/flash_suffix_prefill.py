"""Suffix prefill on the card: wrapper of ``csrc/flash_suffix_prefill.cu``.

Replaces the TPU kernel ``repro/kernels/flash_suffix_prefill.py::
suffix_prefill`` (fp pools): the uncached suffix of each row attends over
its cached prefix, read through the row's page table, and over itself,
causally. Plain version: ``ref.suffix_prefill_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import MAX_GROUP
from repro_torch.kernels.paged_decode import HEAD_DIMS


def suffix_prefill(
    q: torch.Tensor,       # (n, S, Hkv, G, hd) — roped at starts[r] + i
    k_suf: torch.Tensor,   # (n, S, Hkv, hd)
    v_suf: torch.Tensor,
    pool_k: torch.Tensor,  # (P, page, Hkv, hd)
    pool_v: torch.Tensor,
    table: torch.Tensor,   # (n, T) int32
    starts: torch.Tensor,  # (n,) int32
    *,
    prefix_width: int,
) -> torch.Tensor:
    build.check_cuda("suffix_prefill", q=q, k_suf=k_suf, v_suf=v_suf, pool_k=pool_k,
                     pool_v=pool_v, table=table, starts=starts)
    n, s, hkv, g, hd = q.shape
    p, page = pool_k.shape[:2]
    t_w = table.shape[1]
    if hd not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"suffix_prefill: head dim {hd} (need {HEAD_DIMS}) / group {g} "
                         f"(need <= {MAX_GROUP}) unsupported")
    if k_suf.shape != (n, s, hkv, hd) or v_suf.shape != k_suf.shape:
        raise ValueError("suffix_prefill: suffix k/v do not match q")
    if pool_k.shape != (p, page, hkv, hd) or pool_v.shape != pool_k.shape:
        raise ValueError("suffix_prefill: pools do not match q")
    if any(x.dtype != q.dtype for x in (k_suf, v_suf, pool_k, pool_v)):
        raise TypeError("suffix_prefill: q, suffix k/v and the pools must share one dtype")
    if table.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("suffix_prefill: table and starts must be int32")
    if table.shape[0] != n or starts.shape != (n,):
        raise ValueError("suffix_prefill: table / starts do not match the row count")
    if prefix_width < 1:
        raise ValueError(f"suffix_prefill: prefix_width must be >= 1, got {prefix_width}")
    out = torch.empty_like(q)
    build.launch(
        "suffix_prefill", q.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
        pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(), starts.data_ptr(),
        out.data_ptr(), build.dtype_code(q), n, s, hkv, g, hd, page, t_w,
        min(prefix_width, t_w), hd**-0.5,
    )
    return out
