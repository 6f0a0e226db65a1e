"""Suffix prefill on the card: wrapper of ``csrc/flash_suffix_prefill.cu``.

Replaces the TPU kernel ``repro/kernels/flash_suffix_prefill.py::
suffix_prefill`` (fp pools): the uncached suffix of each row attends over
its cached prefix, read through the row's page table, and over itself,
causally. Plain version: ``ref.suffix_prefill_ref``.

``suffix_prefill_int8`` is the TPU kernel's ``pool_k_scale``/
``pool_v_scale`` branch: int8 prefix pages with f32 scales (P, page, Hkv),
dequantized in the kernel to q's dtype; the suffix's k/v stay in q's dtype.
Plain version: ``ref.suffix_prefill_int8_ref``.

As in ``flash_prefill``, the C entry points pick their body by dtype:
bfloat16 on the tensor cores (``csrc/prefill_tc.cuh``: the prefix pages
written into the swizzled tile by the producer warps through the page
table, int8 pages dequantized there; the suffix's k/v by TMA), float32 on
the SIMT body of ``csrc/common.cuh``. In both, the int8 kernel is bitwise
the fp kernel over the pool dequantized to q's dtype."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import check_group


def _check(name, q, k_suf, v_suf, pool_k, pool_v, pool_k_scale, pool_v_scale, table,
           starts, prefix_width):
    scales = ({} if pool_k_scale is None
              else dict(pool_k_scale=pool_k_scale, pool_v_scale=pool_v_scale))
    build.check_cuda(name, q=q, k_suf=k_suf, v_suf=v_suf, pool_k=pool_k, pool_v=pool_v,
                     table=table, starts=starts, **scales)
    n, s, hkv, g, hd = q.shape
    p, page = pool_k.shape[:2]
    check_group(name, hd, g)
    if k_suf.shape != (n, s, hkv, hd) or v_suf.shape != k_suf.shape:
        raise ValueError(f"{name}: suffix k/v do not match q")
    if pool_k.shape != (p, page, hkv, hd) or pool_v.shape != pool_k.shape:
        raise ValueError(f"{name}: pools do not match q")
    if k_suf.dtype != q.dtype or v_suf.dtype != q.dtype:
        raise TypeError(f"{name}: q and the suffix k/v must share one dtype")
    build.check_pool(name, q, pool_k, pool_v, pool_k_scale, pool_v_scale)
    if table.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError(f"{name}: table and starts must be int32")
    if table.shape[0] != n or starts.shape != (n,):
        raise ValueError(f"{name}: table / starts do not match the row count")
    if prefix_width < 1:
        raise ValueError(f"{name}: prefix_width must be >= 1, got {prefix_width}")
    if q.dtype == torch.bfloat16:
        build.check_tma(name, q=q, k_suf=k_suf, v_suf=v_suf, pool_k=pool_k, pool_v=pool_v)
    t_w = table.shape[1]
    return (n, s, hkv, g, hd, page, t_w, min(prefix_width, t_w))


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
    scale: float | None = None,  # None: hd**-0.5
) -> torch.Tensor:
    dims = _check("suffix_prefill", q, k_suf, v_suf, pool_k, pool_v, None, None, table,
                  starts, prefix_width)
    out = torch.empty_like(q)
    build.launch(
        "suffix_prefill", q.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
        pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(), starts.data_ptr(),
        out.data_ptr(), build.dtype_code(q), *dims,
        q.shape[-1] ** -0.5 if scale is None else scale,
    )
    return out


def suffix_prefill_int8(
    q: torch.Tensor,             # (n, S, Hkv, G, hd) float32 / bfloat16
    k_suf: torch.Tensor,         # (n, S, Hkv, hd), q's dtype
    v_suf: torch.Tensor,
    pool_k: torch.Tensor,        # (P, page, Hkv, hd) int8
    pool_v: torch.Tensor,
    pool_k_scale: torch.Tensor,  # (P, page, Hkv) float32
    pool_v_scale: torch.Tensor,
    table: torch.Tensor,         # (n, T) int32
    starts: torch.Tensor,        # (n,) int32
    *,
    prefix_width: int,
    scale: float | None = None,
) -> torch.Tensor:
    dims = _check("suffix_prefill_int8", q, k_suf, v_suf, pool_k, pool_v, pool_k_scale,
                  pool_v_scale, table, starts, prefix_width)
    out = torch.empty_like(q)
    build.launch(
        "suffix_prefill_int8", q.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
        pool_k.data_ptr(), pool_v.data_ptr(), pool_k_scale.data_ptr(), pool_v_scale.data_ptr(),
        table.data_ptr(), starts.data_ptr(), out.data_ptr(), build.dtype_code(q), *dims,
        q.shape[-1] ** -0.5 if scale is None else scale,
    )
    return out
