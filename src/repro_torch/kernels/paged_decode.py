"""Paged decode attention on the card: wrapper of ``csrc/paged_decode.cu``.

Replaces the TPU kernel ``repro/kernels/paged_decode.py::_table_decode``.
One query token per row attends over its ring of logical pages, mapped by a
(B, T) page table into one shared pool; pages past the row's live span are
never read. Plain version: ``ref.paged_decode_ref``.

``paged_decode_int8`` is the TPU kernel's ``k_scale``/``v_scale`` branch:
int8 pools with f32 scales (P, page, Hkv), dequantized in the kernel to q's
dtype. Plain version: ``ref.paged_decode_int8_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)


def _check(name, q, k_pool, v_pool, k_scale, v_scale, pos, table):
    scales = {} if k_scale is None else dict(k_scale=k_scale, v_scale=v_scale)
    build.check_cuda(name, q=q, k_pool=k_pool, v_pool=v_pool, pos=pos, table=table, **scales)
    b, hkv, g, hd = q.shape
    p, page = k_pool.shape[:2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if k_pool.shape != (p, page, hkv, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    build.check_pool(name, q, k_pool, v_pool, k_scale, v_scale)
    if pos.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError(f"{name}: pos and table must be int32")
    if pos.shape != (b,) or table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"{name}: pos {tuple(pos.shape)} / table "
                         f"{tuple(table.shape)} do not match batch {b}")
    return b, hkv, g, hd, page


def paged_decode(
    q: torch.Tensor,       # (B, Hkv, G, hd)
    k_pool: torch.Tensor,  # (P, page, Hkv, hd)
    v_pool: torch.Tensor,
    pos: torch.Tensor,     # (B,) int32
    table: torch.Tensor,   # (B, T) int32
    window: int = 0,
) -> torch.Tensor:
    b, hkv, g, hd, page = _check("paged_decode", q, k_pool, v_pool, None, None, pos, table)
    out = torch.empty_like(q)
    build.launch(
        "paged_decode", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos.data_ptr(), table.data_ptr(), out.data_ptr(), build.dtype_code(q),
        b, hkv, g, hd, page, table.shape[1], window, hd**-0.5,
    )
    return out


def paged_decode_int8(
    q: torch.Tensor,        # (B, Hkv, G, hd) float32 / bfloat16
    k_pool: torch.Tensor,   # (P, page, Hkv, hd) int8
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (P, page, Hkv) float32
    v_scale: torch.Tensor,
    pos: torch.Tensor,      # (B,) int32
    table: torch.Tensor,    # (B, T) int32
    window: int = 0,
) -> torch.Tensor:
    b, hkv, g, hd, page = _check("paged_decode_int8", q, k_pool, v_pool, k_scale, v_scale,
                                 pos, table)
    out = torch.empty_like(q)
    build.launch(
        "paged_decode_int8", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), table.data_ptr(),
        out.data_ptr(), build.dtype_code(q), b, hkv, g, hd, page, table.shape[1], window,
        hd**-0.5,
    )
    return out
