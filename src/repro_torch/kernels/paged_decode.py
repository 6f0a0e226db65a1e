"""Paged decode attention on the card: wrapper of ``csrc/paged_decode.cu``.

Replaces the TPU kernel ``repro/kernels/paged_decode.py::_table_decode``.
One query token per row attends over its ring of logical pages, mapped by a
(B, T) page table into one shared pool; pages past the row's live span are
never read. Plain version: ``ref.paged_decode_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)


def paged_decode(
    q: torch.Tensor,       # (B, Hkv, G, hd)
    k_pool: torch.Tensor,  # (P, page, Hkv, hd)
    v_pool: torch.Tensor,
    pos: torch.Tensor,     # (B,) int32
    table: torch.Tensor,   # (B, T) int32
    window: int = 0,
) -> torch.Tensor:
    build.check_cuda("paged_decode", q=q, k_pool=k_pool, v_pool=v_pool, pos=pos, table=table)
    b, hkv, g, hd = q.shape
    p, page = k_pool.shape[:2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head dim {hd} not in {HEAD_DIMS}")
    if k_pool.shape != (p, page, hkv, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_decode: pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_decode: q and the pools must share one dtype")
    if pos.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError("paged_decode: pos and table must be int32")
    if pos.shape != (b,) or table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"paged_decode: pos {tuple(pos.shape)} / table "
                         f"{tuple(table.shape)} do not match batch {b}")
    out = torch.empty_like(q)
    build.launch(
        "paged_decode", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos.data_ptr(), table.data_ptr(), out.data_ptr(), build.dtype_code(q),
        b, hkv, g, hd, page, table.shape[1], window, hd**-0.5,
    )
    return out
