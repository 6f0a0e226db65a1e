"""Dispatch of the port's attention kernels by device.

A CUDA tensor goes to the hand-written kernel (which raises on what it
cannot take); a CPU tensor goes to the plain PyTorch version. There is no
other route: nothing here falls back from the kernel to the plain version.
``LAUNCHES`` counts kernel launches per entry point."""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.flash_suffix_prefill import suffix_prefill
from repro_torch.kernels.paged_decode import paged_decode


def paged_decode_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    pos: torch.Tensor, table: torch.Tensor, window: int = 0,
) -> torch.Tensor:
    """(B, Hkv, G, hd) queries over the shared pool (P, page, Hkv, hd)
    through the (B, T) page table → (B, Hkv, G, hd)."""
    if q.is_cuda:
        return paged_decode(q, k_pool, v_pool, pos, table, window)
    return ref.paged_decode_ref(q, k_pool, v_pool, pos, table, window)


def flash_prefill_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
) -> torch.Tensor:
    """Causal GQA attention. q (B, S, Hkv, G, hd); k/v (B, T, Hkv, hd)."""
    if q.is_cuda:
        return flash_prefill(q, k, v, window=window)
    return ref.flash_prefill_ref(q, k, v, window=window)


def suffix_prefill_attention(
    q: torch.Tensor, k_suf: torch.Tensor, v_suf: torch.Tensor,
    pool_k: torch.Tensor, pool_v: torch.Tensor, table: torch.Tensor,
    starts: torch.Tensor, *, prefix_width: int,
) -> torch.Tensor:
    """Suffix prefill over a cached prefix in the shared pool. q
    (n, S, Hkv, G, hd) roped at starts[r] + i; table (n, T); starts (n,)."""
    if q.is_cuda:
        return suffix_prefill(
            q, k_suf, v_suf, pool_k, pool_v, table, starts, prefix_width=prefix_width,
        )
    return ref.suffix_prefill_ref(
        q, k_suf, v_suf, pool_k, pool_v, table, starts, prefix_width=prefix_width,
    )
