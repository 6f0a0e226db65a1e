"""Dispatch of the port's kernels by device.

A CUDA tensor goes to the hand-written kernel (which raises on what it
cannot take); a CPU tensor goes to the plain PyTorch version. There is no
other route: nothing here falls back from the kernel to the plain version.
``LAUNCHES`` counts kernel launches per entry point."""
from __future__ import annotations

import torch

from repro_torch.kernels import dp_clip, quantize, ref, topk_compress
from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.flash_suffix_prefill import suffix_prefill
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.utils.tree import tree_leaves


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


# ------------------------------------------------- federated uplink channel
# Each leaf is handed to its kernel as one flat contiguous fp32 (or, for the
# norm and the clip, bf16) tensor; the kernels handle the ragged last
# 256-element block themselves, so no padded copy is made. The reference's
# ``ops._to_tiles`` padding to 2048-element tiles is TPU layout only: the
# padded rows are zeros and are sliced off, so the results are the same.
BLOCK = 256


def topk_k(ratio: float) -> int:
    """Entries kept per 256-element block at keep-ratio ``ratio``."""
    return max(1, int(round(ratio * BLOCK)))


def topk_sparsify_leaf(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """Block-local magnitude top-k of one leaf, in fp32, cast back to x's
    dtype."""
    k = topk_k(ratio)
    xf = x.float().contiguous()
    out = (topk_compress.topk_sparsify(xf, k) if xf.is_cuda
           else ref.topk_sparsify_ref(xf, k))
    return out.to(x.dtype)


def int8_roundtrip_leaf(x: torch.Tensor) -> torch.Tensor:
    """Per-block int8 quantize→dequantize of one leaf, in fp32, cast back
    to x's dtype."""
    xf = x.float().contiguous()
    out = quantize.int8_roundtrip(xf) if xf.is_cuda else ref.int8_roundtrip_ref(xf)
    return out.to(x.dtype)


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Σx² of one tensor (fp32 or bf16) → () fp32 on its device."""
    x = x.contiguous()
    return dp_clip.sq_norm(x) if x.is_cuda else ref.sq_norm_ref(x)


def tree_sq_norm(leaves) -> torch.Tensor:
    """Σx² over a tree's leaves (a dict tree, or any iterable of tensors, in
    its order; a generator lets the caller make each leaf only when it is
    read), added leaf by leaf in fp32 as the reference does."""
    if isinstance(leaves, (dict, torch.Tensor)):
        leaves = tree_leaves(leaves)
    total = None
    for leaf in leaves:
        s = sq_norm(leaf)
        total = s if total is None else total + s
    return total


def clip_noise(x: torch.Tensor, scale, noise: torch.Tensor | None = None,
               stddev: float = 0.0) -> torch.Tensor:
    """x·scale + stddev·noise in fp32, cast to x's dtype. ``scale`` is a ()
    fp32 tensor (or a float); without ``noise`` this is the clip alone."""
    x = x.contiguous()
    if not torch.is_tensor(scale):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    if x.is_cuda:
        return dp_clip.clip_noise(x, scale, noise, stddev)
    return ref.clip_noise_ref(x, scale, noise, stddev)
