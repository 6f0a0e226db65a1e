"""Dispatch of the port's kernels by device.

A CUDA tensor goes to the hand-written kernel (which raises on what it
cannot take); a CPU tensor goes to the plain PyTorch version. There is no
other route: nothing here falls back from the kernel to the plain version.
Under ``utils/cost.count_step`` each entry point counts as one unit
(``kernel_unit``): its plain version's dot FLOPs and its own bytes.
``LAUNCHES`` counts kernel launches per entry point. The attention entry
points take the softmax ``scale`` (None: hd**-0.5 of the operands' head
dim): a model whose head dim the kernels take only padded
(``paged_decode.kernel_head_dim``) passes its own."""
from __future__ import annotations

import torch

from repro_torch.kernels import dp_clip, quantize, ref, topk_compress
from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.flash_suffix_prefill import suffix_prefill, suffix_prefill_int8
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_int8, paged_decode_ring
from repro_torch.kernels.swa_decode import swa_decode
from repro_torch.utils.cost import kernel_unit
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def _kernel_layout(out: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A plain version's result in the layout its kernel writes
    (``empty_like(q)``), so that what the caller does next (a reshape that
    views or copies) is the same on the CPU and on the card."""
    return torch.empty_like(q).copy_(out)


@kernel_unit
def paged_decode_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    pos: torch.Tensor, table: torch.Tensor, window: int = 0,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, Hkv, G, hd) queries over the shared pool (P, page, Hkv, hd)
    through the (B, T) page table → (B, Hkv, G, hd). With ``k_scale``/
    ``v_scale`` (P, page, Hkv) f32 the pools are int8, dequantized in the
    kernel to q's dtype."""
    if k_scale is not None:
        if q.is_cuda:
            return paged_decode_int8(q, k_pool, v_pool, k_scale, v_scale, pos, table, window,
                                     scale)
        return ref.paged_decode_int8_ref(q, k_pool, v_pool, k_scale, v_scale, pos, table,
                                         window, scale)
    if q.is_cuda:
        return paged_decode(q, k_pool, v_pool, pos, table, window, scale)
    return ref.paged_decode_ref(q, k_pool, v_pool, pos, table, window, scale)


@kernel_unit
def swa_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, window: int = 0, *,
    paged: bool, scale: float | None = None,
) -> torch.Tensor:
    """(B, Hkv, G, hd) queries over per-row contiguous rings (B, C, Hkv, hd)
    → (B, Hkv, G, hd). ``pos`` is () for a lockstep batch or (B,) for
    per-slot positions; it is broadcast to a (B,) int32 tensor on q's device
    (no host read). ``paged`` selects the kernel that skips each row's dead
    pages (``paged_decode_ring``) over the one that streams the whole ring
    (``swa_decode``): bitwise the same output."""
    b = q.shape[0]
    if torch.is_tensor(pos):
        pos = pos.to(device=q.device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    else:
        pos = torch.full((b,), int(pos), dtype=torch.int32, device=q.device)
    if q.is_cuda:
        return (paged_decode_ring if paged else swa_decode)(q, k, v, pos, window, scale=scale)
    return (ref.ring_paged_decode_ref if paged else ref.swa_decode_ref)(q, k, v, pos, window,
                                                                        scale)


@kernel_unit
def flash_prefill_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int = 0, scale: float | None = None,
) -> torch.Tensor:
    """GQA attention, causal (optional window) or, with ``causal=False``,
    over every key. q (B, S, Hkv, G, hd); k/v (B, T, Hkv, hd)."""
    if q.is_cuda:
        return flash_prefill(q, k, v, causal=causal, window=window, scale=scale)
    if not causal and window:
        raise ValueError("flash_prefill: a window needs causal attention")
    return _kernel_layout(
        ref.flash_prefill_ref(q, k, v, causal=causal, window=window, scale=scale), q)


@kernel_unit
def suffix_prefill_attention(
    q: torch.Tensor, k_suf: torch.Tensor, v_suf: torch.Tensor,
    pool_k: torch.Tensor, pool_v: torch.Tensor, table: torch.Tensor,
    starts: torch.Tensor, *, prefix_width: int,
    pool_k_scale: torch.Tensor | None = None, pool_v_scale: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Suffix prefill over a cached prefix in the shared pool. q
    (n, S, Hkv, G, hd) roped at starts[r] + i; table (n, T); starts (n,).
    With ``pool_k_scale``/``pool_v_scale`` the pools are int8 (the suffix's
    own k/v stay in q's dtype)."""
    if pool_k_scale is not None:
        args = (q, k_suf, v_suf, pool_k, pool_v, pool_k_scale, pool_v_scale, table, starts)
        if q.is_cuda:
            return suffix_prefill_int8(*args, prefix_width=prefix_width, scale=scale)
        return _kernel_layout(
            ref.suffix_prefill_int8_ref(*args, prefix_width=prefix_width, scale=scale), q)
    if q.is_cuda:
        return suffix_prefill(
            q, k_suf, v_suf, pool_k, pool_v, table, starts, prefix_width=prefix_width,
            scale=scale,
        )
    return _kernel_layout(ref.suffix_prefill_ref(
        q, k_suf, v_suf, pool_k, pool_v, table, starts, prefix_width=prefix_width,
        scale=scale,
    ), q)


def _kv_write_bytes(pool: dict, k: torch.Tensor, *args, **kwargs) -> float:
    """What the int8 pool write stores in place, for k and v: one byte an
    element and one fp32 scale a head vector."""
    return 2 * k.numel() * (1 + 4 / k.shape[-1])


@kernel_unit(inplace_bytes=_kv_write_bytes)
def kv_write_int8(pool: dict, k: torch.Tensor, v: torch.Tensor, table_rows: torch.Tensor,
                  starts: torch.Tensor, lengths: torch.Tensor | None = None) -> None:
    """One layer's int8 pool write, in place: the live tokens of k/v (n, S,
    Hkv, hd) quantized per kv head into their ring slots (starts[r] + j) mod
    T·page through ``table_rows`` (``lengths`` None: one token per row, a
    decode step). One ``kv_write_int8`` launch on the card."""
    if k.is_cuda:
        quantize.kv_write_int8(pool, k, v, table_rows, starts, lengths)
    else:
        ref.kv_write_int8_ref(pool, k, v, table_rows, starts, lengths)


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


@kernel_unit
def topk_sparsify_leaf(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """Block-local magnitude top-k of one leaf, in fp32, cast back to x's
    dtype."""
    k = topk_k(ratio)
    xf = x.float().contiguous()
    out = (topk_compress.topk_sparsify(xf, k) if xf.is_cuda
           else ref.topk_sparsify_ref(xf, k))
    return out.to(x.dtype)


@kernel_unit
def int8_roundtrip_leaf(x: torch.Tensor) -> torch.Tensor:
    """Per-block int8 quantize→dequantize of one leaf, in fp32, cast back
    to x's dtype."""
    xf = x.float().contiguous()
    out = quantize.int8_roundtrip(xf) if xf.is_cuda else ref.int8_roundtrip_ref(xf)
    return out.to(x.dtype)


@kernel_unit
def int8_encode_leaf(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The int8 wire form of one leaf: (q int8 (nb, 256), scale f32 (nb,),
    n) over its flat elements in 256-element rows, the ragged last row
    zero-padded. The reference's ``ops.int8_encode_leaf`` pads the rows to a
    multiple of 8 (TPU tiling) and keeps the scale as (nb, 1); its first nb
    rows are these."""
    xf = x.contiguous()
    if xf.is_cuda:
        q, scale = quantize.int8_encode(xf)
    else:
        q, scale = ref.int8_encode_ref(ref._blocks(xf))
    return q, scale, x.numel()


@kernel_unit
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


@kernel_unit
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


def dp_transmit(tree, generator: torch.Generator, clip_norm: float, stddev: float):
    """The fused DP channel of a tree (the reference's ``ops.dp_transmit``):
    clip it to global norm ``clip_norm`` and add N(0, stddev²) per element.
    The global Σx² goes through the ``sq_norm`` kernel leaf by leaf
    (``tree_sq_norm``), the scale is min(1, clip_norm / max(‖x‖, 1e-9)) as
    the reference's, and each leaf's noise is drawn N(0, 1) in fp32 from
    ``generator`` (on the leaves' device, in leaf order, also at stddev 0,
    so that the stream does not depend on stddev) before the
    ``clip_noise`` kernel scales and adds it. Kernels on the card, plain
    versions on the CPU."""
    leaves = tree_leaves(tree)
    norm = torch.sqrt(tree_sq_norm(leaves))
    # a tensor numerator: ``float / tensor`` is a reciprocal times the float
    scale = torch.clamp(norm.new_tensor(clip_norm) / torch.clamp(norm, min=1e-9), max=1.0)
    out = []
    for leaf in leaves:
        noise = torch.randn(leaf.shape, generator=generator, dtype=torch.float32,
                            device=leaf.device)
        out.append(clip_noise(leaf, scale, noise, stddev))
    return tree_unflatten(tree, out)
