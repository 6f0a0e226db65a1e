"""Plain PyTorch versions of the port's kernels.

One function per hand-written kernel: the attention kernels of the serving
path (over fp and int8 pools, and over per-row contiguous rings), the int8
row quantizer of the pool writes, and the channel kernels of the federated
uplink. Each computes the kernel's function the straightforward way, in
fp32, and casts to q's dtype, as the reference package's oracles
(``repro/kernels/ref.py``) do. They are what a wrapper runs for a CPU
tensor, and what the kernels are held against on the card."""
from __future__ import annotations

import torch

NEG = -(2.0**30)
FAR = 2**30  # unreachable key position: masked by every causal comparison


def gather_pages_ref(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool (P, page, Hkv, hd) × table (B, T) → contiguous (B, T·page, Hkv,
    hd) ring rows: logical slot c of row b is pool[table[b, c // page],
    c % page]."""
    b, t_w = table.shape
    page, hkv, hd = pool.shape[1:]
    return pool[table.long()].reshape(b, t_w * page, hkv, hd)


def _attend(q, k, v, mask, scale=None):
    """q (B, Sq, Hkv, G, hd), k/v (B, Sk, Hkv, hd), mask broadcastable to
    (B, Hkv, G, Sq, Sk) → (B, Sq, Hkv, G, hd) in q's dtype; fp32 softmax.
    ``scale`` multiplies the scores (None: hd**-0.5 of the operands; a
    model whose head dim the kernels take padded passes its own)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.to(q.dtype)


def _ring_valid(pos: torch.Tensor, cap: int, window: int) -> torch.Tensor:
    """(B, C) ring-validity mask: slot s of a ring of capacity C holds global
    position pos - ((pos mod C) - s) mod C, valid iff it lies in
    [max(pos - window + 1, 0), pos] (window 0: every cached position)."""
    slot = pos % cap
    slots = torch.arange(cap, device=pos.device)
    gpos = pos[:, None] - (slot[:, None] - slots[None, :]) % cap
    lo = (pos - (window - 1)).clamp(min=0) if window > 0 else torch.zeros_like(pos)
    return (gpos >= lo[:, None]) & (gpos <= pos[:, None])


def _row_pos(pos, b: int, device) -> torch.Tensor:
    """``pos`` () (a lockstep batch) or (B,) (per-slot positions) as (B,)
    int64."""
    return torch.as_tensor(pos, device=device).long().reshape(-1).expand(b)


def swa_decode_ref(
    q: torch.Tensor,  # (B, Hkv, G, hd)
    k: torch.Tensor,  # (B, C, Hkv, hd) — per-row contiguous rings (rotated keys)
    v: torch.Tensor,
    pos,              # () or (B,) — tokens already cached per row
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """One query per row over its ring's slots whose reconstructed global
    position lies in [max(pos-window+1, 0), pos]. Mirrors
    ``swa_decode_ref``."""
    pos = _row_pos(pos, k.shape[0], q.device)
    valid = _ring_valid(pos, k.shape[1], window)                      # (B, C)
    return _attend(q[:, None], k, v, valid[:, None, None, None, :], scale)[:, 0]


def ring_paged_decode_ref(q, k, v, pos, window: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """``swa_decode_ref`` with the live-span mask ``slot < min(pos + 1, C)``
    intersected in: slots past the live span are already invalid under the
    ring mask, so the output is bitwise ``swa_decode_ref``'s. The plain
    version of the kernel that skips dead pages. Mirrors the reference's
    contiguous ``paged_decode_ref``."""
    b, cap = k.shape[:2]
    pos = _row_pos(pos, b, q.device)
    valid = _ring_valid(pos, cap, window)
    valid &= torch.arange(cap, device=q.device)[None, :] < (pos + 1).clamp(max=cap)[:, None]
    return _attend(q[:, None], k, v, valid[:, None, None, None, :], scale)[:, 0]


def paged_decode_ref(
    q: torch.Tensor,       # (B, Hkv, G, hd)
    k_pool: torch.Tensor,  # (P, page, Hkv, hd)
    v_pool: torch.Tensor,
    pos: torch.Tensor,     # (B,) int32 — tokens already cached per row
    table: torch.Tensor,   # (B, T) int32
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Page-table decode: gather each row's pages into a contiguous ring of
    capacity C = T·page, then ``swa_decode_ref``. Mirrors the reference's
    ``paged_table_decode_ref`` (the port's ``ring_paged_decode_ref`` is the
    reference's contiguous ``paged_decode_ref``)."""
    return swa_decode_ref(q, gather_pages_ref(k_pool, table), gather_pages_ref(v_pool, table),
                          pos, window, scale)


def flash_prefill_ref(
    q: torch.Tensor,  # (B, S, Hkv, G, hd)
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """GQA attention over dense positions 0..S-1 / 0..T-1: causal with an
    optional sliding window, or (``causal=False``) full softmax over all T
    keys, S and T free (an encoder's self-attention, cross-attention).
    Mirrors ``flash_prefill_ref``."""
    s, t = q.shape[1], k.shape[1]
    if not causal:
        return _attend(q, k, v, torch.ones((s, t), dtype=torch.bool, device=q.device), scale)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return _attend(q, k, v, mask, scale)


def suffix_prefill_ref(
    q: torch.Tensor,       # (n, S, Hkv, G, hd) — roped at starts[r] + i
    k_suf: torch.Tensor,   # (n, S, Hkv, hd)
    v_suf: torch.Tensor,
    pool_k: torch.Tensor,  # (P, page, Hkv, hd)
    pool_v: torch.Tensor,
    table: torch.Tensor,   # (n, T) int32 — row-gathered page table
    starts: torch.Tensor,  # (n,) int32 — cached prefix tokens per row
    *,
    prefix_width: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Gather-concat suffix prefill: the first ``prefix_width`` table pages
    of each row become prefix lanes (lanes at or after starts[r] pushed to
    an unreachable position), the suffix k/v follow, and one causal softmax
    runs at absolute query positions starts[r] + i. Mirrors
    ``suffix_prefill_ref``."""
    n, s = q.shape[:2]
    page = pool_k.shape[1]
    w = min(prefix_width, table.shape[1])
    starts = starts.long()
    gk = gather_pages_ref(pool_k, table[:, :w])
    gv = gather_pages_ref(pool_v, table[:, :w])
    ring = torch.arange(w * page, device=q.device)[None, :]
    prefix_pos = torch.where(ring < starts[:, None], ring, torch.full_like(ring, FAR))
    qpos = starts[:, None] + torch.arange(s, device=q.device)[None, :]
    k = torch.cat([gk, k_suf], dim=1)
    v = torch.cat([gv, v_suf], dim=1)
    kv_pos = torch.cat([prefix_pos, qpos], dim=1)
    mask = qpos[:, None, None, :, None] >= kv_pos[:, None, None, None, :]
    return _attend(q, k, v, mask, scale)


# ------------------------------------------------------------- int8 KV pages
EPS = 1e-12


def kv_quant_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis: (..., d) → (q int8 (..., d),
    scale f32 (...)); scale = max(max|x| / 127, 1e-12), q = clip(round(x /
    scale), ±127), rounding half to even. Mirrors ``quantize.kv_quant``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = (amax / amax.new_full((), 127.0)).clamp(min=EPS)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def kv_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``kv_quant_ref``: q·scale in f32, then cast to ``dtype``.
    Mirrors ``quantize.kv_dequant``."""
    return (q.float() * scale[..., None]).to(dtype)


def int8_encode_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of (rows, R) rows of any length R → (q int8
    (rows, R), scale f32 (rows,)). Mirrors ``int8_encode_ref`` (whose scale
    keeps a trailing axis of 1)."""
    return kv_quant_ref(x)


def page_slots(table_rows: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor | None,
               s: int, page: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where a paged ring write of S tokens per row lands: (live (n, S)
    bool, phys (n, S), off (n, S)) for every token, live or not. Row r's
    token j is live iff j < lengths[r] and j >= lengths[r] − T·page (a row
    longer than its ring keeps its last T·page tokens, so no two live tokens
    share a slot; ``lengths`` None: one token per row) and goes to logical
    ring slot (starts[r] + j) mod T·page of ``table_rows`` (n, T). No host
    read: a CUDA graph can hold it."""
    cap = table_rows.shape[1] * page
    j = torch.arange(s, device=starts.device)[None, :]
    if lengths is None:
        live = (j < 1).expand(starts.shape[0], s)
    else:
        n_tok = lengths.long()[:, None]
        live = (j < n_tok) & (j >= n_tok - cap)
    slot = (starts.long()[:, None] + j) % cap
    return live, table_rows.long().gather(1, slot // page), slot % page


def live_slots(table_rows: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor | None,
               s: int, page: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``page_slots`` with phys and off of the live tokens only, in
    row-major order (a boolean mask: the host waits for its count)."""
    live, phys, off = page_slots(table_rows, starts, lengths, s, page)
    return live, phys[live], off[live]


def kv_write_int8_ref(pool: dict, k: torch.Tensor, v: torch.Tensor, table_rows: torch.Tensor,
                      starts: torch.Tensor, lengths: torch.Tensor | None = None) -> None:
    """The int8 pool's write, in place: row r's live tokens of k/v (n, S,
    Hkv, hd) (``live_slots``) quantized per kv head (``kv_quant_ref``) into
    ``pool["k"]``/``["v"]`` (P, page, Hkv, hd) and ``["ks"]``/``["vs"]``
    (P, page, Hkv) at their slots; ``lengths`` None: one token per row (a
    decode step, ``starts`` = pos). Only live slots are touched, so shared
    prefix lanes keep their bits: the pool the reference's decode write and
    its masked requantized prefill write leave (scratch page 0 aside, where
    dead rows may collide)."""
    live, phys, off = live_slots(table_rows, starts, lengths, k.shape[1], pool["k"].shape[1])
    for plane, scales, x in (("k", "ks", k), ("v", "vs", v)):
        q, scale = kv_quant_ref(x[live])
        pool[plane][phys, off] = q
        pool[scales][phys, off] = scale


def dequant_pool_ref(pool_q: torch.Tensor, scales: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An int8 page pool (P, page, Hkv, hd) with its (P, page, Hkv) scales
    as the fp pool the int8 kernels read. Mirrors ``dequant_pool_ref``."""
    return kv_dequant_ref(pool_q, scales, dtype)


def paged_decode_int8_ref(q, k_pool, v_pool, k_scale, v_scale, pos, table, window=0,
                          scale=None):
    """int8-pool page-table decode: the pool dequantized to q's dtype, then
    ``paged_decode_ref``. Mirrors ``paged_table_decode_int8_ref``."""
    return paged_decode_ref(q, dequant_pool_ref(k_pool, k_scale, q.dtype),
                            dequant_pool_ref(v_pool, v_scale, q.dtype), pos, table, window,
                            scale)


def suffix_prefill_int8_ref(q, k_suf, v_suf, pool_k, pool_v, k_scale, v_scale, table,
                            starts, *, prefix_width, scale=None):
    """int8-pool suffix prefill: the prefix pool dequantized to q's dtype,
    the suffix's own k/v as given, then ``suffix_prefill_ref``. Mirrors
    ``suffix_prefill_int8_ref``."""
    return suffix_prefill_ref(q, k_suf, v_suf, dequant_pool_ref(pool_k, k_scale, q.dtype),
                              dequant_pool_ref(pool_v, v_scale, q.dtype), table, starts,
                              prefix_width=prefix_width, scale=scale)


# ------------------------------------------------- federated uplink channel
BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x as fp32 (nb, 256) rows of its flat elements, the ragged last row
    zero-padded."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def _unblocks(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return rows.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


def topk_sparsify_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per 256-element block of the flat tensor, keep |x| >= the k-th
    largest magnitude (ties kept), zero the rest. Mirrors
    ``topk_sparsify_ref`` on (nb, 256) rows."""
    rows = _blocks(x)
    mag = rows.abs()
    kth = torch.topk(mag, k, dim=1).values[:, -1:]
    return _unblocks(torch.where(mag >= kth, rows, torch.zeros_like(rows)), x)


def int8_roundtrip_ref(x: torch.Tensor) -> torch.Tensor:
    """Per 256-element block symmetric int8 quantize→dequantize. Mirrors
    ``int8_roundtrip_ref``."""
    rows = _blocks(x)
    amax = rows.abs().amax(dim=1, keepdim=True)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = (amax / amax.new_tensor(127.0)).clamp(min=1e-12)
    q = torch.round(rows / scale).clamp(-127, 127)
    return _unblocks(q * scale, x)


def sq_norm_ref(x: torch.Tensor) -> torch.Tensor:
    """Σ x² over everything → () fp32. Mirrors ``sq_norm_ref``."""
    return x.float().square().sum()


def clip_noise_ref(
    x: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor | None = None,
    stddev: float = 0.0,
) -> torch.Tensor:
    """x·scale + stddev·noise in fp32, cast to x's dtype (the fused DP
    transmit transform); without noise, x·scale. Mirrors
    ``clip_noise_ref``."""
    y = x.float() * scale
    if noise is not None:
        y = y + stddev * noise
    return y.to(x.dtype)
