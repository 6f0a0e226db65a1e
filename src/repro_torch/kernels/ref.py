"""Plain PyTorch versions of the port's attention kernels.

One function per hand-written kernel on the serving path. Each computes the
kernel's function the straightforward way, in fp32, and casts to q's dtype,
as the reference package's oracles (``repro/kernels/ref.py``) do. They are
what a wrapper runs for a CPU tensor, and what the kernels are held against
on the card."""
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


def _attend(q, k, v, mask):
    """q (B, Sq, Hkv, G, hd), k/v (B, Sk, Hkv, hd), mask broadcastable to
    (B, Hkv, G, Sq, Sk) → (B, Sq, Hkv, G, hd) in q's dtype; fp32 softmax."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * (hd**-0.5)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.to(q.dtype)


def paged_decode_ref(
    q: torch.Tensor,       # (B, Hkv, G, hd)
    k_pool: torch.Tensor,  # (P, page, Hkv, hd)
    v_pool: torch.Tensor,
    pos: torch.Tensor,     # (B,) int32 — tokens already cached per row
    table: torch.Tensor,   # (B, T) int32
    window: int = 0,
) -> torch.Tensor:
    """Page-table decode: gather each row's pages into a contiguous ring of
    capacity C = T·page and attend one query per row over the ring slots
    whose reconstructed global position lies in [max(pos-window+1, 0), pos].
    Mirrors ``paged_table_decode_ref`` / ``swa_decode_ref``."""
    k = gather_pages_ref(k_pool, table)
    v = gather_pages_ref(v_pool, table)
    cap = k.shape[1]
    pos = pos.long()
    slot = pos % cap
    slots = torch.arange(cap, device=q.device)
    gpos = pos[:, None] - (slot[:, None] - slots[None, :]) % cap
    lo = (pos - (window - 1)).clamp(min=0) if window > 0 else torch.zeros_like(pos)
    valid = (gpos >= lo[:, None]) & (gpos <= pos[:, None])          # (B, C)
    out = _attend(q[:, None], k, v, valid[:, None, None, None, :])
    return out[:, 0]


def flash_prefill_ref(
    q: torch.Tensor,  # (B, S, Hkv, G, hd)
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Causal GQA attention over dense positions 0..S-1 / 0..T-1, optional
    sliding window. Mirrors ``flash_prefill_ref`` (causal=True)."""
    s, t = q.shape[1], k.shape[1]
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return _attend(q, k, v, mask)


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
    return _attend(q, k, v, mask)
