"""GQA attention of the serving path: cold prefill, suffix prefill over a
cached prefix, and decode over the shared paged KV pool.

Keys are stored rotated (RoPE at write time), so a read needs no position
bookkeeping beyond the validity mask. The pool is one (P, page, Hkv, hd)
tensor per layer shared by every slot, with page 0 reserved as scratch; a
slot's (T,) table row maps its logical ring pages into it (capacity
T·page). Where the reference donated the pool through ``jit``, the port
writes it in place."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_pages_ref
from repro_torch.models.layers import apply_rope


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _queries(params: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Rotated queries grouped by kv head: (B, S, Hkv, G, hd)."""
    hd = cfg.resolved_head_dim
    q = apply_rope(_split_heads(x @ params["wq"], cfg.n_heads, hd), positions, cfg.rope_theta)
    return q.reshape(*x.shape[:2], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, hd)


def compute_kv_for_prefill(
    params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Head-split, rotated (k, v) of a prompt: (B, S, Hkv, hd) each."""
    hd = cfg.resolved_head_dim
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, hd)
    return apply_rope(k, positions, cfg.rope_theta), v


def attend_full(
    params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, *,
    window: int = 0, kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Causal self-attention of a prompt at dense positions 0..S-1 (cold
    prefill) through the flash-prefill kernel. x: (B, S, D). ``kv`` passes
    this prompt's own (k, v) when the caller already computed them with
    ``compute_kv_for_prefill`` for the cache write."""
    b, s, _ = x.shape
    k, v = kv if kv is not None else compute_kv_for_prefill(params, x, positions, cfg)
    out = ops.flash_prefill_attention(_queries(params, x, positions, cfg), k, v, window=window)
    return out.reshape(b, s, -1) @ params["wo"]


def attend_suffix(
    params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, *,
    kv: tuple[torch.Tensor, torch.Tensor], pool_k: torch.Tensor, pool_v: torch.Tensor,
    table_rows: torch.Tensor, starts: torch.Tensor, prefix_width: int,
) -> torch.Tensor:
    """Suffix prefill: row r's tokens sit at absolute positions
    starts[r] + i and attend over the first starts[r] cached tokens of its
    pages (through ``table_rows``) and, causally, over themselves."""
    n, s, _ = x.shape
    out = ops.suffix_prefill_attention(
        _queries(params, x, positions, cfg), kv[0], kv[1], pool_k, pool_v,
        table_rows, starts, prefix_width=prefix_width,
    )
    return out.reshape(n, s, -1) @ params["wo"]


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool (P, page, Hkv, hd) × table (B, T) → contiguous (B, T·page, Hkv,
    hd) ring rows."""
    return gather_pages_ref(pool, table)


def fill_pages_rows(
    pool_k: torch.Tensor, pool_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    table_rows: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
) -> None:
    """Per-row paged ring write, in place: row r's first lengths[r] tokens
    of k/v (n, S, Hkv, hd) land at logical ring slots (starts[r] + j) mod
    T·page of its table row — the state lengths[r] sequential one-token
    writes leave. Only those slots are touched: no other lane of a page
    (shared prefix lanes included) is rewritten, and no two writes hit one
    slot (a row longer than its ring keeps only its last T·page tokens)."""
    s = k.shape[1]
    page = pool_k.shape[1]
    cap = table_rows.shape[1] * page
    j = torch.arange(s, device=k.device)[None, :]
    lengths = lengths.long()[:, None]
    live = (j < lengths) & (j >= lengths - cap)
    slot = (starts.long()[:, None] + j) % cap
    phys = table_rows.long().gather(1, slot // page)[live]
    off = (slot % page)[live]
    pool_k[phys, off] = k[live]
    pool_v[phys, off] = v[live]


def decode_attend_paged(
    params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig, *, window: int = 0,
) -> torch.Tensor:
    """One decode step over one layer of the shared pool. x: (B, 1, D);
    cache: {"k"/"v": (P, page, Hkv, hd), "pos": (B,), "table": (B, T)}.
    Row b's token is written first, at logical ring slot pos[b] mod T·page
    through its table (in place), then attends over its ring. Live slots own
    their pages, so rows never collide except on scratch page 0, which no
    live read dereferences."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pool_k, pool_v, pos, table = cache["k"], cache["v"], cache["pos"], cache["table"]
    page = pool_k.shape[1]
    cap = table.shape[1] * page
    q = _queries(params, x, pos[:, None], cfg)                     # (B, 1, Hkv, G, hd)
    k, v = compute_kv_for_prefill(params, x, pos[:, None], cfg)    # (B, 1, Hkv, hd)
    slot = pos.long() % cap
    phys = table.long().gather(1, (slot // page)[:, None])[:, 0]
    off = slot % page
    pool_k[phys, off] = k[:, 0]
    pool_v[phys, off] = v[:, 0]
    out = ops.paged_decode_attention(q[:, 0], pool_k, pool_v, pos, table, window)
    return out.reshape(b, 1, cfg.n_heads * hd) @ params["wo"]
