"""GQA attention: the training forward, and the serving path's cold
prefill, suffix prefill over a cached prefix, and decode over the shared
paged KV pool or over per-row contiguous ring caches.

Keys are stored rotated (RoPE at write time), so a read needs no position
bookkeeping beyond the validity mask. A ring cache is (B, C, Hkv, hd) per
layer with C = the window when 0 < window < max_seq, else max_seq; slot
pos mod C holds the token at position pos, and ``pos`` is () (a lockstep
batch) or (B,) (per-slot positions). The pool is one (P, page, Hkv, hd)
tensor per layer shared by every slot, with page 0 reserved as scratch; a
slot's (T,) table row maps its logical ring pages into it (capacity
T·page). Where the reference donated the pool through ``jit``, the port
writes it in place. An int8 pool adds one f32 scale plane per k and v
(``ks``/``vs``, (P, page, Hkv)): every write quantizes its rows and stores
them in their slots in one launch per layer (``ops.kv_write_int8``), every
read dequantizes to the model dtype in the kernel.

The serving paths (``prefill_attend``, ``prefill_slot_attend``,
``decode_attend_paged``, ``decode_attend``) are tensor-parallel under an active tensor axis
(``models/sharding.py``): the projections, rope, the cache write and the
attention kernel run per shard on its head slice (``map_shards``), then
``gather_heads`` joins the slices and the replicated ``wo`` runs once.

The caches and the kernels hold k/v at ``kernel_head_dim(hd)``: the model's
head dim, or 32 for a head dim of 30 (phi4-mini's smoke config), whose rows
the kernels' 16-byte loads cannot read. There q, k and v are rotated at 30,
zero-filled to 32 on every device (the plain versions see the same pool),
the scores scaled by 30**-0.5, and the output cut back to 30."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode import kernel_head_dim
from repro_torch.kernels.ref import gather_pages_ref, kv_dequant_ref, kv_quant_ref, page_slots
from repro_torch.models.common import NEG_INF, default_q_chunk
from repro_torch.models.layers import apply_rope
from repro_torch.models.sharding import gather_heads, map_shards, replica


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _kernel_heads(cfg: ModelConfig, *xs: torch.Tensor) -> list[torch.Tensor]:
    """xs (..., hd) zero-filled to the kernels' head dim."""
    pad = kernel_head_dim(cfg.resolved_head_dim) - cfg.resolved_head_dim
    return [F.pad(x, (0, pad)) if pad else x for x in xs]


def _kernel_scale(cfg: ModelConfig) -> float | None:
    """The softmax scale for the kernels: their default (hd**-0.5 of the
    operands) unless the heads were zero-filled, then the model's."""
    hd = cfg.resolved_head_dim
    return None if kernel_head_dim(hd) == hd else hd**-0.5


def _model_heads(cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """A kernel output (..., kernel hd) cut back to the model's head dim."""
    hd = cfg.resolved_head_dim
    return out if out.shape[-1] == hd else out[..., :hd]


def _queries(params: dict, x: torch.Tensor, positions: torch.Tensor | None,
             cfg: ModelConfig, rope: bool = True) -> torch.Tensor:
    """Queries grouped by kv head, rotated at ``positions`` unless ``rope``
    is False (whisper): (B, S, Hkv, G, hd)."""
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q.reshape(*x.shape[:2], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, hd)


def compute_kv_for_prefill(
    params: dict, x: torch.Tensor, positions: torch.Tensor | None, cfg: ModelConfig,
    rope: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Head-split (k, v) of a prompt, k rotated unless ``rope`` is False:
    (B, S, Hkv, hd) each."""
    hd = cfg.resolved_head_dim
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, hd)
    return (apply_rope(k, positions, cfg.rope_theta) if rope else k), v


def attend_full(
    params: dict, x: torch.Tensor, positions: torch.Tensor | None, cfg: ModelConfig, *,
    causal: bool = True, window: int = 0,
    kv: tuple[torch.Tensor, torch.Tensor] | None = None, rope: bool = True,
    kernel: bool = False,
) -> torch.Tensor:
    """Full-sequence attention (the reference's ``attend_full``): x (B, S,
    D) attends over its own k/v, or over ``kv`` = (k, v) (B, T, Hkv, hd)
    given (cross-attention, T free); causal at ``positions`` with an
    optional window, or (``causal=False``) over every key. ``rope`` False
    rotates nothing (whisper). Returns the output after ``wo``.

    By default in plain PyTorch under autograd: the training forward (the
    reference's chunked jnp path; its flash-prefill kernel has no
    backward). Scores and softmax in fp32, probabilities cast to the value
    dtype for the PV product; queries in chunks of ``default_q_chunk(S)``.
    ``kernel=True`` (the serving paths: whisper's encoder and its prefill's
    cross-attention) runs ``ops.flash_prefill_attention`` instead."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _queries(params, x, positions, cfg, rope)                  # (B, S, Hkv, G, hd)
    k, v = compute_kv_for_prefill(params, x, positions, cfg, rope) if kv is None else kv
    if kernel:
        q, k, v = _kernel_heads(cfg, q, k, v)
        out = ops.flash_prefill_attention(q, k, v, causal=causal, window=window,
                                          scale=_kernel_scale(cfg))
        return _model_heads(cfg, out).reshape(b, s, -1) @ params["wo"]
    chunk = default_q_chunk(s)
    outs = []
    for c0 in range(0, s, chunk):
        qc = q[:, c0:c0 + chunk]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), k.float()) * (hd**-0.5)
        if causal:
            pc = positions[:, c0:c0 + chunk]
            mask = pc[:, None, None, :, None] >= positions[:, None, None, None, :]
            if window > 0:
                mask &= (pc[:, None, None, :, None] - positions[:, None, None, None, :]) < window
            scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(b, qc.shape[1], -1))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.to(x.dtype) @ params["wo"]


def cross_decode_attend(params: dict, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                        cfg: ModelConfig, *, paged: bool = True) -> torch.Tensor:
    """One decode step's cross-attention (whisper's): the query of each row
    (x (B, 1, D), no rotation) over its T encoder keys xk/xv (B, T, Hkv,
    hd). A ring of T slots read at position T - 1 has every slot live, in
    position order, so this is the ring decode (``ops.swa_decode_attention``
    with window 0, ``paged`` as the step's own) over all T keys: the split-KV
    decode body, built for one query a row. Returns the output after
    ``wo``."""
    b = x.shape[0]
    q = _kernel_heads(cfg, _queries(params, x, None, cfg, rope=False))[0]
    out = ops.swa_decode_attention(q[:, 0], xk, xv, xk.shape[1] - 1, 0, paged=paged,
                                   scale=_kernel_scale(cfg))
    return _model_heads(cfg, out).reshape(b, 1, -1) @ params["wo"]


def int8_roundtrip_kv(x: torch.Tensor) -> torch.Tensor:
    """k or v as an int8 pool holds it and the decode kernels read it back:
    quantized per kv head (``kv_write_int8``'s scheme, the quotient divided
    IEEE-exact) and dequantized to x's dtype (f32 product, then rounded to
    the dtype, as ``paged_decode_int8`` does)."""
    return kv_dequant_ref(*kv_quant_ref(x), x.dtype)


def _prefill_heads(
    params: dict, cache: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, *,
    slots: torch.Tensor, lengths: torch.Tensor, write_starts: torch.Tensor,
    table_rows: torch.Tensor | None, starts: torch.Tensor | None, prefix_width: int | None,
    window: int, roundtrip_kv: bool,
) -> torch.Tensor:
    """One shard's prefill attention (every head with no active axis): the
    pre-``wo`` output (n, S, H·hd) of the prompt rows x (n, S, D), and the
    rows' k/v written into one layer's ``cache`` (the pool through
    ``table_rows`` from ``write_starts``, or the rows' rings). Cold rows
    (``starts`` None) attend causally over their own k/v through the
    flash-prefill kernel; suffix rows attend over the first starts[r]
    cached tokens of their pages and, causally, over their own k/v (through
    the int8 round trip with ``roundtrip_kv``) through the suffix-prefill
    kernel. The write touches only this round's slots, after the read."""
    n, s, _ = x.shape
    scale = _kernel_scale(cfg)
    k, v = compute_kv_for_prefill(params, x, positions, cfg)
    q, k, v = _kernel_heads(cfg, _queries(params, x, positions, cfg), k, v)
    if starts is None:
        out = ops.flash_prefill_attention(q, k, v, window=window, scale=scale)
    else:
        ka, va = (int8_roundtrip_kv(k), int8_roundtrip_kv(v)) if roundtrip_kv else (k, v)
        out = ops.suffix_prefill_attention(
            q, ka, va, cache["k"], cache["v"], table_rows, starts, prefix_width=prefix_width,
            pool_k_scale=cache.get("ks"), pool_v_scale=cache.get("vs"), scale=scale,
        )
    out = _model_heads(cfg, out)
    if "table" in cache:
        fill_pages_rows(cache, k, v, table_rows, write_starts, lengths)
    else:
        rows_k, rows_v = fill_cache_rows(cache["k"][slots], cache["v"][slots], k, v, lengths)
        cache["k"][slots] = rows_k
        cache["v"][slots] = rows_v
    return out.reshape(n, s, -1)


def prefill_attend(
    params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, cache, *,
    slots: torch.Tensor, lengths: torch.Tensor, write_starts: torch.Tensor,
    table_rows: torch.Tensor | None = None, starts: torch.Tensor | None = None,
    prefix_width: int | None = None, window: int = 0, roundtrip_kv: bool = False,
) -> torch.Tensor:
    """Attention of one layer of a batched prefill round, x (n, S, D) at
    ``positions``, with the rows' k/v written into the layer's ``cache``
    (``_prefill_heads``, per shard under a tensor axis), then the gathered
    heads through ``wo``."""
    out = map_shards(_prefill_heads, params, cache, x, positions, cfg, slots=slots,
                     lengths=lengths, write_starts=write_starts, table_rows=table_rows,
                     starts=starts, prefix_width=prefix_width, window=window,
                     roundtrip_kv=roundtrip_kv)
    return gather_heads(out) @ replica(params)["wo"]


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool (P, page, Hkv, hd) × table (B, T) → contiguous (B, T·page, Hkv,
    hd) ring rows."""
    return gather_pages_ref(pool, table)


def fill_pages_rows(
    pool: dict, k: torch.Tensor, v: torch.Tensor,
    table_rows: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
) -> None:
    """Per-row paged ring write into one layer's ``pool`` planes, in place:
    row r's first lengths[r] tokens of k/v (n, S, Hkv, hd) land at logical
    ring slots (starts[r] + j) mod T·page of its table row — the state
    lengths[r] sequential one-token writes leave. Only those slots are
    touched: no other lane of a page (shared prefix lanes included) is
    rewritten, and no two writes hit one slot (a row longer than its ring
    keeps only its last T·page tokens). So on an int8 pool only the written
    slots are quantized (``ops.kv_write_int8``, which works the slots out on
    the card), and shared prefix pages keep their bits: what the
    reference's masked requantization of whole gathered rows gives. An fp
    pool takes all n·S tokens in one index store per plane, each dead token
    sent to its offset on scratch page 0 (where dead tokens collide in no
    defined order, as dead decode rows do): no boolean mask, so no host
    wait, and outside page 0 the pool a masked store of the live tokens
    leaves."""
    if "ks" in pool:
        ops.kv_write_int8(pool, k, v, table_rows, starts, lengths)
        return
    live, phys, off = page_slots(table_rows, starts, lengths, k.shape[1], pool["k"].shape[1])
    idx = (torch.where(live, phys, torch.zeros_like(phys)).reshape(-1), off.reshape(-1))
    pool["k"].index_put_(idx, k.reshape(-1, *k.shape[2:]))
    pool["v"].index_put_(idx, v.reshape(-1, *v.shape[2:]))


def _decode_paged_heads(params: dict, cache: dict, x: torch.Tensor, cfg: ModelConfig,
                        window: int) -> torch.Tensor:
    """One decode step over one layer of the shared pool, one shard's heads
    (every head with no active axis): the pre-``wo`` output. x: (B, 1, D);
    cache: {"k"/"v": (P, page, Hkv, hd), "pos": (B,), "table": (B, T)} and,
    for an int8 pool, "ks"/"vs" (P, page, Hkv). Row b's token is written
    first, at logical ring slot pos[b] mod T·page through its table (in
    place; quantized per kv head on an int8 pool), then attends over its
    ring, itself included through the int8 round trip as the reference's
    does. Live slots own their pages, so rows never collide except on
    scratch page 0, which no live read dereferences."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos, table = cache["pos"], cache["table"]
    q = _queries(params, x, pos[:, None], cfg)                     # (B, 1, Hkv, G, hd)
    k, v = compute_kv_for_prefill(params, x, pos[:, None], cfg)    # (B, 1, Hkv, hd)
    q, k, v = _kernel_heads(cfg, q, k, v)
    if "ks" in cache:
        ops.kv_write_int8(cache, k, v, table, pos)
    else:
        page = cache["k"].shape[1]
        slot = pos.long() % (table.shape[1] * page)
        phys = table.long().gather(1, (slot // page)[:, None])[:, 0]
        off = slot % page
        cache["k"][phys, off] = k[:, 0]
        cache["v"][phys, off] = v[:, 0]
    out = ops.paged_decode_attention(q[:, 0], cache["k"], cache["v"], pos, table, window,
                                     k_scale=cache.get("ks"), v_scale=cache.get("vs"),
                                     scale=_kernel_scale(cfg))
    return _model_heads(cfg, out).reshape(b, 1, cfg.n_heads * hd)


def decode_attend_paged(params, x: torch.Tensor, cache, cfg: ModelConfig, *,
                        window: int = 0) -> torch.Tensor:
    """One decode step over one layer of the shared pool
    (``_decode_paged_heads``, per shard under a tensor axis), then the
    gathered heads through ``wo``."""
    out = map_shards(_decode_paged_heads, params, cache, x, cfg, window)
    return gather_heads(out) @ replica(params)["wo"]


# ------------------------------------------------------------ ring caches
def ring_capacity(max_seq: int, window: int = 0) -> int:
    """Slots of a ring: the window when 0 < window < max_seq, else max_seq.
    (The stacked rings of every layer are ``transformer.init_decode_cache``.)"""
    return window if 0 < window < max_seq else max_seq


def cache_capacity(cache: dict) -> int:
    return cache["k"].shape[1]


def fill_cache_rows(
    cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: torch.Tensor, starts: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched per-row ring write: row r's first lengths[r] tokens of k/v
    (n, S, Hkv, hd) into its ring row (n, C, Hkv, hd) from ring position
    starts[r] (0 when None), leaving the state lengths[r] one-token writes
    would. A gather, not a scatter: each ring slot c takes the LAST prompt
    index landing on it (a scatter with duplicate indices has no defined
    winner). Slots a row never reaches keep their old value. Returns the new
    rows (new_k, new_v)."""
    cap = cache_k.shape[1]
    c = torch.arange(cap, device=k.device)[None, :]
    last = lengths.long()[:, None] - 1
    c_rel = c if starts is None else (c - starts.long()[:, None]) % cap
    # the largest prompt index j < lengths[r] with j = c_rel (mod cap)
    j_star = c_rel + cap * torch.div(last - c_rel, cap, rounding_mode="floor")
    keep = (c_rel <= last)[:, :, None, None]
    idx = j_star.clamp(0, k.shape[1] - 1)[:, :, None, None].expand(-1, -1, *k.shape[2:])
    return (torch.where(keep, k.gather(1, idx), cache_k),
            torch.where(keep, v.gather(1, idx), cache_v))


def _decode_ring_heads(params: dict, cache: dict, x: torch.Tensor, cfg: ModelConfig,
                       window: int, paged: bool, rope: bool = True) -> torch.Tensor:
    """One decode step over one layer's ring cache, one shard's heads (every
    head with no active axis): the pre-``wo`` output. x: (B, 1, D); cache:
    {"k"/"v": (B, C, Hkv, hd), "pos": () or (B,)}. Row b's token (position
    pos[b], rotated unless ``rope`` is False) is written first, in place at
    slot pos[b] mod C, then attends over its ring through
    ``ops.swa_decode_attention`` (``paged``: the kernel that skips dead
    pages; else the one that streams every slot)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache["pos"]
    cap = cache_capacity(cache)
    pos_b = pos[:, None] if pos.dim() == 1 else pos.reshape(1, 1).expand(b, 1)
    q = _queries(params, x, pos_b, cfg, rope)                      # (B, 1, Hkv, G, hd)
    k, v = compute_kv_for_prefill(params, x, pos_b, cfg, rope)     # (B, 1, Hkv, hd)
    q, k, v = _kernel_heads(cfg, q, k, v)
    slot = pos.long() % cap
    if pos.dim() == 1:
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, slot] = k[:, 0]
        cache["v"][rows, slot] = v[:, 0]
    else:
        cache["k"].index_copy_(1, slot.reshape(1), k)
        cache["v"].index_copy_(1, slot.reshape(1), v)
    out = ops.swa_decode_attention(q[:, 0], cache["k"], cache["v"], pos, window, paged=paged,
                                   scale=_kernel_scale(cfg))
    return _model_heads(cfg, out).reshape(b, 1, cfg.n_heads * hd)


def decode_attend(params, x: torch.Tensor, cache, cfg: ModelConfig, *, window: int = 0,
                  paged: bool = True, rope: bool = True) -> torch.Tensor:
    """One decode step over one layer's ring cache (``_decode_ring_heads``,
    per shard under a tensor axis), then the gathered heads through
    ``wo``."""
    out = map_shards(_decode_ring_heads, params, cache, x, cfg, window, paged, rope)
    return gather_heads(out) @ replica(params)["wo"]


def fill_cache(cache: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """The whole-prompt ring write of a lockstep batch, in place: the S
    tokens of k/v (B, S, Hkv, hd), positions 0..S-1, into the ring
    (B, C, Hkv, hd) at slots position mod C. When S >= C only the last C
    tokens survive (the reference's roll by +first position); when S < C
    slots S.. keep their old value. ``fill_cache_rows`` with every row's
    length S."""
    lengths = torch.full((k.shape[0],), k.shape[1], dtype=torch.int32, device=k.device)
    new_k, new_v = fill_cache_rows(cache["k"], cache["v"], k, v, lengths)
    cache["k"].copy_(new_k)
    cache["v"].copy_(new_v)


def _prefill_local_heads(params: dict, x: torch.Tensor, positions: torch.Tensor,
                         cfg: ModelConfig, cache: dict, window: int,
                         rope: bool = True) -> torch.Tensor:
    """``prefill_local_attend`` for one shard's heads (every head with no
    active axis): the pre-``wo`` output (B, S, H·hd)."""
    b, s, _ = x.shape
    k, v = compute_kv_for_prefill(params, x, positions, cfg, rope)
    q, k, v = _kernel_heads(cfg, _queries(params, x, positions, cfg, rope), k, v)
    out = ops.flash_prefill_attention(q, k, v, window=window, scale=_kernel_scale(cfg))
    fill_cache(cache, k, v)
    return _model_heads(cfg, out).reshape(b, s, -1)


def prefill_local_attend(params: dict, x: torch.Tensor, positions: torch.Tensor,
                         cfg: ModelConfig, cache: dict, *, window: int,
                         rope: bool = True) -> torch.Tensor:
    """Whole-prompt prefill of one causal self-attention layer (the
    hybrid's local attention, a dense decoder's, whisper's decoder's): x
    (B, S, D) at positions 0..S-1 attends causally within ``window`` (0:
    every earlier key) through the flash-prefill kernel (the reference's
    ``attend_full`` in this role), and the prompt's k/v (rotated unless
    ``rope`` is False) fill the layer's ring ``cache`` ({"k"/"v": (B, C,
    Hkv, hd)}) in place (``fill_cache``). Returns the output after
    ``wo``."""
    return _prefill_local_heads(params, x, positions, cfg, cache, window, rope) @ params["wo"]


def _prefill_slot_heads(params: dict, cache: dict, x: torch.Tensor, positions: torch.Tensor,
                        cfg: ModelConfig, slot: torch.Tensor, window: int) -> torch.Tensor:
    """``prefill_slot_attend`` for one shard: its head slice of row
    ``slot`` gathered, prefilled as a batch of one, and written back."""
    row = {name: cache[name].index_select(0, slot) for name in ("k", "v")}
    out = _prefill_local_heads(params, x, positions, cfg, row, window)
    for name in ("k", "v"):
        cache[name].index_copy_(0, slot, row[name])
    return out


def prefill_slot_attend(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                        cache, slot: torch.Tensor, *, window: int) -> torch.Tensor:
    """One request's whole-prompt prefill into one row of a per-slot ring
    cache: x (1, S, D) at positions 0..S-1 attends causally within
    ``window`` through the flash-prefill kernel at B 1, and its rotated k/v
    go into row ``slot`` ((1,) long) of the layer's rings ({"k"/"v": (B, C,
    Hkv, hd)}) in place, every other row untouched; S >= C keeps the last C
    tokens, as ``fill_cache`` does. Per shard under a tensor axis, then the
    gathered heads through ``wo``."""
    out = map_shards(_prefill_slot_heads, params, cache, x, positions, cfg, slot, window)
    return gather_heads(out) @ replica(params)["wo"]
