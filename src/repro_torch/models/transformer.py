"""Dense decoder transformer: parameters, the training forward and loss,
the KV caches (per-row contiguous rings, or the shared paged pool), prefill
(whole prompts, one slot, or batched cold and suffix rounds) and one decode
step.

Parameters are the reference package's pytree as a dict of tensors with the
same leaf paths, per-layer leaves stacked on a leading L axis; the layer
scan becomes a loop over that axis. The cache is updated in place (the
reference donated it through ``jit``) and returned.

The feed-forward block is a hook (``FFNHooks``, as in the reference): the
dense SwiGLU MLP here (``DENSE_FFN``) or the MoE layer (``models/moe.py``'s
``MOE_FFN``); its ``apply`` returns (out, aux loss), the aux summed over
layers into the training loss and dropped by the serving paths.

``decode_step`` and ``prefill_slots`` also run tensor-parallel: under an
active tensor axis (``models/sharding.py``) ``params`` and ``cache`` are
``Sharded`` trees (the config is the per-shard one,
``model.localize_config``); attention runs per shard and everything else
once, on the replicated leaves."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_decode import kernel_head_dim
from repro_torch.models import attention as attn
from repro_torch.models.common import embed_tokens, lm_logits, padded_vocab, positions_for
from repro_torch.models.layers import (
    apply_mlp, cross_entropy_loss, embed_init, he_init, rms_norm,
)
from repro_torch.models.sharding import replica, tensor_axis

LAYER_LEAVES = ("ln1", "attn", "ln2", "ffn")


class FFNHooks(NamedTuple):
    """Pluggable feed-forward: ``init(cfg, generator, device)`` → the
    stacked (L, ...) ``ffn`` leaves; ``apply(params, x, cfg, aux=True)`` →
    (out, aux loss ()). The serving paths pass ``aux=False`` and drop the
    aux, which the hook then need not compute."""
    init: Callable[..., dict]
    apply: Callable[..., tuple[torch.Tensor, torch.Tensor]]


def _dense_ffn_init(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    dt, d, L = getattr(torch, cfg.dtype), cfg.d_model, cfg.n_layers
    return {
        "w_gate": he_init((L, d, cfg.d_ff), dt, generator, device),
        "w_up": he_init((L, d, cfg.d_ff), dt, generator, device),
        "w_down": he_init((L, cfg.d_ff, d), dt, generator, device),
    }


def _dense_ffn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, aux: bool = True):
    return apply_mlp(params, x, cfg.act), 0.0


DENSE_FFN = FFNHooks(_dense_ffn_init, _dense_ffn_apply)


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                ffn: FFNHooks = DENSE_FFN) -> dict:
    """Random weights with the reference's init scales (He for matrices,
    0.02 for embeddings, zero RMS scales), drawn from ``generator`` on
    ``device``."""
    dt = getattr(torch, cfg.dtype)
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    vp = padded_vocab(cfg.vocab_size)

    def he(*shape, fan_in=None):
        return he_init((L, *shape), dt, generator, device, fan_in=fan_in)

    embed = {"tok": embed_init((vp, d), dt, generator, device)}
    if not cfg.tie_embeddings:
        embed["unembed"] = embed_init((d, vp), dt, generator, device)
    zeros = lambda: torch.zeros((L, d), dtype=dt, device=device)  # noqa: E731
    return {
        "embed": embed,
        "layers": {
            "ln1": {"scale": zeros()},
            "attn": {
                "wq": he(d, cfg.n_heads * hd),
                "wk": he(d, cfg.n_kv_heads * hd),
                "wv": he(d, cfg.n_kv_heads * hd),
                "wo": he(cfg.n_heads * hd, d),
            },
            "ln2": {"scale": zeros()},
            "ffn": ffn.init(cfg, generator, device),
        },
        "ln_f": {"scale": torch.zeros((d,), dtype=dt, device=device)},
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked per-layer leaves (views)."""
    return {
        name: {leaf: t[i] for leaf, t in params["layers"][name].items()}
        for name in LAYER_LEAVES if name in params["layers"]
    }


def _per_shard(fn, tree, *args):
    """``fn(tree, *args)``, on the replicated tree and every shard's under
    an active tensor axis."""
    return fn(tree, *args) if tensor_axis() is None else tree.map(fn, *args)


def _train_layer(cfg: ModelConfig, lp: dict, h: torch.Tensor, positions: torch.Tensor,
                 window: int, ffn: FFNHooks) -> tuple[torch.Tensor, torch.Tensor]:
    a = rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps)
    h = h + attn.attend_causal(lp["attn"], a, positions, cfg, window=window)
    f, aux = ffn.apply(lp["ffn"], rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps), cfg)
    return h + f, aux


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            ffn: FFNHooks = DENSE_FFN, window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: tokens (B, S) → (logits fp32 (B, S, Vp), aux loss
    summed over layers (0 for the dense FFN)). With ``cfg.remat`` each
    layer is recomputed in the backward pass (``torch.utils.checkpoint``),
    as the reference's ``scan_layers`` does with ``jax.checkpoint``."""
    h = embed_tokens(params["embed"], tokens)
    pos = positions_for(tokens)
    aux = torch.zeros((), device=tokens.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat and torch.is_grad_enabled():
            h, a = checkpoint(_train_layer, cfg, lp, h, pos, window, ffn, use_reentrant=False)
        else:
            h, a = _train_layer(cfg, lp, h, pos, window, ffn)
        aux = aux + a
    h = rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps)
    return lm_logits(params["embed"], h, cfg), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            ffn: FFNHooks = DENSE_FFN, window: int = 0) -> tuple[torch.Tensor, dict]:
    """(total loss, {"loss", "accuracy", "aux_loss"}) of a batch
    {"tokens", "labels"[, "mask"]} (B, S): the cross entropy plus
    ``cfg.router_aux_weight`` times the aux loss."""
    logits, aux = forward(cfg, params, batch["tokens"], ffn=ffn, window=window)
    loss, acc = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "accuracy": acc, "aux_loss": aux}


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *, window: int = 0,
                      per_slot: bool = False, device) -> dict:
    """Stacked (L, B, C, Hkv, hd) ring caches, C = window if 0 < window <
    max_seq else max_seq, hd the kernels' (``kernel_head_dim``). ``per_slot``
    gives each row its own position ((B,) instead of ()), so rows act as
    recyclable request slots."""
    shape = (cfg.n_layers, batch, attn.ring_capacity(max_seq, window), cfg.n_kv_heads,
             kernel_head_dim(cfg.resolved_head_dim))
    dt = getattr(torch, cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device),
    }


def reset_slot(cache: dict, slot: int) -> dict:
    """Recycle one slot of a per-slot cache: zero its position. Stale k/v
    need no clearing (the decode mask derives from ``pos``)."""
    if cache["pos"].dim() != 1:
        raise ValueError("reset_slot needs a per-slot cache")
    cache["pos"][slot] = 0
    return cache


def init_paged_cache(
    cfg: ModelConfig, num_slots: int, num_pages: int, page_size: int, table_width: int,
    *, device, kv_dtype: str = "fp",
) -> dict:
    """Stacked shared pool (L, P, page, Hkv, hd) for k and v (hd the
    kernels', ``kernel_head_dim``), per-slot write
    positions and one (num_slots, T) page table shared by every layer. Page
    0 is the reserved scratch page.

    ``kv_dtype="int8"`` stores the pages quantized (``ref.kv_quant_ref``'s row
    scheme): k/v become int8 and ``ks``/``vs`` hold one f32 scale per token
    slot per kv head, shape ``k.shape[:-1]`` (1/hd of the page bytes)."""
    if kv_dtype not in ("fp", "int8"):
        raise ValueError(f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             kernel_head_dim(cfg.resolved_head_dim))
    dt = torch.int8 if kv_dtype == "int8" else getattr(torch, cfg.dtype)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((num_slots,), dtype=torch.int32, device=device),
        "table": torch.zeros((num_slots, table_width), dtype=torch.int32, device=device),
    }
    if kv_dtype == "int8":
        cache["ks"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache["vs"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


KV_PLANES = ("k", "v", "ks", "vs")


def layer_cache(cache: dict, i: int) -> dict:
    """Layer i's views of the cache planes (``k``/``v`` and, for an int8
    pool, ``ks``/``vs``) with the shared ``pos`` and, for the paged pool,
    ``table``: those of them the tree holds (a shard's tree of a
    ``Sharded`` cache holds only its planes, the replicated tree only
    ``pos`` and ``table``)."""
    out = {name: cache[name][i] for name in KV_PLANES if name in cache}
    out.update({name: cache[name] for name in ("pos", "table") if name in cache})
    return out


def _ffn_residual(cfg: ModelConfig, lp: dict, h: torch.Tensor, ffn: FFNHooks) -> torch.Tensor:
    """h + the FFN of its norm; the aux loss is dropped (serving)."""
    return h + ffn.apply(lp["ffn"], rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps), cfg,
                         aux=False)[0]


def decode_step(
    cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor, *,
    ffn: FFNHooks = DENSE_FFN, window: int = 0, paged: bool = True,
) -> tuple[dict, torch.Tensor]:
    """One token for every row. tokens (B, 1) → (cache, logits (B, Vp)).
    Every row writes its token at its own position, then ``pos`` advances.
    Works over both layouts: the shared paged pool (a ``table`` key) and
    ring caches, whose decode attention skips dead pages when ``paged``
    (else streams every slot; the same output)."""
    p0 = replica(params)
    h = embed_tokens(p0["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = _per_shard(layer_params, params, i)
        lc = _per_shard(layer_cache, cache, i)
        ap = _per_shard(lambda t: t["attn"], lp)
        a = rms_norm(h, replica(lp)["ln1"]["scale"], cfg.norm_eps)
        if "table" in replica(cache):
            h = h + attn.decode_attend_paged(ap, a, lc, cfg, window=window)
        else:
            h = h + attn.decode_attend(ap, a, lc, cfg, window=window, paged=paged)
        h = _ffn_residual(cfg, replica(lp), h, ffn)
    h = rms_norm(h, p0["ln_f"]["scale"], cfg.norm_eps)
    replica(cache)["pos"] += 1
    return cache, lm_logits(p0["embed"], h, cfg)[:, 0]


def prefill_slots(
    cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
    lengths: torch.Tensor, slots: torch.Tensor, *,
    starts: torch.Tensor | None = None, prefix_pages: int | None = None,
    ffn: FFNHooks = DENSE_FFN, window: int = 0, return_all_logits: bool = False,
) -> tuple[dict, torch.Tensor]:
    """Batched prefill of n newly admitted rows in one forward.

    tokens (n, S) right-padded; lengths (n,); slots (n,) distinct slots. A
    row with length 0 is bucket padding: it writes nothing and leaves its
    slot's position alone. Row r's k/v land only at the ring slots its
    tokens occupy (a prompt longer than the ring leaves its last C tokens,
    each slot holding the last index that lands on it), through its page
    table or, for a per-slot ring cache (no ``table``), in its ring row;
    returns (cache, logits (n, Vp)) at each row's last valid position.

    Cold mode (``starts`` None): positions 0..S-1, attention through the
    flash-prefill kernel. Suffix mode: row r's tokens are the uncached
    suffix of its prompt at positions starts[r] + i, attending over the
    first starts[r] cached tokens of its pages (at most ``prefix_pages``
    leading pages per row, all of the table when None) through the
    suffix-prefill kernel.

    An int8 pool is written quantized (only at this round's slots, so
    shared prefix pages keep their bits); cold rows attend their own fp
    k/v, suffix rows the dequantized prefix plus their own fp k/v.

    ``return_all_logits=True`` returns logits at EVERY padded position, (n,
    S, Vp), instead of only each row's last valid one: the k-token verify
    of speculative decoding reads one target logit per draft position out
    of one suffix dispatch (positions at or past lengths[r] are garbage).
    On an fp pool the cache write is bitwise the False path's. On an int8
    pool, suffix rows attend their own k/v through the int8 round trip, as
    the decode step sees the tokens it reads back from the pool, so the
    verify reproduces per-token decode; the pool write quantizes each
    layer's k/v as computed (from layer 1 on, they follow the round trip's
    residual stream, as the decode steps' writes do)."""
    n, s = tokens.shape
    device = tokens.device
    slots = slots.long()
    lengths = lengths.to(torch.int32)
    c0, p0 = replica(cache), replica(params)
    table_rows = w_pfx = None
    if "table" not in c0:
        if starts is not None:
            raise ValueError("suffix prefill needs the paged pool")
    else:
        table_rows = c0["table"][slots].contiguous()
        t_w = table_rows.shape[1]
    if starts is None:
        pos = positions_for(tokens)
        write_starts = torch.zeros(n, dtype=torch.int32, device=device)
    else:
        if window != 0:
            raise ValueError("suffix prefill is windowless (the ring must not wrap)")
        starts = starts.to(torch.int32)
        pos = starts[:, None] + positions_for(tokens)
        w_pfx = t_w if prefix_pages is None else max(1, min(prefix_pages, t_w))
        write_starts = starts
    roundtrip_kv = starts is not None and return_all_logits and "ks" in c0
    h = embed_tokens(p0["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = _per_shard(layer_params, params, i)
        lc = _per_shard(layer_cache, cache, i)
        a = rms_norm(h, replica(lp)["ln1"]["scale"], cfg.norm_eps)
        a = attn.prefill_attend(
            _per_shard(lambda t: t["attn"], lp), a, pos, cfg, lc, slots=slots,
            lengths=lengths, write_starts=write_starts, table_rows=table_rows, starts=starts,
            prefix_width=w_pfx, window=window, roundtrip_kv=roundtrip_kv,
        )
        h = _ffn_residual(cfg, replica(lp), h + a, ffn)
    h = rms_norm(h, p0["ln_f"]["scale"], cfg.norm_eps)
    if return_all_logits:
        logits = lm_logits(p0["embed"], h, cfg)
    else:
        last = h[torch.arange(n, device=device), (lengths.long() - 1).clamp(min=0)]
        logits = lm_logits(p0["embed"], last[:, None], cfg)[:, 0]
    end = lengths + write_starts
    c0["pos"][slots] = torch.where(lengths > 0, end, c0["pos"][slots])
    return cache, logits
