"""Dense decoder transformer: parameters, the training forward and loss,
the shared paged KV cache, batched prefill (cold and suffix) and one decode
step.

Parameters are the reference package's pytree as a dict of tensors with the
same leaf paths, per-layer leaves stacked on a leading L axis; the layer
scan becomes a loop over that axis. The cache is updated in place (the
reference donated it through ``jit``) and returned."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import embed_tokens, lm_logits, padded_vocab, positions_for
from repro_torch.models.layers import (
    apply_mlp, cross_entropy_loss, embed_init, he_init, rms_norm,
)

LAYER_LEAVES = ("ln1", "attn", "ln2", "ffn")


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
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
            "ffn": {
                "w_gate": he(d, cfg.d_ff),
                "w_up": he(d, cfg.d_ff),
                "w_down": he(cfg.d_ff, d),
            },
        },
        "ln_f": {"scale": torch.zeros((d,), dtype=dt, device=device)},
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked per-layer leaves (views)."""
    return {
        name: {leaf: t[i] for leaf, t in params["layers"][name].items()}
        for name in LAYER_LEAVES
    }


def _train_layer(cfg: ModelConfig, lp: dict, h: torch.Tensor, positions: torch.Tensor,
                 window: int) -> torch.Tensor:
    a = rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps)
    h = h + attn.attend_causal(lp["attn"], a, positions, cfg, window=window)
    return _mlp_residual(cfg, lp, h)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: tokens (B, S) → (logits fp32 (B, S, Vp), aux loss
    (0 for the dense FFN)). With ``cfg.remat`` each layer is recomputed in
    the backward pass (``torch.utils.checkpoint``), as the reference's
    ``scan_layers`` does with ``jax.checkpoint``."""
    h = embed_tokens(params["embed"], tokens)
    pos = positions_for(tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_train_layer, cfg, lp, h, pos, window, use_reentrant=False)
        else:
            h = _train_layer(cfg, lp, h, pos, window)
    h = rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps)
    return lm_logits(params["embed"], h, cfg), torch.zeros((), device=tokens.device)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            window: int = 0) -> tuple[torch.Tensor, dict]:
    """(total loss, {"loss", "accuracy", "aux_loss"}) of a batch
    {"tokens", "labels"[, "mask"]} (B, S)."""
    logits, aux = forward(cfg, params, batch["tokens"], window=window)
    loss, acc = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "accuracy": acc, "aux_loss": aux}


def init_paged_cache(
    cfg: ModelConfig, num_slots: int, num_pages: int, page_size: int, table_width: int,
    *, device, kv_dtype: str = "fp",
) -> dict:
    """Stacked shared pool (L, P, page, Hkv, hd) for k and v, per-slot write
    positions and one (num_slots, T) page table shared by every layer. Page
    0 is the reserved scratch page."""
    if kv_dtype != "fp":
        raise NotImplementedError(f"kv_dtype={kv_dtype!r}: int8 pages are a later slice")
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = getattr(torch, cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((num_slots,), dtype=torch.int32, device=device),
        "table": torch.zeros((num_slots, table_width), dtype=torch.int32, device=device),
    }


def _mlp_residual(cfg: ModelConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    return h + apply_mlp(lp["ffn"], rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps))


def decode_step(
    cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor, *, window: int = 0,
) -> tuple[dict, torch.Tensor]:
    """One token for every slot. tokens (B, 1) → (cache, logits (B, Vp)).
    Every row writes its token at its own position, then ``pos`` advances."""
    h = embed_tokens(params["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        layer_cache = {
            "k": cache["k"][i], "v": cache["v"][i],
            "pos": cache["pos"], "table": cache["table"],
        }
        a = rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps)
        h = h + attn.decode_attend_paged(lp["attn"], a, layer_cache, cfg, window=window)
        h = _mlp_residual(cfg, lp, h)
    h = rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps)
    cache["pos"] += 1
    return cache, lm_logits(params["embed"], h, cfg)[:, 0]


def prefill_slots(
    cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
    lengths: torch.Tensor, slots: torch.Tensor, *,
    starts: torch.Tensor | None = None, prefix_pages: int | None = None,
    window: int = 0,
) -> tuple[dict, torch.Tensor]:
    """Batched prefill of n newly admitted rows in one forward.

    tokens (n, S) right-padded; lengths (n,); slots (n,) distinct slots. A
    row with length 0 is bucket padding: it writes nothing and leaves its
    slot's position alone. Row r's k/v land only at the ring slots its
    tokens occupy, through its page table; returns (cache, logits (n, Vp))
    at each row's last valid position.

    Cold mode (``starts`` None): positions 0..S-1, attention through the
    flash-prefill kernel. Suffix mode: row r's tokens are the uncached
    suffix of its prompt at positions starts[r] + i, attending over the
    first starts[r] cached tokens of its pages (at most ``prefix_pages``
    leading pages per row, all of the table when None) through the
    suffix-prefill kernel."""
    n, s = tokens.shape
    device = tokens.device
    slots = slots.long()
    lengths = lengths.to(torch.int32)
    table_rows = cache["table"][slots].contiguous()
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
    h = embed_tokens(params["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        a = rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps)
        k, v = attn.compute_kv_for_prefill(lp["attn"], a, pos, cfg)
        if starts is None:
            a = attn.attend_full(lp["attn"], a, pos, cfg, window=window, kv=(k, v))
        else:
            a = attn.attend_suffix(
                lp["attn"], a, pos, cfg, kv=(k, v), pool_k=ck, pool_v=cv,
                table_rows=table_rows, starts=starts, prefix_width=w_pfx,
            )
        h = _mlp_residual(cfg, lp, h + a)
        # the prefix lanes were read above; the write touches only this
        # round's own slots
        attn.fill_pages_rows(ck, cv, k, v, table_rows, write_starts, lengths)
    h = rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps)
    last = h[torch.arange(n, device=device), (lengths.long() - 1).clamp(min=0)]
    logits = lm_logits(params["embed"], last[:, None], cfg)[:, 0]
    end = lengths + write_starts
    cache["pos"][slots] = torch.where(lengths > 0, end, cache["pos"][slots])
    return cache, logits
