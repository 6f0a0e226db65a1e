"""Whisper-medium: the transformer encoder-decoder. [arXiv:2212.04356]

As in the reference, the mel-spectrogram and conv frontend is a stub: the
inputs carry precomputed frame embeddings (B, encoder_seq = 1500, D).
Everything after it is real: the encoder, the decoder with cross-attention,
the cached decode. Whisper's idioms: LayerNorm with a bias, plain GELU MLPs
with biases, no rotary embedding anywhere; sinusoidal positions on both
sides (the reference's unbounded form for the decoder, where whisper has
learned positions capped at 448).

The parameter tree is the reference's, per-layer leaves stacked on a
leading L axis: ``embed/tok`` (tied), ``enc/layers/{ln1, attn, ln2, mlp}``,
``enc/ln_post``, ``dec/layers/{ln1, attn, ln_x, xattn, ln2, mlp}`` and
``dec/ln_f``; every LayerNorm is ``{scale, bias}``, every MLP ``{w_up,
b_up, w_down, b_down}``.

Training (``forward``, ``loss_fn``) runs the attention in plain PyTorch
under autograd (``attention.attend_full``). The serving paths run the
kernels: the encoder's self-attention and the prefill's cross-attention
through ``flash_prefill``'s non-causal mode, the prefill's decoder
self-attention through its causal mode into the ring caches, and the
decode step's self-attention and cross-attention through the ring decode
kernels. The decode cache holds each decoder layer's self-attention ring
(``k``/``v`` (L, B, C, Hkv, hd)) and its cross K/V over the encoder's
output (``xk``/``xv`` (L, B, T, Hkv, hd)), computed once; the decode step
writes it in place (a CUDA graph replays the step) and reads its position
on the device (no host read)."""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_decode import kernel_head_dim
from repro_torch.models import attention as attn
from repro_torch.models.common import embed_tokens, lm_logits, padded_vocab, positions_for
from repro_torch.models.layers import (
    apply_mlp, cross_entropy_loss, embed_init, he_init, layer_norm,
)


def sinusoid_positions(seq: int, d: int, offset=0, device=None) -> torch.Tensor:
    """(seq, d) fp32: [sin(p·inv) ; cos(p·inv)] at positions offset ..
    offset + seq - 1, inv = exp(-ln(10000) · i / (d/2 - 1)). ``offset`` may
    be a device tensor (the decode step's position)."""
    if torch.is_tensor(offset):
        device = offset.device
    pos = (torch.arange(seq, device=device) + offset)[:, None].float()
    dim = torch.arange(d // 2, device=device)[None, :].float()
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2 - 1))
    angles = pos * inv
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ------------------------------------------------------------------- params
def _layer_norm_init(shape, dt, device) -> dict:
    return {"scale": torch.ones(shape, dtype=dt, device=device),
            "bias": torch.zeros(shape, dtype=dt, device=device)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's init scales (He for matrices,
    0.02 for the embedding, unit LayerNorm scales, zero biases), drawn from
    ``generator`` on ``device``."""
    dt = getattr(torch, cfg.dtype)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim

    def stack(L, with_cross):
        def he(*shape):
            return he_init((L, *shape), dt, generator, device)

        def attn_init():
            return {"wq": he(d, cfg.n_heads * hd), "wk": he(d, cfg.n_kv_heads * hd),
                    "wv": he(d, cfg.n_kv_heads * hd), "wo": he(cfg.n_heads * hd, d)}

        layers = {"ln1": _layer_norm_init((L, d), dt, device), "attn": attn_init()}
        if with_cross:
            layers["ln_x"] = _layer_norm_init((L, d), dt, device)
            layers["xattn"] = attn_init()
        layers["ln2"] = _layer_norm_init((L, d), dt, device)
        layers["mlp"] = {"w_up": he(d, f), "b_up": torch.zeros((L, f), dtype=dt, device=device),
                         "w_down": he(f, d),
                         "b_down": torch.zeros((L, d), dtype=dt, device=device)}
        return layers

    embed = {"tok": embed_init((padded_vocab(cfg.vocab_size), d), dt, generator, device)}
    if not cfg.tie_embeddings:
        embed["unembed"] = embed_init((d, padded_vocab(cfg.vocab_size)), dt, generator, device)
    return {
        "embed": embed,
        "enc": {"layers": stack(cfg.encoder_layers or cfg.n_layers, False),
                "ln_post": _layer_norm_init((d,), dt, device)},
        "dec": {"layers": stack(cfg.n_layers, True),
                "ln_f": _layer_norm_init((d,), dt, device)},
    }


def _layer(layers: dict, i: int) -> dict:
    """Layer i's slice of a stack's leaves (views)."""
    return {name: {leaf: t[i] for leaf, t in group.items()} for name, group in layers.items()}


def _ln(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _run(cfg: ModelConfig, fn, *args):
    """One layer, recomputed in the backward pass with ``cfg.remat`` (as
    the reference's ``scan_layers`` does)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ------------------------------------------------------------------ encoder
def _enc_layer(cfg: ModelConfig, lp: dict, h: torch.Tensor, kernel: bool) -> torch.Tensor:
    a = attn.attend_full(lp["attn"], _ln(lp["ln1"], h, cfg), None, cfg, causal=False,
                         rope=False, kernel=kernel)
    h = h + a
    return h + apply_mlp(lp["mlp"], _ln(lp["ln2"], h, cfg))


def encode(cfg: ModelConfig, params: dict, audio_embeds: torch.Tensor, *,
           kernel: bool = False) -> torch.Tensor:
    """audio_embeds (B, T, D) from the stub frontend → the encoder's output
    (B, T, D): sinusoidal positions, non-causal self-attention layers,
    ``ln_post``. ``kernel``: the attention through ``flash_prefill``'s
    non-causal mode (the serving paths), else plain under autograd."""
    b, s, d = audio_embeds.shape
    x = audio_embeds + sinusoid_positions(s, d, device=audio_embeds.device).to(
        audio_embeds.dtype)[None]
    layers = params["enc"]["layers"]
    for i in range(cfg.encoder_layers or cfg.n_layers):
        x = _run(cfg, _enc_layer, cfg, _layer(layers, i), x, kernel)
    return _ln(params["enc"]["ln_post"], x, cfg)


# ------------------------------------------------------------------ decoder
def _cross_kv(lp: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """One decoder layer's cross K/V over the encoder's output: (B, T, Hkv,
    hd) each."""
    shape = (*enc_out.shape[:-1], cfg.n_kv_heads, cfg.resolved_head_dim)
    return ((enc_out @ lp["xattn"]["wk"]).reshape(shape),
            (enc_out @ lp["xattn"]["wv"]).reshape(shape))


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor, offset=0) -> torch.Tensor:
    x = embed_tokens(params["embed"], tokens)
    return x + sinusoid_positions(tokens.shape[1], cfg.d_model, offset,
                                  device=x.device).to(x.dtype)[None]


def _dec_layer(cfg: ModelConfig, lp: dict, h: torch.Tensor, pos: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    h = h + attn.attend_full(lp["attn"], _ln(lp["ln1"], h, cfg), pos, cfg, causal=True,
                             rope=False)
    h = h + attn.attend_full(lp["xattn"], _ln(lp["ln_x"], h, cfg), None, cfg, causal=False,
                             kv=_cross_kv(lp, enc_out, cfg), rope=False)
    return h + apply_mlp(lp["mlp"], _ln(lp["ln2"], h, cfg))


def decode_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass (training): tokens (B, S) over the
    encoder's output → logits fp32 (B, S, Vp)."""
    x = _embed(cfg, params, tokens)
    pos = positions_for(tokens)
    layers = params["dec"]["layers"]
    for i in range(cfg.n_layers):
        x = _run(cfg, _dec_layer, cfg, _layer(layers, i), x, pos, enc_out)
    return lm_logits(params["embed"], _ln(params["dec"]["ln_f"], x, cfg), cfg)


def forward(cfg: ModelConfig, params: dict, batch: dict):
    """{"audio_embeds" (B, T, D), "tokens" (B, S)} → (logits fp32 (B, S,
    Vp), aux 0)."""
    enc_out = encode(cfg, params, batch["audio_embeds"])
    return (decode_forward(cfg, params, batch["tokens"], enc_out),
            torch.zeros((), device=enc_out.device))


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    logits, _ = forward(cfg, params, batch)
    loss, acc = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss, "accuracy": acc}


# ------------------------------------------------------------ serving paths
def _empty_cache(cfg: ModelConfig, b: int, cap: int, t: int, dt, device) -> dict:
    hd = kernel_head_dim(cfg.resolved_head_dim)
    ring = (cfg.n_layers, b, cap, cfg.n_kv_heads, hd)
    cross = (cfg.n_layers, b, t, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(ring, dtype=dt, device=device),
            "v": torch.zeros(ring, dtype=dt, device=device),
            "xk": torch.empty(cross, dtype=dt, device=device),
            "xv": torch.empty(cross, dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _store_cross(cfg: ModelConfig, cache: dict, i: int, xk: torch.Tensor,
                 xv: torch.Tensor) -> None:
    xk, xv = attn._kernel_heads(cfg, xk, xv)
    cache["xk"][i].copy_(xk)
    cache["xv"][i].copy_(xv)


def prefill(cfg: ModelConfig, params: dict, batch: dict, *, window: int = 0,
            cache_window: int = 0) -> tuple[dict, torch.Tensor]:
    """The encoder, then the prompt (B, S) teacher-forced through the
    decoder in one pass: the self-attention causally (within ``window``)
    into rings of ``cache_window`` slots (S when 0), the cross-attention
    over every frame, both through ``flash_prefill``; each layer's cross K/V
    kept. Returns (the decode cache at pos S, logits (B, Vp) of the last
    position)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    enc_out = encode(cfg, params, batch["audio_embeds"], kernel=True)
    x = _embed(cfg, params, tokens)
    pos = positions_for(tokens)
    cache = _empty_cache(cfg, b, cache_window if cache_window > 0 else s, enc_out.shape[1],
                         x.dtype, x.device)
    layers = params["dec"]["layers"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x = x + attn.prefill_local_attend(lp["attn"], _ln(lp["ln1"], x, cfg), pos, cfg,
                                          {"k": cache["k"][i], "v": cache["v"][i]},
                                          window=window, rope=False)
        xk, xv = _cross_kv(lp, enc_out, cfg)
        _store_cross(cfg, cache, i, xk, xv)
        x = x + attn.attend_full(lp["xattn"], _ln(lp["ln_x"], x, cfg), None, cfg,
                                 causal=False, kv=(xk, xv), rope=False, kernel=True)
        x = x + apply_mlp(lp["mlp"], _ln(lp["ln2"], x, cfg))
    x = _ln(params["dec"]["ln_f"], x, cfg)
    cache["pos"].fill_(s)
    return cache, lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]


def init_decode_cache(cfg: ModelConfig, params: dict, audio_embeds: torch.Tensor,
                      max_seq: int, *, window: int = 0) -> dict:
    """Runs the encoder (``flash_prefill``, non-causal), keeps every decoder
    layer's cross K/V over its output, and allocates empty self-attention
    rings of ``attention.ring_capacity(max_seq, window)`` slots."""
    enc_out = encode(cfg, params, audio_embeds, kernel=True)
    cache = _empty_cache(cfg, audio_embeds.shape[0], attn.ring_capacity(max_seq, window),
                         enc_out.shape[1], audio_embeds.dtype, audio_embeds.device)
    layers = params["dec"]["layers"]
    for i in range(cfg.n_layers):
        _store_cross(cfg, cache, i, *_cross_kv(_layer(layers, i), enc_out, cfg))
    return cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor, *,
                window: int = 0, paged: bool = True) -> tuple[dict, torch.Tensor]:
    """tokens (B, 1) → (cache, logits (B, Vp)): the token's sinusoid at the
    cache's device position, then per layer the self-attention over its
    ring (written first, in place) and the cross-attention over its T
    frames, both through the ring decode kernels (``paged``: the one that
    skips dead pages; else the one that streams every slot)."""
    pos = cache["pos"]
    x = _embed(cfg, params, tokens, offset=pos)
    layers = params["dec"]["layers"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x = x + attn.decode_attend(lp["attn"], _ln(lp["ln1"], x, cfg),
                                   {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}, cfg,
                                   window=window, paged=paged, rope=False)
        x = x + attn.cross_decode_attend(lp["xattn"], _ln(lp["ln_x"], x, cfg), cache["xk"][i],
                                         cache["xv"][i], cfg, paged=paged)
        x = x + apply_mlp(lp["mlp"], _ln(lp["ln2"], x, cfg))
    x = _ln(params["dec"]["ln_f"], x, cfg)
    cache["pos"] += 1
    return cache, lm_logits(params["embed"], x, cfg)[:, 0]
