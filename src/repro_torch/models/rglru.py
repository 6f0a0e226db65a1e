"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
sliding-window MQA attention in a repeating (rec, rec, attn) pattern
[arXiv:2402.19427]; the port of the reference's ``models/rglru.py``.

The RG-LRU is a gated diagonal linear recurrence:

    r_t = σ(W_r x_t + b_r)           (recurrence gate, block-diagonal per head)
    i_t = σ(W_i x_t + b_i)           (input gate, block-diagonal per head)
    a_t = exp(-c · softplus(Λ) · r_t)          (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Over a sequence it runs as a log-depth scan (``rg_lru_scan``: the
reference's ``jax.lax.associative_scan``, written as a Hillis-Steele scan of
plain torch ops, differentiable under autograd); a decode step is the O(1)
update. The temporal conv (width 4, depthwise, causal) carries a
(width - 1)-tap state in decode. The local-attention blocks keep a ring of
their window: whole-prompt prefill attends through the flash-prefill
kernel and fills the ring (``attention.prefill_local_attend``), decode goes
through the ring decode kernels (``attention.decode_attend``), training
through the plain ``attend_causal`` under autograd.

Parameters and decode caches keep the reference's periodic layout
(``common.periodic_stack``); a decode step updates every state of the cache
in place (RG-LRU ``h`` and ``conv``, the rings, ``pos``), so that a CUDA
graph of the step replays on the same tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_decode import kernel_head_dim
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    LeafInit, const, embed_tokens, he, init_leaves, lm_logits, param_specs, periodic_layer,
    periodic_stack, positions_for,
)
from repro_torch.models.layers import apply_mlp, cross_entropy_loss, gelu, rms_norm

RG_C = 8.0


def pattern(cfg: ModelConfig) -> tuple[str, ...]:
    return tuple(cfg.block_pattern) or ("rglru", "rglru", "attn")


# ------------------------------------------------------------------- params
def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    d, w, hd = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.resolved_head_dim
    if kind == "rglru":
        bd = w // cfg.n_heads
        mix = {
            "w_x": he(d, w), "w_y": he(d, w), "w_out": he(w, d),
            "conv_w": he(cfg.conv_width, w), "conv_b": const((w,)),
            "gate_r": he(cfg.n_heads, bd, bd), "gate_r_b": const((w,)),
            "gate_i": he(cfg.n_heads, bd, bd), "gate_i_b": const((w,)),
            "lam": LeafInit((w,), "lam", RG_C, f32=True),
        }
    else:
        mix = {"wq": he(d, cfg.n_heads * hd), "wk": he(d, cfg.n_kv_heads * hd),
               "wv": he(d, cfg.n_kv_heads * hd), "wo": he(cfg.n_heads * hd, d)}
    return {"ln1": {"scale": const((d,))}, "mix": mix, "ln2": {"scale": const((d,))},
            "mlp": {"w_gate": he(d, cfg.d_ff), "w_up": he(d, cfg.d_ff),
                    "w_down": he(cfg.d_ff, d)}}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    return init_leaves(param_specs(cfg, layer_specs, pattern(cfg)), generator, device,
                       getattr(torch, cfg.dtype))


# ------------------------------------------------------------------- RG-LRU
def _block_diag_apply(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., W) with W = H·hd; w (H, hd, hd)."""
    h, hd, _ = w.shape
    xs = x.reshape(*x.shape[:-1], h, hd)
    return torch.einsum("...hi,hij->...hj", xs, w).reshape(x.shape) + b


def _rg_lru_coeffs(p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gates of x (..., W) → the recurrence coefficients (a, bx), fp32."""
    r = torch.sigmoid(_block_diag_apply(p["gate_r"], p["gate_r_b"], x).float())
    i = torch.sigmoid(_block_diag_apply(p["gate_i"], p["gate_i_b"], x).float())
    log_a = -RG_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x.float())
    return a, bx


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0, in log2(S)
    Hillis-Steele steps of the associative combine (a1, b1) ∘ (a2, b2) =
    (a1 a2, a2 b1 + b2): step d folds each element with the one d earlier.
    Plain out-of-place ops, so autograd differentiates it. The sums are
    grouped otherwise than in the reference's ``associative_scan`` and than
    in a sequential loop: equal to either up to fp32 rounding."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rg_lru_scan(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None):
    """Over a sequence: x (B, S, W) → (y (B, S, W) in x's dtype, h_final
    (B, W) fp32); ``h0`` (B, W) the state before the first step."""
    a, bx = _rg_lru_coeffs(p, x)
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0.float()[:, None], bx[:, 1:]], dim=1)
    h = linear_scan(a, bx)
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(p: dict, x: torch.Tensor, h_prev: torch.Tensor):
    """One decode step: x (B, 1, W), h_prev (B, W) fp32 → (y (B, 1, W), h)."""
    a, bx = _rg_lru_coeffs(p, x)
    h = a[:, 0] * h_prev + bx[:, 0]
    return h.to(x.dtype)[:, None, :], h


def causal_conv(p: dict, x: torch.Tensor, tail: torch.Tensor | None = None):
    """Depthwise causal conv of x (B, S, W) with ``p["conv_w"]`` (cw, W)
    and ``p["conv_b"]``; ``tail`` (B, cw - 1, W) is the carried state (zeros
    when None). Returns (y, new tail)."""
    cw = p["conv_w"].shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * p["conv_w"][i] for i in range(cw))
    return y + p["conv_b"], xp[:, -(cw - 1):]


# ------------------------------------------------------------- block bodies
def _rec_mixing(p: dict, x: torch.Tensor, state: dict | None):
    """The Griffin recurrent branch of x (B, S, D): (out, new h fp32, new
    conv tail); ``state`` ({"h", "conv"}) is read, not written."""
    gate = gelu(x @ p["w_y"])
    main = x @ p["w_x"]
    main, new_tail = causal_conv(p, main, None if state is None else state["conv"])
    if x.shape[1] == 1 and state is not None:
        y, new_h = rg_lru_step(p, main, state["h"])
    else:
        y, new_h = rg_lru_scan(p, main, None if state is None else state["h"])
    return (y * gate) @ p["w_out"], new_h.float(), new_tail


def _mlp_residual(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps), cfg.act)


def _train_layer(cfg: ModelConfig, kind: str, lp: dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
    if kind == "rglru":
        out = _rec_mixing(lp["mix"], h, None)[0]
    else:
        out = attn.attend_causal(lp["mix"], h, positions, cfg, window=cfg.local_attn_window)
    return _mlp_residual(cfg, lp, x + out)


# ------------------------------------------------------------- entry points
def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Training forward: tokens (B, S) → (logits fp32 (B, S, Vp), aux 0).
    With ``cfg.remat`` each layer is recomputed in the backward pass."""
    pat = pattern(cfg)
    x = embed_tokens(params["embed"], tokens)
    pos = positions_for(tokens)
    for i in range(cfg.n_layers):
        lp = periodic_layer(params, i, len(pat))
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_train_layer, cfg, pat[i % len(pat)], lp, x, pos,
                           use_reentrant=False)
        else:
            x = _train_layer(cfg, pat[i % len(pat)], lp, x, pos)
    x = rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), torch.zeros((), device=tokens.device)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    logits, _ = forward(cfg, params, batch["tokens"])
    loss, acc = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss, "accuracy": acc}


def _empty_cache_for(cfg: ModelConfig, kind: str, batch: int, cap: int, device) -> dict:
    dt = getattr(torch, cfg.dtype)
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dt, device=device)}
    shape = (batch, cap, cfg.n_kv_heads, kernel_head_dim(cfg.resolved_head_dim))
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *, window: int = 0,
                      device) -> dict:
    """The reference's decode cache: per layer RG-LRU {"h" (B, W) fp32,
    "conv" (B, cw - 1, W)} or a local-attention ring {"k"/"v" (B, C, Hkv,
    hd), "pos" ()} of C = min(window or the config's local window, max_seq)
    slots, in the periodic layout, and the lockstep position ``pos`` ()."""
    pat = pattern(cfg)
    cap = min(window or cfg.local_attn_window, max_seq)
    layers = [_empty_cache_for(cfg, pat[i % len(pat)], batch, cap, device)
              for i in range(cfg.n_layers)]
    periods, rest = periodic_stack(layers, len(pat))
    return {"periods": periods, "rest": rest,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _run_cached(cfg: ModelConfig, params: dict, cache: dict, x: torch.Tensor, mode: str,
                window: int, paged: bool = True) -> torch.Tensor:
    """The layers over x (B, S, D) with the cache's states, in ``mode``
    "decode" (S = 1 at position ``cache["pos"]``) or "prefill" (positions
    0..S-1 from the empty cache); every state is written in place."""
    pat = pattern(cfg)
    w = window or cfg.local_attn_window
    pos = cache["pos"]
    positions = positions_for(x[..., 0]) if mode == "prefill" else None
    for i in range(cfg.n_layers):
        kind = pat[i % len(pat)]
        lp = periodic_layer(params, i, len(pat))
        lc = periodic_layer(cache, i, len(pat))
        h = rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        if kind == "rglru":
            out, new_h, new_tail = _rec_mixing(lp["mix"], h, lc)
            lc["h"].copy_(new_h)
            lc["conv"].copy_(new_tail)
        elif mode == "decode":
            out = attn.decode_attend(lp["mix"], h, {"k": lc["k"], "v": lc["v"], "pos": pos},
                                     cfg, window=w, paged=paged)
            lc["pos"].copy_(pos + 1)
        else:
            out = attn.prefill_local_attend(lp["mix"], h, positions, cfg, lc, window=w)
            lc["pos"].fill_(x.shape[1])
        x = _mlp_residual(cfg, lp, x + out)
    return rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor, *,
                window: int = 0, paged: bool = True) -> tuple[dict, torch.Tensor]:
    """One token per row: tokens (B, 1) → (cache, logits (B, Vp)); the
    cache is updated in place and ``pos`` advances. ``paged`` picks the ring
    decode kernel that skips dead pages (else the one that streams every
    slot: the same output)."""
    x = _run_cached(cfg, params, cache, embed_tokens(params["embed"], tokens), "decode",
                    window, paged)
    cache["pos"] += 1
    return cache, lm_logits(params["embed"], x, cfg)[:, 0]


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, window: int = 0,
            cache_window: int = 0) -> tuple[dict, torch.Tensor]:
    """Whole prompts (B, S) from an empty cache whose rings hold
    min(window or the config's local window, max(cache_window, S)) slots (a
    decode continuation's headroom, never more than the window) → (cache at
    pos S, logits (B, Vp) of the last position)."""
    b, s = tokens.shape
    cache = init_decode_cache(cfg, b, max(cache_window, s),
                              window=window or cfg.local_attn_window, device=tokens.device)
    x = _run_cached(cfg, params, cache, embed_tokens(params["embed"], tokens), "prefill",
                    window)
    cache["pos"].fill_(s)
    return cache, lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]
