"""Shared layers: RMS norm, LayerNorm, rotary embedding, the gated MLP
(SwiGLU, GeGLU) and the plain two-matrix GELU MLP, the training loss,
initializers.

Plain functions on tensors with the reference package's conventions:
parameters are dicts of tensors, layer math runs in the model dtype with
fp32 inside the norm statistics and the rotation."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def he_init(shape, dtype, generator, device, fan_in: int | None = None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2]
    std = (2.0 / max(fan, 1)) ** 0.5
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


def embed_init(shape, dtype, generator, device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Scale stored as (1 + scale): zero-initialized scales are identity."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with a bias: fp32 mean and variance, ``rsqrt(var + eps)``,
    cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding in fp32. x: (..., S, H, hd); positions:
    (..., S)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * inv_freq        # (..., S, hd/2)
    angles = angles[..., :, None, :]                          # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default is
    the exact erf form, which differs from it by up to ~1e-3)."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The gated MLP where ``params`` has ``w_gate``: (act(x @ w_gate) *
    (x @ w_up)) @ w_down, SwiGLU for ``act == "silu"``, GeGLU (tanh GELU)
    for "gelu". Else the plain MLP with biases (whisper's): gelu(x @ w_up +
    b_up) @ w_down + b_down."""
    if "w_gate" in params:
        act_fn = F.silu if act == "silu" else gelu
        return (act_fn(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    return gelu(x @ params["w_up"] + params["b_up"]) @ params["w_down"] + params["b_down"]


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-mean cross entropy and top-1 accuracy. logits fp32 (B, S, V)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    acc = (logits.argmax(dim=-1) == labels.long()).float()
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / denom, (acc * mask).sum() / denom
