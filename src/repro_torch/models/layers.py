"""Shared layers: RMS norm, rotary embedding, SwiGLU MLP, initializers.

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


def apply_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
