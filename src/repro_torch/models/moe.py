"""Mixture-of-Experts FFN: top-k routing with grouped, capacity-bounded
dispatch (the reference's ``models/moe.py``, GShard/Switch style).

Tokens are cut into groups of 256, 128 or 64 (else the whole batch is one
group); each expert takes at most C = ceil(cf · gs · k / E) tokens per
group, slots handed out choice level by choice level (every token's first
choice before any second choice) and in token order within a level; a
choice past capacity is dropped. The router runs in fp32 (softmax, then k
iterative argmaxes, first index on ties), the top-k weights are
renormalised with a 1e-9 floor, and the Switch load-balance loss E·<f, p>
comes from the top-1 fractions.

The reference builds a (g, n, k, E, C) one-hot of the slots and sums it
over k. A token chooses each expert at most once, so that sum is the
one-hot of the one slot the token holds at the expert (if kept): the port
builds the (g, n, E) slot and weight of each (token, expert) and expands
them once, to the (g, n, E, C) dispatch and combine tensors. Every shape
is static and nothing reads back to the host (no ``nonzero``, no boolean
indexing), so a serving dispatch through the MoE layer is captured in a
CUDA graph like a dense one. The expert products are plain batched matrix
products, as the reference leaves them to XLA.

A token's output depends on the other tokens of its group (they compete
for capacity), so the serving engine must hand the layer the rows the
reference engine hands it, padding included."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import he_init
from repro_torch.models.transformer import FFNHooks


def init_moe(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Stacked (L, ...) expert leaves: the fp32 router (d, E), ``w_gate``
    and ``w_up`` (E, d, f), ``w_down`` (E, f, d), at the reference's He
    scales."""
    dt = getattr(torch, cfg.dtype)
    e, d, f, L = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
    return {
        "router": he_init((L, d, e), torch.float32, generator, device),
        "w_gate": he_init((L, e, d, f), dt, generator, device, fan_in=d),
        "w_up": he_init((L, e, d, f), dt, generator, device, fan_in=d),
        "w_down": he_init((L, e, f, d), dt, generator, device, fan_in=f),
    }


def _group_size(n_tokens: int) -> int:
    for gs in (256, 128, 64):
        if n_tokens % gs == 0 and n_tokens >= gs:
            return gs
    return n_tokens


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    c = cfg.capacity_factor * group_tokens * cfg.experts_per_token / cfg.n_experts
    return max(1, int(math.ceil(c)))


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """One-hot by comparison (no host check of the indices)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_iterative(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by k argmaxes, each taking the first maximal index, the chosen
    expert masked to -inf before the next: (weights (..., k), ids (...,
    k))."""
    p = probs
    ws, ids = [], []
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        ws.append(p.gather(-1, i[..., None])[..., 0])
        ids.append(i)
        p = p.masked_fill(_one_hot(i, p.shape[-1], torch.bool), -math.inf)
    return torch.stack(ws, dim=-1), torch.stack(ids, dim=-1)


def route(params: dict, xf: torch.Tensor, cfg: ModelConfig, aux: bool = True):
    """Routing of grouped tokens xf (g, n, D): (slot (g, n, E) int64, the
    token's slot at each expert; kept (g, n, E) f32, 1 where the token
    holds a slot there; weight (g, n, E) f32, its renormalised router
    weight where kept; the Switch loss, None unless ``aux``)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    c = capacity(cfg, xf.shape[1])
    logits = xf.float() @ params["router"].float()                   # (g, n, E)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = _topk_iterative(probs, k)                         # (g, n, k)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    loss = None
    if aux:
        f_e = _one_hot(idx[..., 0], e).mean(dim=(0, 1))              # top-1 fractions
        loss = e * torch.sum(f_e * probs.mean(dim=(0, 1)))

    # slots before each choice, counted choice level by level (j-major)
    mask = _one_hot(idx, e)                                          # (g, n, k, E)
    g, n = xf.shape[:2]
    mask_jm = mask.transpose(1, 2).reshape(g, k * n, e)
    pos = (torch.cumsum(mask_jm, dim=1) - mask_jm).reshape(g, k, n, e).transpose(1, 2)
    keep = (pos < c).float() * mask                                  # (g, n, k, E)
    # at most one choice per (token, expert): the sums over k pick it out
    kept = keep.sum(dim=2)
    slot = (pos * keep).sum(dim=2).long()
    weight = (weights[..., None] * keep).sum(dim=2)
    return slot, kept, weight, loss


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, aux: bool = True):
    """x (B, S, D) → (out (B, S, D), load-balance aux loss (); None unless
    ``aux``)."""
    b, s, d = x.shape
    e = cfg.n_experts
    t = b * s
    gs = _group_size(t)
    g = t // gs
    c = capacity(cfg, gs)
    xf = x.reshape(g, gs, d)
    slot, kept, weight, loss = route(params, xf, cfg, aux)
    # (g, n, E, C): the one-hot of each kept (token, expert)'s slot
    dispatch = _one_hot(slot, c) * kept[..., None]
    combine = dispatch * weight[..., None]

    # expert_in[e, g, c] = the token in slot c of expert e in group g (or 0)
    expert_in = torch.einsum("gnec,gnd->egcd", dispatch.to(x.dtype), xf)
    h_in = expert_in.reshape(e, g * c, d)
    gate = torch.bmm(h_in, params["w_gate"])
    up = torch.bmm(h_in, params["w_up"])
    out_e = torch.bmm(F.silu(gate) * up, params["w_down"]).reshape(e, g, c, d)
    out = torch.einsum("gnec,egcd->gnd", combine.to(x.dtype), out_e)
    return out.reshape(b, s, d), loss


MOE_FFN = FFNHooks(init_moe, apply_moe)
