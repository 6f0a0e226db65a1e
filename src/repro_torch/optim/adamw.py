"""AdamW (decoupled weight decay) — the inner, per-cloud optimizer (the
reference's ``optim/adamw.py``).

State: ``{"m": tree, "v": tree, "count": int}``, moments fp32 whatever the
parameter dtype. The global gradient norm of the clip goes through the
``sq_norm`` kernel and its rescale through the ``clip_noise`` kernel
(``kernels/ops.py``). Unlike the reference, which is functional, the update
writes the parameters and moments in place, leaf by leaf: a full-width
cloud then holds one copy of its parameters and moments instead of two."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import ops
from repro_torch.utils.tree import tree_leaves, tree_map


def lr_schedule(cfg: TrainConfig, step: int) -> float:
    """Linear warmup → cosine decay to 10%, in fp32 as the reference."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    step_t = f32(step)
    warm = torch.clamp(step_t / max(cfg.warmup_steps, 1), max=1.0)
    total = max(cfg.steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step_t - cfg.warmup_steps) / total, 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(f32(math.pi) * frac))
    return (f32(cfg.lr) * warm * cos).item()


def adamw_init(params: dict) -> dict:
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "count": 0,
    }


def clip_scale(sq_norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(‖x‖, 1e-9)) as a () fp32 tensor on the norm's
    device."""
    norm = torch.sqrt(sq_norm)
    # a tensor numerator: ``float / tensor`` is a reciprocal times the float
    return torch.clamp(norm.new_tensor(max_norm) / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    sq = ops.tree_sq_norm(grads)
    scale = clip_scale(sq, max_norm)
    return tree_map(lambda g: ops.clip_noise(g, scale), grads), torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: TrainConfig, grads: dict, state: dict, params: dict,
                 lr: float | None = None) -> tuple[dict, dict]:
    """One AdamW step on fp32 ``grads``; updates ``params`` and ``state`` in
    place and returns them. Decay applies to leaves with ndim >= 2."""
    count = state["count"] + 1
    if lr is None:
        lr = lr_schedule(cfg, count)
    scale = None
    if cfg.grad_clip > 0:
        scale = clip_scale(ops.tree_sq_norm(grads), cfg.grad_clip)
    b1, b2 = cfg.beta1, cfg.beta2
    c = torch.tensor(count, dtype=torch.float32)
    bc1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** c).item()
    bc2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** c).item()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        gf = g.float() if scale is None else ops.clip_noise(g, scale).float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf.square() * (1 - b2))
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    state["count"] = count
    return params, state
