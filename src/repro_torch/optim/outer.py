"""Outer (server-side) optimizer applied to the aggregated cross-cloud
delta (the reference's ``optim/outer.py``): none (apply the aggregate, the
paper's formulas 1/2/4), sgd, or DiLoCo-style nesterov on the
pseudo-gradient w_global − w_agg. The momentum is updated in place."""
from __future__ import annotations

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.utils.tree import tree_map


def outer_init(cfg: FederatedConfig, params: dict) -> dict:
    if cfg.outer_optimizer == "nesterov":
        return {"momentum": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                     params)}
    return {}


def outer_update(cfg: FederatedConfig, global_params: dict, aggregated: dict,
                 state: dict) -> tuple[dict, dict]:
    """Move ``global_params`` toward ``aggregated`` under the outer rule.
    Leaf by leaf: the pseudo-gradient d = w_global − w_agg of one leaf at a
    time, and nesterov's momentum updated in place (μ·m, then + d: the
    reference's operations in its order), so no fp32 tree of d or of the
    new momentum is built beside the old one."""
    if cfg.outer_optimizer == "none":
        return aggregated, state
    lr, mu = cfg.outer_lr, cfg.outer_momentum
    if cfg.outer_optimizer == "sgd":
        return tree_map(lambda g, a: (g.float() - lr * (g.float() - a.float())).to(g.dtype),
                        global_params, aggregated), state
    if cfg.outer_optimizer == "nesterov":
        def step(g, a, m):
            d = g.float() - a.float()
            m.mul_(mu).add_(d)
            return (g.float() - lr * (mu * m + d)).to(g.dtype)

        return tree_map(step, global_params, aggregated, state["momentum"]), state
    raise ValueError(f"unknown outer optimizer {cfg.outer_optimizer!r}")
