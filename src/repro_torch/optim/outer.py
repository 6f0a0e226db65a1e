"""Outer (server-side) optimizer applied to the aggregated cross-cloud
delta (the reference's ``optim/outer.py``): none (apply the aggregate, the
paper's formulas 1/2/4), sgd, or DiLoCo-style nesterov on the
pseudo-gradient w_global − w_agg."""
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
    """Move ``global_params`` toward ``aggregated`` under the outer rule."""
    if cfg.outer_optimizer == "none":
        return aggregated, state
    delta = tree_map(lambda g, a: g.float() - a.float(), global_params, aggregated)
    if cfg.outer_optimizer == "sgd":
        new = tree_map(lambda g, d: (g.float() - cfg.outer_lr * d).to(g.dtype),
                       global_params, delta)
        return new, state
    if cfg.outer_optimizer == "nesterov":
        mom = tree_map(lambda m, d: cfg.outer_momentum * m + d, state["momentum"], delta)
        new = tree_map(
            lambda g, m, d: (g.float() - cfg.outer_lr * (cfg.outer_momentum * m + d)).to(g.dtype),
            global_params, mom, delta,
        )
        return new, {"momentum": mom}
    raise ValueError(f"unknown outer optimizer {cfg.outer_optimizer!r}")
