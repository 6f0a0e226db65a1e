"""Model aggregation algorithms — the paper's §3.3, formulas 1-4 (the
reference's ``core/aggregation.py``).

Stacked cloud trees carry a leading ``n_clouds`` axis on every leaf; the
trainer calls these on one leaf at a time (a bare tensor is a tree of one
leaf). Sums over clouds run in cloud order in fp32.

    formula 1 (FedAvg):      w = Σ_i (n_i / n) · w_i
    formula 2 (dynamic):     α_i = exp(−L_i) / Σ_j exp(−L_j)
    formula 3 (gradient):    w ← w − η Σ_i (n_i / n) · ∇w_i
    formula 4 (async):       w ← w + α_i (w_i − w)

``int8_wire_weighted_average`` (the reference's shard_map path) waits for
the port's tensor-parallel slice."""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map

AGGREGATORS = ("fedavg", "dynamic", "gradient", "async")


def fedavg_weights(sample_counts: torch.Tensor) -> torch.Tensor:
    """Formula 1 weights: n_i / n. sample_counts: (C,)."""
    n = sample_counts.float()
    return n / n.sum().clamp(min=1.0)


def dynamic_weights(losses: torch.Tensor, temp: float = 1.0) -> torch.Tensor:
    """Formula 2: α_i = softmax(−L_i / τ). losses: (C,)."""
    return torch.softmax(-losses.float() / temp, dim=0)


def _cloud_sum(terms) -> torch.Tensor:
    total = None
    for t in terms:
        total = t if total is None else total + t
    return total


def weighted_average(stacked, weights: torch.Tensor):
    """Σ_i weights_i · leaf_i over the leading cloud axis (fp32 accumulate),
    cast to the leaf dtype. ``stacked`` leaves: (C, ...) tensors or lists of
    C tensors."""
    def avg(x):
        out = _cloud_sum(x[i].float() * weights[i] for i in range(len(weights)))
        return out.to(x[0].dtype)

    return tree_map(avg, stacked)


def gradient_aggregate(params, stacked_grads, weights: torch.Tensor):
    """Formula 3's aggregation half: ĝ = Σ_i (n_i/n) ∇w_i; the inner
    optimizer applies w ← w − η ĝ."""
    del params  # signature kept symmetric with the other aggregators
    return weighted_average(stacked_grads, weights)


def async_update(global_params, cloud_params, alpha):
    """Formula 4: w ← w + α (w_i − w) for one arriving cloud update."""
    def upd(w, wi):
        wf = w.float()
        return (wf + alpha * (wi.float() - wf)).to(w.dtype)

    return tree_map(upd, global_params, cloud_params)


def masked_async_update(global_params, stacked_params, alphas: torch.Tensor,
                        arrived: torch.Tensor):
    """Batched formula 4: w += Σ_i arrived_i · α_i (w_i − w), the clouds
    whose update arrived this round each with its staleness-discounted α_i.
    ``stacked_params`` leaves: (C, ...) tensors or lists of C tensors."""
    a = alphas.float() * arrived.float()

    def upd(w, wi):
        wf = w.float()
        contrib = _cloud_sum(a[i] * (wi[i].float() - wf) for i in range(len(a)))
        return (wf + contrib).to(w.dtype)

    return tree_map(upd, global_params, stacked_params)
