"""Model aggregation algorithms — the paper's §3.3, formulas 1-4 (the
reference's ``core/aggregation.py``).

Stacked cloud trees carry a leading ``n_clouds`` axis on every leaf; the
trainer calls these on one leaf at a time (a bare tensor is a tree of one
leaf). Sums over clouds run in cloud order in fp32.

    formula 1 (FedAvg):      w = Σ_i (n_i / n) · w_i
    formula 2 (dynamic):     α_i = exp(−L_i) / Σ_j exp(−L_j)
    formula 3 (gradient):    w ← w − η Σ_i (n_i / n) · ∇w_i
    formula 4 (async):       w ← w + α_i (w_i − w)

``int8_wire_weighted_average`` is formula 1 in pod mode with the payload
carried to the combining device as int8 rows plus fp32 row scales."""
from __future__ import annotations

import torch

from repro_torch.core.compression import int8_quantize_rows
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


# a leaf whose pod-local slice (1, ...) has at most 1 dim, or at most this
# many elements over all pods, crosses the wire dense (fp32)
WIRE_DENSE_MAX = 8192


def int8_wire_weighted_average(stacked, weights: torch.Tensor, pod_axis: str = "pod",
                               mesh=None):
    """Formula 1 across the pods of ``mesh`` with the payload carried as
    int8. ``stacked`` leaves are lists of C tensors, cloud c's on pod
    device c (``mesh.devices[c]``). Each pod quantizes its own leaf per
    last-dim row on its device (``compression.int8_quantize_rows``); the
    int8 q and the fp32 row scales move to the combining device (the first
    pod's), are dequantized there and summed in cloud order in fp32: 4x
    fewer bytes than the fp32 payload. A leaf whose pod-local slice (1, ...)
    has at most 1 dim (a scalar) or at most ``WIRE_DENSE_MAX`` elements over
    all pods moves dense. Returns fp32 leaves on the combining device.
    The reference's ``shard_specs`` (the intra-pod placement of each leaf)
    has no counterpart: the port's pods are one device each."""
    if mesh is None:
        raise ValueError("int8_wire_weighted_average needs the pod mesh")
    n_pods = int(dict(mesh.shape).get(pod_axis, 1))
    dev = mesh.devices[0]

    def leaf(xs):
        if xs[0].ndim == 0 or xs[0].numel() * n_pods <= WIRE_DENSE_MAX:
            return _cloud_sum(weights[i] * x.to(dev).float() for i, x in enumerate(xs))
        terms = []
        for i, x in enumerate(xs):
            q, scale = int8_quantize_rows(x)
            terms.append(weights[i] * (q.to(dev).float() * scale.to(dev)))
        return _cloud_sum(terms)

    return tree_map(leaf, stacked)
