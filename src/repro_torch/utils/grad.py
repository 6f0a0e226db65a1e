"""Loss and fp32 gradients of a batch, optionally accumulated over
microbatches (the reference's ``microbatched_value_and_grad``).

As in the reference, the gradient is taken with respect to the parameters
in their own dtype (bf16 at full width) and then cast to fp32; with k
microbatches the fp32 gradients are summed and divided by k, and the loss
and metrics are microbatch means. The sum and the division run in place on
the first microbatch's gradient tree (the same adds in the same order as
the reference's ``tree_map``, so the same bits), so k > 1 holds one fp32
gradient tree and one microbatch's beside it, not a new tree per add."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(tracked, batch)
        grads = list(torch.autograd.grad(loss, live))
    metrics = {k: v.detach() for k, v in metrics.items()}
    # cast leaf by leaf, dropping each param-dtype gradient once copied
    out = []
    for i in range(len(grads)):
        out.append(grads[i].float())
        grads[i] = None
    it = iter(out)
    return (loss.detach(), metrics), tree_map(lambda _: next(it), params)


def microbatched_value_and_grad(loss_fn: Callable, params: dict, batch: dict,
                                microbatches: int = 1):
    """loss_fn(params, batch) -> (loss, metrics dict). Returns ((loss,
    metrics), grads) with grads fp32, shaped like params."""
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch)
    k = microbatches
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by {k} microbatches")
    acc = losses = None
    metrics_sum: dict = {}
    for j in range(k):
        mb = {key: v[j * (b // k):(j + 1) * (b // k)] for key, v in batch.items()}
        (loss, metrics), g = _value_and_grad(loss_fn, params, mb)
        if acc is None:
            acc = g
        else:
            for a, x in zip(tree_leaves(acc), tree_leaves(g)):
                a.add_(x)
            del g
        losses = loss if losses is None else losses + loss
        for key, v in metrics.items():
            metrics_sum[key] = v if key not in metrics_sum else metrics_sum[key] + v
    for a in tree_leaves(acc):
        a.div_(k)
    return (losses / k, {key: v / k for key, v in metrics_sum.items()}), acc
