"""Differential privacy of the uplink — the paper's §3.1 "Ensure Data
Security" (the DP half of the reference's ``core/privacy.py``).

DP-FedAvg: each cloud's update is clipped to global L2 norm ≤ C before it is
sent (norm on the ``sq_norm`` kernel, rescale on ``clip_noise`` with σ = 0,
which reads no noise); Gaussian noise N(0, (σC/n_clouds)²) is added to the
aggregate on ``clip_noise`` with scale 1. The noise comes from an explicit
``torch.Generator`` on the update's device, one draw per leaf in leaf order;
it cannot replay the reference's threefry bits, so tests hold it by its
statistics. Secure aggregation (``mask_update``, ``secure_sum``) is not on
the trainer's path and is still to port."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.optim.adamw import clip_scale
from repro_torch.utils.tree import tree_map


def clip_update(update, clip_norm: float) -> tuple[dict, torch.Tensor]:
    """Scale the whole update so its global L2 norm is ≤ clip_norm.
    Returns (clipped update, norm before clipping)."""
    sq = ops.tree_sq_norm(update)
    scale = clip_scale(sq, clip_norm)
    return tree_map(lambda x: ops.clip_noise(x, scale), update), torch.sqrt(sq)


def add_gaussian_noise(tree, generator: torch.Generator, stddev: float):
    """x + stddev·N(0, 1) per element, in fp32, cast to each leaf's dtype."""
    def noisy(x):
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=torch.float32)
        return ops.clip_noise(x, 1.0, noise, stddev)

    return tree_map(noisy, tree)


def dp_noise_stddev(clip_norm: float, noise_mult: float, n_clouds: int) -> float:
    """Std-dev of the noise added to the *average* of n clipped updates."""
    return noise_mult * clip_norm / max(n_clouds, 1)
