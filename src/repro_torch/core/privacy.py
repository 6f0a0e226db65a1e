"""Data security of the uplink — the paper's §3.1 "Ensure Data Security"
(the reference's ``core/privacy.py``). Two mechanisms:

* **Differential privacy (DP-FedAvg)**: each cloud's update is clipped to
  global L2 norm ≤ C before it is sent (norm on the ``sq_norm`` kernel,
  rescale on ``clip_noise`` with σ = 0, which reads no noise); Gaussian
  noise N(0, (σC/n_clouds)²) is added to the aggregate on ``clip_noise``
  with scale 1. The noise comes from an explicit ``torch.Generator`` on the
  update's device, one draw per leaf in leaf order; it cannot replay the
  reference's threefry bits, so tests hold it by its statistics.

* **Secure aggregation**: Bonawitz-style pairwise additive masking in
  fixed-point int32 arithmetic. Cloud i adds Σ_{j>i} PRF(i,j) − Σ_{j<i}
  PRF(j,i); the masks cancel exactly in the wraparound int32 sum, so the
  server learns only Σ_i update_i. The PRF of a pair is a ``torch.Generator``
  on the update's device, seeded from (0x5EC0, round, lo·100003 + hi), that
  draws one int32 mask per leaf in leaf order: the port's own bits (torch
  cannot replay threefry), which cancel all the same, so ``secure_aggregate``
  equals the reference's bit for bit. Both clouds of a pair must draw on the
  same kind of device. ``to_fixed`` saturates as XLA's float-to-int32
  conversion does (NaN → 0, values beyond the int32 range → its ends),
  explicitly, since PyTorch leaves an out-of-range cast undefined."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.optim.adamw import clip_scale
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

FIXED_POINT_SCALE = 2.0**16
_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1
_F32_BELOW_2_31 = 2.0**31 - 128     # the largest float32 below 2**31


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


# ------------------------------------------------------- secure aggregation
def _saturating_int32(r: torch.Tensor) -> torch.Tensor:
    """float32 → int32 as XLA converts: NaN → 0, at or beyond the ends of
    the int32 range → those ends, the same on the CPU and the card. float32
    cannot hold 2**31 − 1, so the clamp stops at 2**31 − 128 and what lies
    at or above 2**31 is set afterwards."""
    over = r >= 2.0**31
    q = torch.nan_to_num(r, nan=0.0).clamp_(_INT32_MIN, _F32_BELOW_2_31).to(torch.int32)
    return q.masked_fill_(over, _INT32_MAX)


def to_fixed(tree):
    """round(x · 2**16) as int32, saturating."""
    return tree_map(lambda x: _saturating_int32(torch.round(x.float() * FIXED_POINT_SCALE)),
                    tree)


def from_fixed(tree, dtype):
    return tree_map(lambda x: (x.float() / FIXED_POINT_SCALE).to(dtype), tree)


def _pair_generator(round_idx, lo: int, hi: int, device) -> torch.Generator:
    """The PRF of clouds lo < hi in one round: a generator on ``device``
    seeded deterministically from (0x5EC0, round, lo·100003 + hi)."""
    seed = np.random.SeedSequence([0x5EC0, int(round_idx), lo * 100_003 + hi])
    return torch.Generator(device=device).manual_seed(int(seed.generate_state(1, np.uint64)[0]))


def mask_update(update_fixed, cloud_idx: int, n_clouds: int, round_idx):
    """Additive pairwise masks in wraparound int32: what cloud i transmits.
    One mask leaf at a time is drawn, over [int32 min, int32 max)."""
    leaves = tree_leaves(update_fixed)
    masked = [x.clone() for x in leaves]
    for j in range(n_clouds):
        if j == cloud_idx:
            continue
        lo, hi = min(cloud_idx, j), max(cloud_idx, j)
        gen = _pair_generator(round_idx, lo, hi, leaves[0].device)
        for m in masked:
            mask = torch.randint(_INT32_MIN, _INT32_MAX, m.shape, generator=gen,
                                 dtype=torch.int32, device=m.device)
            if cloud_idx < j:
                m.add_(mask)
            else:
                m.sub_(mask)
    return tree_unflatten(update_fixed, masked)


def secure_sum(masked_updates: list):
    """Σ_i masked_i in wraparound int32: the masks cancel exactly; returns
    the fixed-point sum."""
    out = [x.clone() for x in tree_leaves(masked_updates[0])]
    for m in masked_updates[1:]:
        for a, b in zip(out, tree_leaves(m)):
            a.add_(b)
    return tree_unflatten(masked_updates[0], out)


def secure_aggregate(updates: list, round_idx, dtype=torch.float32):
    """End to end: fixed-point lift → mask → sum → unmask by cancellation."""
    n = len(updates)
    masked = [mask_update(to_fixed(u), i, n, round_idx) for i, u in enumerate(updates)]
    return from_fixed(secure_sum(masked), dtype)
