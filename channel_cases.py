"""Inputs and planted faults that the uplink channel's block kernels
(``topk_sparsify``, ``int8_roundtrip``) are checked on, beside their plain
versions in ``repro_torch/kernels/ref.py``. ``chip_smoke.py`` (beside this
module) and the tests share them; the port itself never imports them.

The sync's real update is not continuous data: each leaf is the difference
of two bf16 parameter leaves, times one clip scale, so its magnitudes sit
on a coarse grid and tie within a block (``bf16_grid_update``). The edge
blocks (``plant_edge_blocks``) add what a leaf of such updates also holds:
blocks that are all zeros, blocks with fewer nonzeros than k, and int8
values at exact half steps of the scale."""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

BLOCK = ref.BLOCK
HALF_STEP = 2.0**-10  # the scale of the half-step blocks: every quotient exact


def bf16_grid_update(p: torch.Tensor, g: torch.Tensor, lr: float = 1e-3,
                     clip: float = 0.37) -> torch.Tensor:
    """An update as the sync makes one: parameters ``p`` rounded to bf16,
    moved by lr·sign(g) and rounded to bf16 again; the fp32 difference of
    the two, times the clip scale ``clip``."""
    before = p.bfloat16().float()
    after = (before + lr * torch.sign(g)).bfloat16().float()
    return (after - before) * torch.tensor(clip, dtype=torch.float32, device=p.device)


def plant_edge_blocks(x: torch.Tensor) -> torch.Tensor:
    """A copy of the flat fp32 ``x`` whose whole 256-element blocks j hold,
    by j mod 8: 0, all zeros; 1, one nonzero (offset 100); 2, two nonzeros
    (offsets 7 and 200); 3, int8 half steps: offset 0 zero, offsets 1-254
    (m + 0.5)·s for m in -127..126, offset 255 ±127·s, with s = 2**-10, so
    the block's int8 scale is s and every x / s is exact. The rest stay.
    The patterns keep their kind in a view one element on (``flat[1:]``)."""
    y = x.reshape(-1).clone()
    nb = y.numel() // BLOCK
    rows = y[: nb * BLOCK].view(nb, BLOCK)
    j = torch.arange(nb, device=y.device)
    col = torch.arange(BLOCK, device=y.device)
    kind = j % 8
    rows[kind <= 2] = 0.0
    one = (kind == 1).nonzero().squeeze(1)
    rows[one, 100] = 3.0 * HALF_STEP * (1 - 2 * (one % 2)).float()
    two = (kind == 2).nonzero().squeeze(1)
    rows[two, 7] = 5.0 * HALF_STEP
    rows[two, 200] = -2.0 * HALF_STEP
    half = (kind == 3).nonzero().squeeze(1)
    m = (half[:, None] * 37 + col[None, :] * 11) % 254 - 127
    vals = (m.float() + 0.5) * HALF_STEP
    vals[:, 0] = 0.0
    vals[:, BLOCK - 1] = 127.0 * HALF_STEP * (1 - 2 * (half % 2)).float()
    rows[half] = vals
    return y.view(x.shape)


def tie_stats(x: torch.Tensor, k: int) -> dict[str, float]:
    """Per 256-element block of the flat tensor (the ragged last one
    zero-padded): the share of blocks whose k-th magnitude is tied (another
    element has it too), of blocks that are all zeros, of blocks with fewer
    than k nonzeros, and the mean number of rounds the kernel's threshold
    search takes (the distinct magnitudes among the top k)."""
    mag = ref._blocks(x).abs()
    top = torch.topk(mag, k, dim=1).values
    kth = top[:, -1:]
    nonzero = (mag > 0).sum(dim=1)
    return {
        "blocks": mag.shape[0],
        "kth_tied": ((mag == kth).sum(dim=1) >= 2).float().mean().item(),
        "all_zero": (nonzero == 0).float().mean().item(),
        "under_k_nonzero": (nonzero < k).float().mean().item(),
        "rounds": (1 + (top[:, 1:] != top[:, :-1]).sum(dim=1)).float().mean().item(),
    }


# ------------------------------------------------------------ planted faults
def topk_exact_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k that keeps exactly k per block (``torch.topk``'s indices
    scattered), where the kernel keeps every tie at the threshold."""
    rows = ref._blocks(x)
    idx = torch.topk(rows.abs(), k, dim=1).indices
    kept = torch.zeros_like(rows).scatter_(1, idx, rows.gather(1, idx))
    return ref._unblocks(kept, x)


def topk_short(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k keeping k - 1 per block."""
    return ref.topk_sparsify_ref(x, k - 1)


def _int8(x: torch.Tensor, divisor: float, rnd) -> torch.Tensor:
    rows = ref._blocks(x)
    amax = rows.abs().amax(dim=1, keepdim=True)
    scale = (amax / amax.new_tensor(divisor)).clamp(min=1e-12)
    return ref._unblocks(rnd(rows / scale).clamp(-127, 127) * scale, x)


def int8_half_away(x: torch.Tensor) -> torch.Tensor:
    """The int8 roundtrip rounding half away from zero, not half to even."""
    return _int8(x, 127.0, lambda q: torch.sign(q) * torch.floor(q.abs() + 0.5))


def int8_div128(x: torch.Tensor) -> torch.Tensor:
    """The int8 roundtrip with 128 in place of 127 in the scale."""
    return _int8(x, 128.0, torch.round)
