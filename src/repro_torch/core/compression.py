"""Cross-cloud payload compression — the paper's §3.2 (the reference's
``core/compression.py``).

Two composable codecs on each cloud's update, per 256-element block of each
flattened leaf:

* ``topk`` — keep the ⌈ρ·256⌉ largest magnitudes of each block (ties at the
  threshold kept), on the ``topk_sparsify`` kernel;
* ``int8`` — symmetric int8 per block (scale = max|x|/127), quantized and
  dequantized on the ``int8_roundtrip`` kernel.

``Compressor(spmd=True)``, the pod-mode trainer's channel, takes the
reference's SPMD variants instead, plain torch on the leaf's device as the
reference's are plain ``jnp``: ``topk_threshold_sparsify`` (per-leaf top-k
by a 16-step bisection of the threshold, no sort) and
``int8_roundtrip_rowwise`` (int8 per last-dim row).

``roundtrip`` is the lossy channel (what the receiving side reconstructs);
``bytes_per_sync`` is the analytic wire size."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils.tree import tree_leaves, tree_map

BLOCK = ops.BLOCK

METHODS = ("none", "topk", "int8", "topk+int8")


def topk_threshold_sparsify(x: torch.Tensor, ratio: float, iters: int = 16) -> torch.Tensor:
    """Per-leaf magnitude top-k by bisection of the threshold: keep
    |x| >= lo, where lo comes out of ``iters`` halvings of [0, max|x|] that
    keep count(|x| >= lo) >= k = max(1, round(ρ·n)) (ties and the last gap
    keep slightly more than k). Every step stays on x's device (no host
    read). The midpoints are float32, as in the reference, whose count is a
    float32 sum, exact only up to 2**24 elements; here the count is an
    integer, exact at any size."""
    xf = x.float()
    mag = xf.abs()
    k = max(1, round(ratio * x.numel()))
    lo = torch.zeros((), dtype=torch.float32, device=x.device)
    hi = mag.max()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = (mag >= mid).sum() > k
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    return torch.where(mag >= lo, xf, torch.zeros((), device=x.device)).to(x.dtype)


def int8_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per last-dim row: (q int8, scale fp32 (..., 1)), scale
    = max|row|/127 (at least 1e-12), q = clamp(round(x/scale), ±127),
    rounded half to even. Both quotients divide by a tensor, IEEE-exact
    (PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / amax.new_tensor(127.0)).clamp(min=1e-12)
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int8_roundtrip_rowwise(x: torch.Tensor) -> torch.Tensor:
    """``int8_quantize_rows`` then dequantized, in x's dtype."""
    q, scale = int8_quantize_rows(x)
    return (q.float() * scale).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Compressor:
    method: str = "none"
    topk_ratio: float = 0.01
    block: int = BLOCK
    spmd: bool = False    # pod mode: threshold-select top-k, row-wise int8

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown compression {self.method!r}; known {METHODS}")
        if self.block != BLOCK:
            raise ValueError(f"block {self.block}: the channel kernels use blocks of {BLOCK}")

    def roundtrip_leaf(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "none" or x.ndim == 0:
            return x
        y = x
        if "topk" in self.method:
            y = (topk_threshold_sparsify(y, self.topk_ratio) if self.spmd
                 else ops.topk_sparsify_leaf(y, self.topk_ratio))
        if "int8" in self.method:
            y = int8_roundtrip_rowwise(y) if self.spmd else ops.int8_roundtrip_leaf(y)
        return y

    def roundtrip(self, tree):
        """The lossy channel: what the receiving side reconstructs."""
        return tree_map(self.roundtrip_leaf, tree)

    # ----------------------------------------------------- wire accounting
    def bytes_per_leaf(self, shape, dtype) -> int:
        n = int(np.prod(shape)) if shape else 1
        nb = -(-n // self.block)
        raw = n * torch.empty((), dtype=dtype).element_size()
        if self.method == "none":
            return int(raw)
        if self.method == "topk":
            k = max(1, int(round(self.topk_ratio * self.block)))
            # per kept entry: bf16 value + u8 in-block index; + u16 block bitmap len
            return int(nb * k * (2 + 1) + nb * 2)
        if self.method == "int8":
            return int(n * 1 + nb * 4)  # q values + fp32 scale per block
        if self.method == "topk+int8":
            k = max(1, int(round(self.topk_ratio * self.block)))
            return int(nb * k * (1 + 1) + nb * (4 + 2))
        raise AssertionError

    def bytes_per_sync(self, tree) -> int:
        """Uplink bytes for one cloud's update under this codec."""
        return sum(self.bytes_per_leaf(tuple(x.shape), x.dtype) for x in tree_leaves(tree))

    def compression_ratio(self, tree) -> float:
        raw = sum(x.numel() * x.element_size() for x in tree_leaves(tree))
        return raw / max(self.bytes_per_sync(tree), 1)
