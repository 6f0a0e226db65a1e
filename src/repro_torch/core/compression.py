"""Cross-cloud payload compression — the paper's §3.2 (the reference's
``core/compression.py``, its non-SPMD block paths).

Two composable codecs on each cloud's update, per 256-element block of each
flattened leaf:

* ``topk`` — keep the ⌈ρ·256⌉ largest magnitudes of each block (ties at the
  threshold kept), on the ``topk_sparsify`` kernel;
* ``int8`` — symmetric int8 per block (scale = max|x|/127), quantized and
  dequantized on the ``int8_roundtrip`` kernel.

``roundtrip`` is the lossy channel (what the receiving side reconstructs);
``bytes_per_sync`` is the analytic wire size. The SPMD variants
(``topk_threshold_sparsify``, ``int8_roundtrip_rowwise``) wait for the
port's tensor-parallel slice."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils.tree import tree_leaves, tree_map

BLOCK = ops.BLOCK

METHODS = ("none", "topk", "int8", "topk+int8")


@dataclasses.dataclass(frozen=True)
class Compressor:
    method: str = "none"
    topk_ratio: float = 0.01
    block: int = BLOCK

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
            y = ops.topk_sparsify_leaf(y, self.topk_ratio)
        if "int8" in self.method:
            y = ops.int8_roundtrip_leaf(y)
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
