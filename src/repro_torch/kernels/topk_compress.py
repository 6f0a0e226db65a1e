"""Block-local magnitude top-k on the card: wrapper of
``csrc/topk_compress.cu``.

Replaces the TPU kernel ``repro/kernels/topk_compress.py::topk_sparsify``:
in each 256-element block of the flat tensor, every entry whose magnitude is
at least the block's k-th largest (counted with multiplicity) is kept, the
rest are zeroed; ties are kept. Plain version: ``ref.topk_sparsify_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCK = 256


def topk_sparsify(x: torch.Tensor, k: int) -> torch.Tensor:
    """x: contiguous float32, any shape (taken as flat 256-element blocks,
    the last one ragged); 1 <= k <= 256 → same shape and dtype."""
    build.check_cuda("topk_sparsify", x=x)
    if x.dtype != torch.float32:
        raise TypeError(f"topk_sparsify: takes float32, got {x.dtype}")
    if not 1 <= k <= BLOCK:
        raise ValueError(f"topk_sparsify: k={k} outside 1..{BLOCK}")
    out = torch.empty_like(x)
    build.launch("topk_sparsify", x.data_ptr(), out.data_ptr(), x.numel(), k)
    return out
