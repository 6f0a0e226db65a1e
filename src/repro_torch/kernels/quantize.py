"""Per-block int8 quantize -> dequantize on the card: wrapper of
``csrc/quantize.cu``.

Replaces the TPU kernel ``repro/kernels/quantize.py::int8_roundtrip``: each
256-element block of the flat tensor is quantized to symmetric int8 with
scale max(max|x| / 127, 1e-12) and dequantized. Plain version:
``ref.int8_roundtrip_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """x: contiguous float32, any shape (taken as flat 256-element blocks,
    the last one ragged) → same shape and dtype."""
    build.check_cuda("int8_roundtrip", x=x)
    if x.dtype != torch.float32:
        raise TypeError(f"int8_roundtrip: takes float32, got {x.dtype}")
    out = torch.empty_like(x)
    build.launch("int8_roundtrip", x.data_ptr(), out.data_ptr(), x.numel())
    return out
