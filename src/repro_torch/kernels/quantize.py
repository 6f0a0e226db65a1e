"""Per-row symmetric int8 on the card: wrappers of ``csrc/quantize.cu``.

``int8_roundtrip`` replaces the TPU kernel ``repro/kernels/quantize.py::
int8_roundtrip``: each 256-element block of the flat tensor is quantized to
symmetric int8 with scale max(max|x| / 127, 1e-12) and dequantized. Plain
version: ``ref.int8_roundtrip_ref``.

``int8_encode`` replaces ``quantize.py::int8_encode``: the same row math,
keeping (q int8, scale f32), over rows of R in {32, 64, 128, 256} (a head
row of the int8 KV pool, or a 256-element uplink block). Plain version:
``ref.int8_encode_ref``."""
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


ROW_LENGTHS = (32, 64, 128, 256)


def int8_encode(x: torch.Tensor, row_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x: contiguous float32 or bfloat16, taken as flat rows of ``row_len``
    elements (the last one may be ragged: its missing elements count as
    zeros) → (q int8 (rows, row_len), scale float32 (rows,))."""
    build.check_cuda("int8_encode", x=x)
    if row_len not in ROW_LENGTHS:
        raise ValueError(f"int8_encode: rows of {ROW_LENGTHS} elements, got {row_len}")
    n = x.numel()
    rows = -(-n // row_len)
    q = torch.empty((rows, row_len), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    build.launch("int8_encode", x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, row_len, n,
                 build.dtype_code(x))
    return q, scale
