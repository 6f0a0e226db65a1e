"""Flash-decode over per-row contiguous rings on the card: wrapper of
``csrc/swa_decode.cu``.

Replaces the TPU kernel ``repro/kernels/swa_decode.py::swa_decode``: one
query token per row attends over every slot of its ring (B, C, Hkv, hd)
with the ring-validity mask and an optional window. Plain version:
``ref.swa_decode_ref``; ``paged_decode.paged_decode_ring`` is the variant
that skips dead pages (bitwise the same output); both run the split-KV
body over ranges of ``paged_decode.split_len(C, hd)`` slots."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import check_ring, partials


def swa_decode(
    q: torch.Tensor,    # (B, Hkv, G, hd)
    k: torch.Tensor,    # (B, C, Hkv, hd)
    v: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32
    window: int = 0,
    scale: float | None = None,  # None: hd**-0.5
) -> torch.Tensor:
    b, cap, hkv, g, hd = check_ring("swa_decode", q, k, v, pos)
    part, split = partials(q, cap)
    out = torch.empty_like(q)
    build.launch(
        "swa_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part.data_ptr(), out.data_ptr(), build.dtype_code(q), b, cap, hkv, g, hd, window,
        split, hd**-0.5 if scale is None else scale,
    )
    return out
