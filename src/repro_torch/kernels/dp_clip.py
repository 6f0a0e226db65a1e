"""The DP transmit transform on the card: wrappers of ``csrc/dp_clip.cu``.

Replace the TPU kernels ``repro/kernels/dp_clip.py::sq_norm`` (Σx² of a
tensor, in two deterministic passes) and ``::clip_noise`` (x·scale +
σ·noise, fused). Plain versions: ``ref.sq_norm_ref`` and
``ref.clip_noise_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

CHUNK = 2048  # elements per partial sum of the first pass


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """x: contiguous float32 or bfloat16, any shape → () float32 Σx²,
    accumulated in fp32."""
    build.check_cuda("sq_norm", x=x)
    n = x.numel()
    partials = torch.empty(-(-n // CHUNK), dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    build.launch("sq_norm", x.data_ptr(), partials.data_ptr(), out.data_ptr(), n,
                 build.dtype_code(x))
    return out


def clip_noise(x: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor | None = None,
               stddev: float = 0.0) -> torch.Tensor:
    """x·scale + stddev·noise in fp32, cast to x's dtype. x: contiguous
    float32 or bfloat16; scale: () float32 on x's device; noise: float32 of
    x's shape, or None (then stddev must be 0 and no noise is read)."""
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise TypeError("clip_noise: scale must be one float32 element")
    if noise is None:
        if stddev != 0.0:
            raise ValueError("clip_noise: stddev != 0 needs a noise tensor")
        build.check_cuda("clip_noise", x=x, scale=scale)
    else:
        build.check_cuda("clip_noise", x=x, scale=scale, noise=noise)
        if noise.dtype != torch.float32 or noise.shape != x.shape:
            raise ValueError(f"clip_noise: noise {noise.dtype} {tuple(noise.shape)} must be "
                             f"float32 of x's shape {tuple(x.shape)}")
    out = torch.empty_like(x)
    build.launch("clip_noise", x.data_ptr(), scale.data_ptr(),
                 None if noise is None else noise.data_ptr(), out.data_ptr(), x.numel(),
                 stddev, build.dtype_code(x))
    return out
