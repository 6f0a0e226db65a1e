"""Per-row symmetric int8 on the card: wrappers of ``csrc/quantize.cu``.

``int8_roundtrip`` replaces the TPU kernel ``repro/kernels/quantize.py::
int8_roundtrip``: each 256-element block of the flat tensor is quantized to
symmetric int8 with scale max(max|x| / 127, 1e-12) and dequantized. Plain
version: ``ref.int8_roundtrip_ref``.

``int8_encode`` replaces ``quantize.py::int8_encode``: the same row math,
keeping (q int8, scale f32), over flat rows of 256 elements (the uplink
leaf's blocks: ``ops.int8_encode_leaf``). Plain version:
``ref.int8_encode_ref``.

``kv_write_int8`` replaces the same TPU kernel at the int8 KV pool's
writes (the reference's decode write and its masked requantized prefill
write): one launch per layer quantizes K and V per token per kv head and
stores q and the scale in each live token's page slot, with the slots
worked out on the card. Plain version: ``ref.kv_write_int8_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import HEAD_DIMS


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """x: contiguous float32, any shape (taken as flat 256-element blocks,
    the last one ragged) → same shape and dtype."""
    build.check_cuda("int8_roundtrip", x=x)
    if x.dtype != torch.float32:
        raise TypeError(f"int8_roundtrip: takes float32, got {x.dtype}")
    out = torch.empty_like(x)
    build.launch("int8_roundtrip", x.data_ptr(), out.data_ptr(), x.numel())
    return out


ROW = 256


def int8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: contiguous float32 or bfloat16, taken as flat rows of 256
    elements (the last one may be ragged: its missing elements count as
    zeros) → (q int8 (rows, 256), scale float32 (rows,))."""
    build.check_cuda("int8_encode", x=x)
    n = x.numel()
    rows = -(-n // ROW)
    q = torch.empty((rows, ROW), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    build.launch("int8_encode", x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, n,
                 build.dtype_code(x))
    return q, scale


def _token_strides(key: str, t: torch.Tensor, hd: int, device: torch.device) -> tuple[int, int]:
    """(row, token) strides in elements of k or v (n, S, Hkv, hd): each
    token's Hkv·hd elements contiguous, every token row 16 bytes aligned,
    as the kernel's 16-byte loads need, and t on the pool's CUDA device;
    raise otherwise."""
    if t.stride(3) != 1 or (t.shape[2] > 1 and t.stride(2) != hd):
        raise ValueError(f"kv_write_int8: each token's Hkv x hd elements of {key} must be "
                         f"contiguous, got strides {t.stride()}")
    # a dim of size 1 is never stepped over: its stride is not read
    row, tok = (t.stride(d) if t.shape[d] > 1 else 0 for d in (0, 1))
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or row % vec or tok % vec:
        raise ValueError(f"kv_write_int8: {key}'s token rows must start at 16-byte aligned "
                         f"addresses, got offset {t.data_ptr() % 16} and strides {t.stride()}")
    if not t.is_cuda or t.device != device:
        raise ValueError(f"kv_write_int8: {key} is on {t.device}, the kernel needs a CUDA "
                         f"tensor on the pool's device ({device})")
    return row, tok


def kv_write_int8(pool: dict, k: torch.Tensor, v: torch.Tensor, table_rows: torch.Tensor,
                  starts: torch.Tensor, lengths: torch.Tensor | None = None) -> None:
    """Quantize k/v (n, S, Hkv, hd), float32 or bfloat16, per token per kv
    head into one layer's int8 pool planes, in place: ``pool["k"]``/``["v"]``
    (P, page, Hkv, hd) int8 and ``["ks"]``/``["vs"]`` (P, page, Hkv) float32.
    Row r's token j is live iff j < lengths[r] and j >= lengths[r] − T·page,
    and goes to ring slot (starts[r] + j) mod T·page through ``table_rows``
    (n, T); ``lengths`` None means one token per row (a decode step, with
    ``starts`` = pos). Dead tokens store nothing. One launch (none for an
    empty k), no allocation; shapes, types, strides and alignment are
    checked before the device, and anything else raises."""
    name = "kv_write_int8"
    kq, vq, ks, vs = pool["k"], pool["v"], pool["ks"], pool["vs"]
    if k.dim() != 4 or k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"{name}: k and v must be one (n, S, Hkv, hd) shape and dtype, got "
                         f"{tuple(k.shape)} {k.dtype} and {tuple(v.shape)} {v.dtype}")
    n, s, hkv, hd = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dims {HEAD_DIMS}, got {hd}")
    code = build.dtype_code(k)
    build.check_pool(name, k, kq, vq, ks, vs)
    if kq.dim() != 4 or kq.shape != vq.shape or kq.shape[2:] != (hkv, hd):
        raise ValueError(f"{name}: pools must be (P, page, {hkv}, {hd}), got "
                         f"{tuple(kq.shape)} and {tuple(vq.shape)}")
    idx = dict(table_rows=table_rows, starts=starts)
    if lengths is not None:
        idx["lengths"] = lengths
    for key, t in idx.items():
        if t.dtype != torch.int32 or t.dim() != (2 if key == "table_rows" else 1) \
                or t.shape[0] != n:
            raise ValueError(f"{name}: {key} must be int32 with {n} rows, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for key, t in (("kq", kq), ("vq", vq)):  # each lane stores 8 (bf16) or 4 bytes of q
        if t.data_ptr() % 8:
            raise ValueError(f"{name}: {key} must start at an 8-byte aligned address")
    k_row, k_tok = _token_strides("k", k, hd, kq.device)
    v_row, v_tok = _token_strides("v", v, hd, kq.device)
    build.check_cuda(name, kq=kq, vq=vq, ks=ks, vs=vs, **idx)
    if k.numel() == 0:
        return
    build.launch(name, k.data_ptr(), v.data_ptr(), table_rows.data_ptr(), starts.data_ptr(),
                 None if lengths is None else lengths.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                 ks.data_ptr(), vs.data_ptr(), k_row, k_tok, v_row, v_tok, n, s, hkv, hd,
                 table_rows.shape[1], kq.shape[1], code)
