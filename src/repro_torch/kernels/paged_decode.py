"""Paged decode attention on the card: wrapper of ``csrc/paged_decode.cu``.

Replaces the TPU kernel ``repro/kernels/paged_decode.py::_table_decode``.
One query token per row attends over its ring of logical pages, mapped by a
(B, T) page table into one shared pool; pages past the row's live span are
never read. Plain version: ``ref.paged_decode_ref``.

``paged_decode_int8`` is the TPU kernel's ``k_scale``/``v_scale`` branch:
int8 pools with f32 scales (P, page, Hkv), dequantized in the kernel to q's
dtype. Plain version: ``ref.paged_decode_int8_ref``.

``paged_decode_ring`` is the TPU kernel's contiguous branch
(``paged_decode`` without a table): per-row rings (B, C, Hkv, hd), pages
of ``ring_page(C)`` keys, pages past a row's live span never read; bitwise
``swa_decode``'s output. Plain version: ``ref.ring_paged_decode_ref``.

All four decode entry points (these three and ``swa_decode``) run one
split-KV body: each row's ring of ``cap`` logical slots is cut into ranges
of ``split_len(cap, hd)`` slots, reduced to partials in a scratch buffer
the wrapper allocates (``partials``), and merged in range order."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Head dims the attention kernels are built for (every body: decode,
# tensor-core and SIMT prefill, the int8 pool write).
HEAD_DIMS = (32, 64, 128, 160)
# ... and those the ring decode kernels (paged_decode_ring, swa_decode) and
# flash_prefill also take: hd 256, recurrentgemma-2b's local attention,
# which has no paged pool (the table decode, suffix prefill and the int8
# pool write refuse it).
WIDE_HEAD_DIMS = HEAD_DIMS + (256,)
RING_TILE = 64       # keys per tile of the decode body; ranges start at multiples of it
MAX_RANGES = 16      # ranges per row at most (csrc/decode.cuh holds the same bound)
RANGE_ELEMS = 16384  # K elements a range holds at least (256 keys at hd 64)


def kernel_head_dim(hd: int) -> int:
    """The head dim of the KV caches and of the kernels' operands for a
    model head dim ``hd``: hd itself where a kernel takes it; 32 for 30
    (phi4-mini's smoke config, whose rows of 30 elements the kernels cannot
    read 16 bytes at a time), the extra dims zero and the softmax scale
    still 30**-0.5; any other hd raises."""
    if hd in WIDE_HEAD_DIMS:
        return hd
    if hd == 30:
        return 32
    raise ValueError(f"head dim {hd}: the attention kernels take {WIDE_HEAD_DIMS} (and 30, "
                     "padded to 32)")


def split_len(cap: int, hd: int) -> int:
    """Keys per range of the split-KV decode kernels for a ring of ``cap``
    logical slots (``C`` for the rings, ``T * page`` for the table) at head
    dim ``hd``: the smallest multiple of RING_TILE that cuts the ring into
    at most MAX_RANGES ranges, and at least RANGE_ELEMS / hd keys, so a
    range moves tens of KB (rounded up to a multiple of RING_TILE: 128 keys
    at hd 160). A function of the capacity and the head dim
    alone: never of the batch, the positions or the card, so a row's output
    does not depend on the rows beside it, and every entry point walks the
    same ranges at equal capacity (what makes them bitwise equal)."""
    per_range = -(-cap // MAX_RANGES)
    least = -(-(RANGE_ELEMS // hd) // RING_TILE) * RING_TILE
    return max(-(-per_range // RING_TILE) * RING_TILE, least)


def launch_plan(cap: int, q_shape) -> dict:
    """What one call over rings of ``cap`` slots launches for queries of
    ``q_shape`` (B, Hkv, G, hd): keys per range, ranges per row, and the
    split kernel's blocks, one per (kv head and chunk of query rows, row,
    range) with chunks of 1 row at G 1 and of 4 otherwise (csrc/decode.cuh)."""
    b, hkv, g, hd = q_shape
    split = split_len(cap, hd)
    ranges = -(-cap // split)
    chunks = 1 if g == 1 else -(-g // 4)
    return dict(split=split, ranges=ranges, blocks=ranges * hkv * chunks * b)


def partials(q: torch.Tensor, cap: int) -> tuple[torch.Tensor, int]:
    """The f32 scratch of the per-range partials (acc[hd], m, l) of every
    (row, kv head, query row), on q's device, and the split length. The
    wrapper drops it after the launch: the caching allocator hands its
    memory only to work queued behind the kernels on the same stream."""
    b, hkv, g, hd = q.shape
    plan = launch_plan(cap, q.shape)
    return torch.empty(b * hkv * g * plan["ranges"] * (hd + 2), dtype=torch.float32,
                       device=q.device), plan["split"]


def _check(name, q, k_pool, v_pool, k_scale, v_scale, pos, table):
    scales = {} if k_scale is None else dict(k_scale=k_scale, v_scale=v_scale)
    build.check_cuda(name, q=q, k_pool=k_pool, v_pool=v_pool, pos=pos, table=table, **scales)
    b, hkv, g, hd = q.shape
    p, page = k_pool.shape[:2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if k_pool.shape != (p, page, hkv, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    build.check_pool(name, q, k_pool, v_pool, k_scale, v_scale)
    if pos.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError(f"{name}: pos and table must be int32")
    if pos.shape != (b,) or table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"{name}: pos {tuple(pos.shape)} / table "
                         f"{tuple(table.shape)} do not match batch {b}")
    return b, hkv, g, hd, page


def paged_decode(
    q: torch.Tensor,       # (B, Hkv, G, hd)
    k_pool: torch.Tensor,  # (P, page, Hkv, hd)
    v_pool: torch.Tensor,
    pos: torch.Tensor,     # (B,) int32
    table: torch.Tensor,   # (B, T) int32
    window: int = 0,
    scale: float | None = None,  # None: hd**-0.5
) -> torch.Tensor:
    b, hkv, g, hd, page = _check("paged_decode", q, k_pool, v_pool, None, None, pos, table)
    t_w = table.shape[1]
    part, split = partials(q, t_w * page)
    out = torch.empty_like(q)
    build.launch(
        "paged_decode", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos.data_ptr(), table.data_ptr(), part.data_ptr(), out.data_ptr(),
        build.dtype_code(q), b, hkv, g, hd, page, t_w, window, split,
        hd**-0.5 if scale is None else scale,
    )
    return out


def paged_decode_int8(
    q: torch.Tensor,        # (B, Hkv, G, hd) float32 / bfloat16
    k_pool: torch.Tensor,   # (P, page, Hkv, hd) int8
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (P, page, Hkv) float32
    v_scale: torch.Tensor,
    pos: torch.Tensor,      # (B,) int32
    table: torch.Tensor,    # (B, T) int32
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    b, hkv, g, hd, page = _check("paged_decode_int8", q, k_pool, v_pool, k_scale, v_scale,
                                 pos, table)
    t_w = table.shape[1]
    part, split = partials(q, t_w * page)
    out = torch.empty_like(q)
    build.launch(
        "paged_decode_int8", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), table.data_ptr(),
        part.data_ptr(), out.data_ptr(), build.dtype_code(q), b, hkv, g, hd, page, t_w,
        window, split, hd**-0.5 if scale is None else scale,
    )
    return out


def ring_page(cap: int) -> int:
    """Page of the contiguous branch: the largest of 512/256/128/64 that
    divides the ring capacity, else the whole ring (the reference's
    ``swa_decode._chunk``)."""
    for ck in (512, 256, 128, 64):
        if cap % ck == 0 and cap >= ck:
            return ck
    return cap


def check_ring(name, q, k, v, pos):
    """Operands of the ring kernels: q (B, Hkv, G, hd), rings k/v (B, C,
    Hkv, hd) of q's dtype, pos (B,) int32, all contiguous on one card."""
    build.check_cuda(name, q=q, k=k, v=v, pos=pos)
    b, hkv, g, hd = q.shape
    if hd not in WIDE_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {WIDE_HEAD_DIMS}")
    if k.dim() != 4 or k.shape[0] != b or k.shape[2:] != (hkv, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: rings {tuple(k.shape)}/{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q and the rings must share one dtype")
    if pos.dtype != torch.int32 or pos.shape != (b,):
        raise ValueError(f"{name}: pos must be int32 ({b},), got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    return b, k.shape[1], hkv, g, hd


def paged_decode_ring(
    q: torch.Tensor,    # (B, Hkv, G, hd)
    k: torch.Tensor,    # (B, C, Hkv, hd)
    v: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32
    window: int = 0,
    *,
    page: int = 0,      # 0 = ring_page(C)
    scale: float | None = None,
) -> torch.Tensor:
    b, cap, hkv, g, hd = check_ring("paged_decode_ring", q, k, v, pos)
    page = page or ring_page(cap)
    if cap % page:
        raise ValueError(f"paged_decode_ring: ring {cap} is not a multiple of page {page}")
    part, split = partials(q, cap)
    out = torch.empty_like(q)
    build.launch(
        "paged_decode_ring", q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part.data_ptr(), out.data_ptr(), build.dtype_code(q), b, cap, hkv, g, hd, page,
        window, split, hd**-0.5 if scale is None else scale,
    )
    return out
