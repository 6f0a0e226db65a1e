"""The split-KV decode body's invariants, on the CPU.

The four decode entry points (``paged_decode``, ``paged_decode_int8``,
``paged_decode_ring``, ``swa_decode``) run one CUDA body
(``src/repro_torch/csrc/decode.cuh``) that cuts each row's ring into ranges
of ``split_len(cap, hd)`` slots, reduces each range per warp (16 keys of
every 64-key tile) with an online softmax, merges the four warps and then
the ranges in order, and skips a range wholly past the live span by writing
the identity partial. The kernel runs only on the card; here a float32
emulation of that structure (``_split_kv_emulation``: the same ranges,
tiles, warp shares, merge orders and skips; each dot product and tile sum
in PyTorch's order, not the kernel's lane tree) is held against the port's
plain versions and the JAX package's oracles at the fp32 tolerance, and the
skip is held bitwise against walking the dead ranges masked. The split rule
is pinned: a function of the capacity and the head dim alone, the same for
all four entry points at equal capacity."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_decode import (
    HEAD_DIMS, MAX_RANGES, RANGE_ELEMS, RING_TILE, launch_plan, paged_decode,
    paged_decode_int8, paged_decode_ring, ring_page, split_len,
)
from repro_torch.kernels.swa_decode import swa_decode

TOL = 1e-5        # fp32: the same softmax, summed in another order
WARPS, WARP_KEYS = 4, 16


def _merge(m, l, acc):
    """States stacked on dim 0 merged in that order: M = max m_i,
    w_i = exp(m_i - M), l = sum w_i l_i, acc = sum w_i acc_i."""
    mx = m.amax(0)
    lsum, a = torch.zeros_like(l[0]), torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        wt = torch.exp(m[i] - mx)
        lsum = lsum + wt * l[i]
        a = a + wt[..., None] * acc[i]
    return mx, lsum, a


def _split_kv_emulation(q, k, v, pos, window, split, limit, walk_all=False):
    """The split-KV body over rings k/v (B, C, Hkv, hd) for queries q (B,
    Hkv, G, hd) at positions pos (B,): slots at or past ``limit[b]`` are
    neither read (zeros) nor live. As the kernel: tiles at or past the limit
    are not walked, and a range wholly past it is the identity partial
    (m = NEG, l = 0, acc = 0). ``walk_all``: every tile of every range is
    walked instead, masked where not live."""
    b, cap, hkv, hd = k.shape
    g = q.shape[2]
    qf = q.float()
    slots = torch.arange(cap)
    readable = slots[None, :] < limit[:, None]
    live = ref._ring_valid(pos.long(), cap, window) & readable
    kf = torch.where(readable[:, :, None, None], k.float(), 0.0)
    vf = torch.where(readable[:, :, None, None], v.float(), 0.0)
    parts = []
    for s_begin in range(0, cap, split):
        m = torch.full((WARPS, b, hkv, g), ref.NEG)
        l = torch.zeros(WARPS, b, hkv, g)
        acc = torch.zeros(WARPS, b, hkv, g, hd)
        for t0 in range(s_begin, min(s_begin + split, cap), RING_TILE):
            n = min(RING_TILE, cap - t0)
            kt, vt = torch.zeros(b, RING_TILE, hkv, hd), torch.zeros(b, RING_TILE, hkv, hd)
            lt = torch.zeros(b, RING_TILE, dtype=torch.bool)
            kt[:, :n], vt[:, :n], lt[:, :n] = kf[:, t0:t0 + n], vf[:, t0:t0 + n], live[:, t0:t0 + n]
            kt, vt = (x.reshape(b, WARPS, WARP_KEYS, hkv, hd) for x in (kt, vt))
            lt = lt.reshape(b, WARPS, WARP_KEYS).permute(1, 0, 2)[:, :, None, None, :]
            sc = torch.einsum("bkgd,bwckd->wbkgc", qf, kt) * hd**-0.5
            sc = torch.where(lt, sc, torch.full_like(sc, ref.NEG))
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l_new = l * alpha + p.sum(-1)
            acc_new = acc * alpha[..., None] + torch.einsum("wbkgc,bwckd->wbkgd", p, vt)
            walked = torch.ones(b, dtype=torch.bool) if walk_all else t0 < limit
            w = walked[None, :, None, None]
            m, l = torch.where(w, m_new, m), torch.where(w, l_new, l)
            acc = torch.where(w[..., None], acc_new, acc)
        mr, lr, ar = _merge(m, l, acc)
        if not walk_all:
            dead = (s_begin >= limit)[:, None, None]
            mr = torch.where(dead, ref.NEG, mr)
            lr = torch.where(dead, 0.0, lr)
            ar = torch.where(dead[..., None], 0.0, ar)
        parts.append((mr, lr, ar))
    _, lsum, a = _merge(*(torch.stack(x) for x in zip(*parts)))
    return (a / lsum.clamp(min=1e-30)[..., None]).to(q.dtype)


def _span(pos, cap, page):
    """The kernels' read limit: whole pages up to ceil(min(pos + 1, cap) /
    page), at most cap (csrc/decode.cuh, live_pages)."""
    live = torch.clamp(pos.long() + 1, max=cap)
    pages = torch.clamp(-(-live // page), min=1, max=-(-cap // page))
    return torch.clamp(pages * page, max=cap)


def _ring_case(seed, b, cap, hkv, g, hd):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, hkv, g, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, cap, hkv, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, cap, hkv, hd), np.float32))
    return q, k, v


# (label, B, C, Hkv, G, hd, window, positions): the ranges of split_len(C, hd)
CASES = [
    # hd 32, C 2048: ranges of 512; spans ending mid-range (700 keys), on a
    # range boundary (512, 1024 keys), and a wrapped row
    ("boundaries", 4, 2048, 2, 1, 32, 0, [699, 1023, 511, 2047 + 900]),
    # hd 64, C 2048: ranges of 256, G 4; rows wrapped once and three times
    ("wrapped", 2, 2048, 2, 4, 64, 0, [2048 + 300, 3 * 2048 + 1023]),
    # a window shorter than one range (100 < 512), one of them across the wrap
    ("window", 3, 2048, 2, 1, 32, 100, [1500, 2048 + 40, 60]),
    ("window_gqa", 2, 1024, 1, 4, 64, 200, [900, 1024 + 100]),
    # long_500k's shape, cut to 2 kv heads: B 1, C 8192, 16 ranges of 512
    ("long_500k", 1, 8192, 2, 1, 64, 0, [524287]),
    # a ring shorter than one range and not a multiple of the tile
    ("short", 3, 96, 2, 4, 32, 0, [5, 95, 96 + 17]),
]


@pytest.mark.parametrize("label,b,cap,hkv,g,hd,window,pos", CASES, ids=[c[0] for c in CASES])
def test_split_emulation_matches_plain_and_reference(label, b, cap, hkv, g, hd, window, pos):
    """The emulated kernel (swa: every slot; paged ring: live ring pages;
    table: live pool pages of 16) against the port's plain versions and the
    JAX package's oracles, fp32 within 1e-5."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    q, k, v = _ring_case(len(label) + cap, b, cap, hkv, g, hd)
    pos = torch.tensor(pos, dtype=torch.int32)
    split = split_len(cap, hd)
    assert -(-cap // split) > 1 or cap < split, (label, split)
    full = torch.full((b,), cap)
    swa = _split_kv_emulation(q, k, v, pos, window, split, full)
    paged = _split_kv_emulation(q, k, v, pos, window, split, _span(pos, cap, ring_page(cap)))
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    jp = jnp.asarray(pos.numpy())
    for got, plain, oracle in (
            (swa, ref.swa_decode_ref(q, k, v, pos, window), jref.swa_decode_ref),
            (paged, ref.ring_paged_decode_ref(q, k, v, pos, window), jref.paged_decode_ref)):
        torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle(jq, jk, jv, jp, window)),
                                   rtol=TOL, atol=TOL)
    if cap % 16 == 0:
        # the table layout: the same keys in scattered pool pages of 16
        t_w = cap // 16
        table = torch.from_numpy(np.random.default_rng(1).permutation(b * t_w) + 1)
        table = table.reshape(b, t_w).to(torch.int32)
        kp, vp = (torch.zeros(b * t_w + 1, 16, hkv, hd) for _ in "kv")
        kp[table.long().reshape(-1)] = k.reshape(b * t_w, 16, hkv, hd)
        vp[table.long().reshape(-1)] = v.reshape(b * t_w, 16, hkv, hd)
        kr, vr = ref.gather_pages_ref(kp, table), ref.gather_pages_ref(vp, table)
        got = _split_kv_emulation(q, kr, vr, pos, window, split, _span(pos, cap, 16))
        torch.testing.assert_close(got, ref.paged_decode_ref(q, kp, vp, pos, table, window),
                                   rtol=TOL, atol=TOL)
        want = jref.paged_table_decode_ref(jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
                                           jnp.asarray(vp.numpy()), pos.numpy(),
                                           table.numpy(), window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("label,b,cap,hkv,g,hd,window,pos", CASES, ids=[c[0] for c in CASES])
def test_dead_range_skip_is_bitwise_walking_it_masked(label, b, cap, hkv, g, hd, window, pos):
    """Skipping dead ranges (identity partials) and dead tiles gives the
    bits of walking every range masked, at every read limit the entry
    points use: live ring pages of 64-512 (paged_decode_ring), live pool
    pages of 16 (the table) and the whole ring (swa_decode)."""
    q, k, v = _ring_case(7 + cap, b, cap, hkv, g, hd)
    pos = torch.tensor(pos, dtype=torch.int32)
    split = split_len(cap, hd)
    full = torch.full((b,), cap)
    walked = _split_kv_emulation(q, k, v, pos, window, split, full, walk_all=True)
    assert torch.equal(_split_kv_emulation(q, k, v, pos, window, split, full), walked)
    for page in (16, 64, 128, 256, 512, cap):
        if cap % page:
            continue
        limit = _span(pos, cap, page)
        assert torch.equal(_split_kv_emulation(q, k, v, pos, window, split, limit), walked), page
        assert torch.equal(
            _split_kv_emulation(q, k, v, pos, window, split, limit, walk_all=True), walked), page


def test_identity_partial_adds_nothing():
    """The merge's weight for a state with m = NEG is exactly 0, whatever
    its l and acc, beside any live state."""
    live_m, live_l, live_acc = torch.tensor([0.3]), torch.tensor([2.5]), torch.tensor([[0.7]])
    for dead_l, dead_acc in ((0.0, 0.0), (512.0, -37.25), (1.0, 3.0e4)):
        m = torch.tensor([[ref.NEG], [0.3], [ref.NEG]])
        l = torch.tensor([[dead_l], [2.5], [dead_l]])
        acc = torch.tensor([[[dead_acc]], [[0.7]], [[dead_acc]]])
        got = _merge(m, l, acc)
        assert torch.equal(got[0], live_m)
        assert torch.equal(got[1], live_l) and torch.equal(got[2], live_acc)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_split_rule_is_a_function_of_the_capacity(hd):
    """split_len: a multiple of RING_TILE, at least RANGE_ELEMS / hd keys,
    at most MAX_RANGES ranges per row, not decreasing in the capacity; its
    only inputs are the capacity and the head dim."""
    assert list(inspect.signature(split_len).parameters) == ["cap", "hd"]
    prev = 0
    for cap in [*range(1, 4097, 37), 3328, 4096, 8192, 16384, 65536, 524288]:
        split = split_len(cap, hd)
        assert split % RING_TILE == 0 and split >= RING_TILE
        assert split >= RANGE_ELEMS // hd
        assert -(-cap // split) <= MAX_RANGES
        if cap > 4096:
            assert split >= prev
        prev = split
    # the shapes chip_smoke.py runs
    assert split_len(4096, 64) == 256 and split_len(8192, 64) == 512
    assert split_len(208 * 16, 64) == 256


def test_split_constants_match_the_kernel_source():
    """The kernel refuses more than MAX_RANGES ranges per row and walks
    tiles of RING_TILE keys: the rule's constants are the source's."""
    import pathlib
    import re

    import repro_torch

    src = (pathlib.Path(repro_torch.__file__).parent / "csrc" / "decode.cuh").read_text()
    for name, value in (("MAX_RANGES", MAX_RANGES), ("RING_TILE", RING_TILE)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value), name


def test_every_entry_point_takes_the_same_split(monkeypatch):
    """At equal capacity the four wrappers hand the kernel the same split,
    split_len(cap, hd), whatever the batch and the positions: a ring of 512
    slots and a table of 32 pages of 16."""
    calls = []
    monkeypatch.setattr(build, "check_cuda", lambda name, **tensors: None)
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    hd, cap = 64, 512
    for b, pos in ((1, [5]), (4, [0, 100, 511, 2000])):
        q = torch.zeros(b, 2, 1, hd)
        ring = torch.zeros(b, cap, 2, hd)
        pool = torch.zeros(b * 32 + 1, 16, 2, hd)
        pos = torch.tensor(pos, dtype=torch.int32)
        table = torch.arange(1, b * 32 + 1, dtype=torch.int32).reshape(b, 32)
        paged_decode(q, pool, pool, pos, table)
        scales = torch.ones(pool.shape[:-1])
        paged_decode_int8(q, pool.to(torch.int8), pool.to(torch.int8), scales, scales, pos, table)
        paged_decode_ring(q, ring, ring, pos)
        paged_decode_ring(q, ring, ring, pos, page=64)
        swa_decode(q, ring, ring, pos)
    assert [name for name, _ in calls] == ["paged_decode", "paged_decode_int8",
                                           "paged_decode_ring", "paged_decode_ring",
                                           "swa_decode"] * 2
    # (split, scale) end every call's arguments
    assert {args[-2] for _, args in calls} == {split_len(cap, hd)}
    assert launch_plan(cap, (4, 2, 1, hd)) == dict(split=256, ranges=2, blocks=16)
    assert launch_plan(cap, (1, 2, 5, hd))["blocks"] == 2 * 2 * 2
