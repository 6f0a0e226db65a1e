"""The DP channel kernels of ``csrc/dp_clip.cu``: the norm's order of
additions, emulated, and both kernels on the card.

``sq_norm`` runs in one launch whose blocks each sum a fixed chunk of
``CHUNK`` elements and whose last block sums the partials; the order of
every addition follows from n alone. ``sq_norm_emulation`` repeats those
additions in float32 in the kernel's order, each product and sum rounded
on its own as the kernel rounds them. On the CPU it is held within 1e-6
relative (two fp32 sums of squares in other orders: ~1e-7 apart) of the
plain version and of the reference's Pallas kernel (interpret mode, as
``tests/test_torch_kernels.py`` runs it); on the card the kernel must equal
it bitwise. A change to the kernel's order changes this emulation with it.

The ``*_cuda`` tests need an sm_90 card and skip elsewhere; like
``tests/test_torch_kernels.py`` they import neither JAX nor the reference
(run them there with ``--noconftest``)."""
import pathlib
import re

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dp_clip import CHUNK, counter

BLOCK, WARPS, ACC, PARTS = 256, 8, 4, 16  # as in csrc/dp_clip.cu
SIZES = (0, 1, 7, CHUNK - 1, CHUNK, 2 * CHUNK, 3 * CHUNK + 77)


@pytest.fixture
def sm90():
    """Skip unless an sm_90 (Hopper) card is present — decided here, at run
    time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")


def _butterfly(s: torch.Tensor) -> torch.Tensor:
    """The xor butterfly over the last dim (a warp's lanes): lane i adds
    lane i ^ off's value for off = width/2 .. 1; lane 0's sum."""
    width = s.shape[-1]
    lanes = torch.arange(width, device=s.device)
    off = width // 2
    while off:
        s = s + s[..., lanes ^ off]
        off //= 2
    return s[..., 0]


def _block_sum(per_thread: torch.Tensor) -> torch.Tensor:
    """(..., BLOCK) thread values → (...,): a butterfly in each warp, then
    one over the WARPS warp sums."""
    warps = _butterfly(per_thread.reshape(*per_thread.shape[:-1], WARPS, 32))
    return _butterfly(warps)


def _combine(acc: torch.Tensor) -> torch.Tensor:
    """A thread's ACC accumulators added as (a0 + a1) + (a2 + a3)."""
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def sq_norm_emulation(x: torch.Tensor) -> torch.Tensor:
    """Σx² in the kernel's order. Block c takes elements [c·CHUNK,
    (c+1)·CHUNK), zero past n (an exact no-op: the sums are >= 0); its
    thread t reads vector j at element (j·BLOCK + t)·VEC (VEC = 16 bytes of
    x's dtype) and adds element k's square into accumulator k % ACC, j outer
    and k inner. The last block's thread t adds partial r·BLOCK + t into
    accumulator r % ACC, r in order; both levels then combine and block-sum
    as above."""
    flat = x.reshape(-1)
    n, vec = flat.numel(), 16 // flat.element_size()
    m = max(1, -(-n // CHUNK))
    v = torch.zeros(m * CHUNK, dtype=torch.float32, device=x.device)
    v[:n] = flat.float()
    v = v.reshape(m, CHUNK // (BLOCK * vec), BLOCK, vec)  # (chunk, j, thread, k)
    acc = torch.zeros(m, BLOCK, ACC, device=x.device)
    for j in range(v.shape[1]):
        for k in range(vec):
            e = v[:, j, :, k]
            acc[..., k % ACC] = acc[..., k % ACC] + e * e
    partials = _block_sum(_combine(acc))
    rounds = -(-m // (BLOCK * PARTS)) * PARTS
    p = torch.zeros(rounds * BLOCK, device=x.device)
    p[:m] = partials
    p = p.reshape(rounds, BLOCK)
    a = torch.zeros(BLOCK, ACC, device=x.device)
    for r in range(rounds):
        a[:, r % ACC] = a[:, r % ACC] + p[r]
    return _block_sum(_combine(a))


def _input(n, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sq_norm_order_matches_plain_and_pallas(n, dtype):
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    x = _input(n, n)
    xd = x.to(dtype)
    got = sq_norm_emulation(xd).item()
    want = ref.sq_norm_ref(xd).item()
    leaf = {"x": jnp.asarray(x.numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)}
    # the Pallas kernel takes at least one tile: the empty leaf goes to the
    # reference's jnp version only
    oracles = [want, float(jops.tree_sq_norm(leaf, use_kernel=n > 0, interpret=True))]
    for w in oracles:
        if n == 0:
            assert got == w == 0.0
        else:
            assert got == pytest.approx(w, rel=1e-6, abs=0)


def test_sq_norm_order_differs_from_a_plain_running_sum():
    """The emulation is a real reordering: a plain fp32 running sum over
    the same squares lands on other bits, so the card's bitwise check of
    the kernel against the emulation pins its order."""
    x = _input(3 * CHUNK + 77, 9)
    running = np.cumsum(np.square(x.numpy()), dtype=np.float32)[-1]
    assert sq_norm_emulation(x).item() != running


@pytest.mark.parametrize("name, value", [("CHUNK", CHUNK), ("BLOCK", BLOCK),
                                         ("WARPS", WARPS), ("ACC", ACC), ("PARTS", PARTS)])
def test_order_constants_match_the_kernel_source(name, value):
    """The constants that fix the norm's order, in the wrapper (CHUNK) and
    in the emulation above, are the kernel's."""
    src = (pathlib.Path(repro_torch.__file__).parent / "csrc" / "dp_clip.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\w+)(?: / (\d+))?;", src)
    assert m is not None, name
    num, den = m.group(1), int(m.group(2) or 1)
    assert (BLOCK if num == "BLOCK" else int(num)) // den == value, (name, m.group(0))


# ---------------------------------------------------------------- card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sq_norm_kernel_equals_its_emulation_cuda(sm90, dtype):
    """Bitwise the emulated order, within 1e-6 of the plain version, the
    same bits on a second call, and on a view one element off a 16-byte
    boundary too (the order follows from n alone)."""
    for n in (*SIZES, 1_000_077):
        x = _input(n + 1, n, dtype).cuda()
        for xv in (x[:n], x[1:]):
            got = ops.sq_norm(xv)
            assert torch.equal(got, sq_norm_emulation(xv)), (n, xv.data_ptr() % 16)
            assert torch.equal(got, ops.sq_norm(xv))
            want = ref.sq_norm_ref(xv).item()
            assert got.item() == (pytest.approx(want, rel=1e-6, abs=0) if n else 0.0)


def test_sq_norm_is_one_launch_and_leaves_its_stream_counter_clean_cuda(sm90):
    from torch.profiler import ProfilerActivity, profile, schedule

    x = _input(5 * CHUNK + 3, 1).cuda()
    want = ops.sq_norm(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = ops.sq_norm(x)
        side_counter = counter(x.device)
    side.synchronize()
    assert torch.equal(got, want)
    assert side_counter is not counter(x.device)
    assert side_counter.item() == 0 and counter(x.device).item() == 0

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(10):
                ops.sq_norm(x)
            torch.cuda.synchronize()
            prof.step()
    rows = {e.key: e.count for e in prof.key_averages()
            if e.device_type == cuda and not e.key.startswith("ProfilerStep")}
    assert len(rows) == 1 and "sq_norm" in next(iter(rows)), rows
    assert next(iter(rows.values())) == 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_noise_is_bitwise_plain_at_ragged_lengths_cuda(sm90, dtype):
    s = torch.tensor(0.37, device="cuda")
    for n in (1, 7, 8, 9, 4095, 1_000_077):
        x = _input(n, n, dtype).cuda()
        noise = _input(n, n + 1).cuda()
        assert torch.equal(ops.clip_noise(x, s, noise, 0.3), ref.clip_noise_ref(x, s, noise, 0.3))
        assert torch.equal(ops.clip_noise(x, s), ref.clip_noise_ref(x, s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("byte_offset", [4, 8])
def test_clip_noise_is_bitwise_plain_on_misaligned_views_cuda(sm90, dtype, byte_offset):
    """x a view 4 or 8 bytes past a 16-byte boundary, with noise as many
    elements past one or on a boundary: every element takes the scalar
    loop."""
    s = torch.tensor(0.37, device="cuda")
    n = 100_003
    off = byte_offset // torch.tensor([], dtype=dtype).element_size()
    x = _input(n + off, 3, dtype).cuda()[off:]
    assert x.data_ptr() % 16 == byte_offset
    base = _input(n + off, 4).cuda()
    for noise in (base[off:], base[:n]):
        assert torch.equal(ops.clip_noise(x, s, noise, 0.3), ref.clip_noise_ref(x, s, noise, 0.3))
    assert torch.equal(ops.clip_noise(x, s), ref.clip_noise_ref(x, s))
