"""The port's attention kernels: plain versions against the reference.

Each plain version (``repro_torch.kernels.ref``) is held against the
reference package's oracle (``repro.kernels.ref``) and against its Pallas
kernel run with ``interpret=True``, on the same numpy-drawn inputs at tiny
shapes: B <= 3, Hkv 2, G in {1, 2}, hd in {32, 64}, page 8, with scattered,
aliased (two rows sharing a page) and scratch-tail tables, decode ring wrap
and windows, and suffix rows with mixed starts including 0.

Tolerances: on float32 inputs all three compute the same softmax in fp32
and differ only in summation order (the kernels reassociate it online):
1e-5. On bfloat16 inputs the outputs are cast to bf16, whose spacing at
O(1) values is 2**-7, so a reordered fp32 sum may round one ulp apart:
1e-2.

The CUDA kernels themselves are held against the plain versions in the
``*_cuda`` tests, which need an sm_90 card and skip elsewhere; they import
neither JAX nor the reference (run them on the card with
``python -m pytest -q --noconftest tests/test_torch_kernels.py -k cuda``;
the repository's conftest imports JAX, which the card's machine lacks)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref

TOL = {np.float32: 1e-5, "bfloat16": 1e-2}
PAGE, T_W, P = 8, 4, 12


@pytest.fixture
def sm90():
    """Skip unless an sm_90 (Hopper) card is present — decided here, at run
    time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")


def _to_jax(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _to_torch(a, dtype, device="cpu"):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return t.to(device)


def _close(port, ref_out, dtype):
    ref_f = np.asarray(ref_out, np.float32)
    port_f = port.float().cpu().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(port_f, ref_f, rtol=tol, atol=tol)


def _tables(rng, b):
    """Scattered rows, row 2 aliasing row 0's first page, scratch-tail
    entries (0) past each row's live pages; row 1 fully allocated (wraps)."""
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((b, T_W), np.int32)
    table[0, :2] = perm[:2]
    table[1, :] = perm[2:6]
    if b > 2:
        table[2, :3] = [perm[0], perm[6], perm[7]]
    return table


def _decode_inputs(seed, b, g, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 2, g, hd), np.float32)
    kp = rng.standard_normal((P, PAGE, 2, hd), np.float32)
    vp = rng.standard_normal((P, PAGE, 2, hd), np.float32)
    pos = np.array([9, T_W * PAGE + 5, 20][:b], np.int32)   # row 1 has wrapped
    return q, kp, vp, pos, _tables(rng, b)


def _suffix_inputs(seed, n, g, hd, s=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, s, 2, g, hd), np.float32)
    ks = rng.standard_normal((n, s, 2, hd), np.float32)
    vs = rng.standard_normal((n, s, 2, hd), np.float32)
    kp = rng.standard_normal((P, PAGE, 2, hd), np.float32)
    vp = rng.standard_normal((P, PAGE, 2, hd), np.float32)
    starts = np.array([0, 11, 16][:n], np.int32)
    return q, ks, vs, kp, vp, _tables(rng, n), starts


CASES = [(g, hd, dt) for g in (1, 2) for hd in (32, 64) for dt in (np.float32, "bfloat16")]


@pytest.mark.parametrize("g,hd,dtype", CASES)
@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_plain_matches_reference_oracle(g, hd, dtype, window):
    from repro.kernels import ref as jref

    q, kp, vp, pos, table = _decode_inputs(1, 3, g, hd)
    want = jref.paged_table_decode_ref(
        _to_jax(q, dtype), _to_jax(kp, dtype), _to_jax(vp, dtype), pos, table, window)
    got = ref.paged_decode_ref(*(_to_torch(a, dtype) for a in (q, kp, vp, pos, table)), window)
    _close(got, want, dtype)


@pytest.mark.parametrize("g,hd,dtype", CASES)
@pytest.mark.parametrize("window", [0, 5])
def test_flash_prefill_plain_matches_reference_oracle(g, hd, dtype, window):
    from repro.kernels import ref as jref

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16, 2, g, hd), np.float32)
    k = rng.standard_normal((2, 16, 2, hd), np.float32)
    v = rng.standard_normal((2, 16, 2, hd), np.float32)
    want = jref.flash_prefill_ref(*(_to_jax(a, dtype) for a in (q, k, v)), causal=True,
                                  window=window)
    got = ref.flash_prefill_ref(*(_to_torch(a, dtype) for a in (q, k, v)), window=window)
    _close(got, want, dtype)


@pytest.mark.parametrize("g,hd,dtype", CASES)
@pytest.mark.parametrize("width", [2, 4])
def test_suffix_prefill_plain_matches_reference_oracle(g, hd, dtype, width):
    from repro.kernels import ref as jref

    args = _suffix_inputs(3, 3, g, hd)
    want = jref.suffix_prefill_ref(*(_to_jax(a, dtype) if a.dtype == np.float32 else a
                                     for a in args), prefix_width=width)
    got = ref.suffix_prefill_ref(*(_to_torch(a, dtype) for a in args), prefix_width=width)
    _close(got, want, dtype)


@pytest.mark.parametrize("g,hd", [(1, 32), (2, 64)])
def test_plain_versions_match_pallas_kernels_interpreted(g, hd):
    """The TPU kernels themselves (interpret mode), float32."""
    from repro.kernels.flash_prefill import flash_prefill
    from repro.kernels.flash_suffix_prefill import suffix_prefill
    from repro.kernels.paged_decode import paged_decode

    dt = np.float32
    q, kp, vp, pos, table = _decode_inputs(4, 3, g, hd)
    for window in (0, 5):
        want = paged_decode(_to_jax(q, dt), _to_jax(kp, dt), _to_jax(vp, dt), pos, window,
                            table=table, interpret=True)
        got = ref.paged_decode_ref(*(_to_torch(a, dt) for a in (q, kp, vp, pos, table)),
                                   window)
        _close(got, want, dt)
    rng = np.random.default_rng(5)
    qf = rng.standard_normal((2, 16, 2, g, hd), np.float32)
    kf = rng.standard_normal((2, 16, 2, hd), np.float32)
    vf = rng.standard_normal((2, 16, 2, hd), np.float32)
    want = flash_prefill(*(_to_jax(a, dt) for a in (qf, kf, vf)), causal=True, window=0,
                         bq=8, bk=8, interpret=True)
    _close(ref.flash_prefill_ref(*(_to_torch(a, dt) for a in (qf, kf, vf))), want, dt)
    args = _suffix_inputs(6, 3, g, hd)
    want = suffix_prefill(*(_to_jax(a, dt) if a.dtype == np.float32 else a for a in args),
                          prefix_width=3, interpret=True)
    _close(ref.suffix_prefill_ref(*(_to_torch(a, dt) for a in args), prefix_width=3), want, dt)


def test_gather_pages_matches_reference():
    from repro.kernels import ref as jref
    from repro_torch.models.attention import gather_pages

    rng = np.random.default_rng(7)
    pool = rng.standard_normal((P, PAGE, 2, 32), np.float32)
    table = _tables(rng, 3)
    np.testing.assert_array_equal(
        gather_pages(torch.from_numpy(pool), torch.from_numpy(table)).numpy(),
        np.asarray(jref.gather_pages_ref(_to_jax(pool, np.float32), table)))


# ------------------------------------------------------------ dispatch
def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    build.reset_launches()
    q, kp, vp, pos, table = (_to_torch(a, np.float32) for a in _decode_inputs(8, 2, 1, 32))
    out = ops.paged_decode_attention(q, kp, vp, pos, table)
    torch.testing.assert_close(out, ref.paged_decode_ref(q, kp, vp, pos, table), rtol=0, atol=0)
    assert ops.LAUNCHES == {"paged_decode": 0, "flash_prefill": 0, "suffix_prefill": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA entry points never take a CPU tensor (no silent fallback)."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.flash_suffix_prefill import suffix_prefill
    from repro_torch.kernels.paged_decode import paged_decode

    q, kp, vp, pos, table = (_to_torch(a, np.float32) for a in _decode_inputs(8, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode(q, kp, vp, pos, table)
    x = torch.zeros(1, 8, 2, 1, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(x, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        suffix_prefill(x, kv, kv, kp, vp, table[:1], pos[:1], prefix_width=1)


# ---------------------------------------------------------------- card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd", [(1, 64), (4, 128), (2, 32)])
def test_kernels_match_plain_versions_cuda(sm90, dtype, g, hd):
    """Each kernel against its plain version on the card: fp32 within 1e-5,
    bf16 within 2e-2 (bf16 outputs of O(1) values, one rounding apart)."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    gen = torch.Generator().manual_seed(g * hd)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    b, hkv, page, t_w, pages = 3, 2, 16, 6, 24
    q, kp, vp = rnd(b, hkv, g, hd), rnd(pages, page, hkv, hd), rnd(pages, page, hkv, hd)
    table = torch.zeros(b, t_w, dtype=torch.int32)
    table[0, :2] = torch.tensor([5, 9])
    table[1, :] = torch.tensor([3, 11, 7, 20, 14, 2])
    table[2, :4] = torch.tensor([5, 17, 1, 8])             # aliases row 0's first page
    table = table.to("cuda")
    pos = torch.tensor([20, t_w * page + 9, 50], dtype=torch.int32, device="cuda")
    for window in (0, 7):
        torch.testing.assert_close(
            ops.paged_decode_attention(q, kp, vp, pos, table, window).float(),
            ref.paged_decode_ref(q, kp, vp, pos, table, window).float(), rtol=0, atol=tol)
    for s in (8, 100):
        qs, ks, vs = rnd(b, s, hkv, g, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
        for window in (0, 9):
            torch.testing.assert_close(
                ops.flash_prefill_attention(qs, ks, vs, window=window).float(),
                ref.flash_prefill_ref(qs, ks, vs, window=window).float(), rtol=0, atol=tol)
        starts = torch.tensor([0, 33, 48], dtype=torch.int32, device="cuda")
        for width in (3, 6):
            torch.testing.assert_close(
                ops.suffix_prefill_attention(qs, ks, vs, kp, vp, table, starts,
                                             prefix_width=width).float(),
                ref.suffix_prefill_ref(qs, ks, vs, kp, vp, table, starts,
                                       prefix_width=width).float(), rtol=0, atol=tol)


def test_launch_counters_count_kernel_launches_cuda(sm90):
    build.reset_launches()
    q = torch.randn(2, 2, 1, 64, device="cuda")
    pool = torch.randn(4, 16, 2, 64, device="cuda")
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([20, 3], dtype=torch.int32, device="cuda")
    ops.paged_decode_attention(q, pool, pool, pos, table)
    ops.paged_decode_attention(q, pool, pool, pos, table)
    assert ops.LAUNCHES["paged_decode"] == 2
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_decode_attention(torch.randn(2, 2, 1, 48, device="cuda"),
                                   torch.randn(4, 16, 2, 48, device="cuda"),
                                   torch.randn(4, 16, 2, 48, device="cuda"), pos, table)
    assert ops.LAUNCHES["paged_decode"] == 2
