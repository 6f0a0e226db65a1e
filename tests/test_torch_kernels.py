"""The port's kernels: plain versions against the reference.

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
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import channel_cases  # noqa: E402  (beside chip_smoke.py, outside the package)
from repro_torch.kernels.paged_decode import split_len

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


# ------------------------------------------- flash_prefill, non-causal
# whisper's encoder (S = T) and cross-attention (S queries, T frames), at T
# no multiple of 64: the last key tile crosses T
NONCAUSAL_SHAPES = [(24, 24), (8, 40), (1, 40)]


@pytest.mark.parametrize("g,hd,dtype", CASES)
@pytest.mark.parametrize("s,t", NONCAUSAL_SHAPES)
def test_noncausal_flash_prefill_plain_matches_reference_oracle(g, hd, dtype, s, t):
    from repro.kernels import ref as jref

    rng = np.random.default_rng(s * 100 + t)
    q = rng.standard_normal((2, s, 2, g, hd), np.float32)
    k = rng.standard_normal((2, t, 2, hd), np.float32)
    v = rng.standard_normal((2, t, 2, hd), np.float32)
    want = jref.flash_prefill_ref(*(_to_jax(a, dtype) for a in (q, k, v)), causal=False)
    got = ref.flash_prefill_ref(*(_to_torch(a, dtype) for a in (q, k, v)), causal=False)
    _close(got, want, dtype)
    # the dispatch on CPU tensors is the plain version; a window needs causal
    torch.testing.assert_close(
        ops.flash_prefill_attention(*(_to_torch(a, dtype) for a in (q, k, v)), causal=False),
        got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="window"):
        ops.flash_prefill_attention(*(_to_torch(a, dtype) for a in (q, k, v)), causal=False,
                                    window=4)


@pytest.mark.parametrize("g,hd", [(1, 32), (2, 64)])
@pytest.mark.parametrize("s", [1, 8])
def test_noncausal_flash_prefill_plain_matches_pallas_interpreted(g, hd, s):
    """The TPU kernel's non-causal mode (interpret mode, float32) at S != T,
    T = 40."""
    from repro.kernels.flash_prefill import flash_prefill

    dt = np.float32
    rng = np.random.default_rng(7 + s)
    q = rng.standard_normal((2, s, 2, g, hd), np.float32)
    k = rng.standard_normal((2, 40, 2, hd), np.float32)
    v = rng.standard_normal((2, 40, 2, hd), np.float32)
    want = flash_prefill(*(_to_jax(a, dt) for a in (q, k, v)), causal=False, bq=8, bk=8,
                         interpret=True)
    _close(ref.flash_prefill_ref(*(_to_torch(a, dt) for a in (q, k, v)), causal=False), want,
           dt)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("t", [40, 1500])
def test_cross_decode_route_matches_reference_attend_full(paged, t):
    """Whisper's decode-step cross-attention: the port's ring-decode route
    (``ops.swa_decode_attention`` over the T frames at position T - 1,
    window 0) against the reference's ``attend_full(kv=..., causal=False)``
    on the same weights, float32."""
    import dataclasses

    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.models import attention as jattn
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as attn

    cfg = dataclasses.replace(get_smoke_config("whisper-medium"), dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config("whisper-medium"), dtype="float32")
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    rng = np.random.default_rng(t)
    params = {name: rng.standard_normal(shape, np.float32) * np.float32(0.1)
              for name, shape in (("wq", (d, h * hd)), ("wk", (d, h * hd)),
                                  ("wv", (d, h * hd)), ("wo", (h * hd, d)))}
    x = rng.standard_normal((3, 1, d), np.float32)
    xk, xv = (rng.standard_normal((3, t, cfg.n_kv_heads, hd), np.float32) for _ in "kv")
    want = jattn.attend_full({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                             None, ref_cfg, causal=False, kv=(jnp.asarray(xk), jnp.asarray(xv)),
                             rope=False)
    T = torch.from_numpy
    got = attn.cross_decode_attend({k: T(v) for k, v in params.items()}, T(x), T(xk), T(xv),
                                   cfg, paged=paged)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


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
    x = torch.randn(700)
    torch.testing.assert_close(ops.topk_sparsify_leaf(x, 0.01), ref.topk_sparsify_ref(x, 3))
    torch.testing.assert_close(ops.int8_roundtrip_leaf(x), ref.int8_roundtrip_ref(x))
    torch.testing.assert_close(ops.tree_sq_norm({"a": x}), ref.sq_norm_ref(x))
    torch.testing.assert_close(ops.clip_noise(x, 0.5), ref.clip_noise_ref(x, torch.tensor(0.5)))
    q8, s8 = ref.kv_quant_ref(kp)
    torch.testing.assert_close(
        ops.paged_decode_attention(q, q8, q8, pos, table, k_scale=s8, v_scale=s8),
        ref.paged_decode_int8_ref(q, q8, q8, s8, s8, pos, table), rtol=0, atol=0)
    torch.testing.assert_close(ops.int8_encode_leaf(x)[:2], ref.int8_encode_ref(ref._blocks(x)),
                               rtol=0, atol=0)
    kv = torch.randn(table.shape[0], 1, *kp.shape[2:])    # a decode step's k/v
    pool = {"k": q8.clone(), "v": q8.clone(), "ks": s8.clone(), "vs": s8.clone()}
    want = {key: t.clone() for key, t in pool.items()}
    ops.kv_write_int8(pool, kv, kv, table, pos)
    ref.kv_write_int8_ref(want, kv, kv, table, pos)
    torch.testing.assert_close(pool, want, rtol=0, atol=0)
    ring = (q, ref.gather_pages_ref(kp, table), ref.gather_pages_ref(vp, table))
    for paged, plain in ((True, ref.ring_paged_decode_ref), (False, ref.swa_decode_ref)):
        torch.testing.assert_close(ops.swa_decode_attention(*ring, pos, 5, paged=paged),
                                   plain(*ring, pos, 5), rtol=0, atol=0)
    assert set(ops.LAUNCHES) == {"paged_decode", "flash_prefill", "suffix_prefill",
                                 "paged_decode_int8", "suffix_prefill_int8", "int8_encode",
                                 "int8_roundtrip", "topk_sparsify", "sq_norm", "clip_noise",
                                 "paged_decode_ring", "swa_decode", "kv_write_int8"}
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA entry points never take a CPU tensor (no silent fallback)."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.flash_suffix_prefill import suffix_prefill
    from repro_torch.kernels.paged_decode import paged_decode, paged_decode_ring
    from repro_torch.kernels.swa_decode import swa_decode

    q, kp, vp, pos, table = (_to_torch(a, np.float32) for a in _decode_inputs(8, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode(q, kp, vp, pos, table)
    ring = ref.gather_pages_ref(kp, table)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_ring(q, ring, ring, pos)
    with pytest.raises(ValueError, match="CUDA"):
        swa_decode(q, ring, ring, pos)
    x = torch.zeros(1, 8, 2, 1, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(x, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        suffix_prefill(x, kv, kv, kp, vp, table[:1], pos[:1], prefix_width=1)
    from repro_torch.kernels.dp_clip import clip_noise, sq_norm
    from repro_torch.kernels.quantize import int8_roundtrip
    from repro_torch.kernels.topk_compress import topk_sparsify

    flat = torch.zeros(300)
    with pytest.raises(ValueError, match="CUDA"):
        topk_sparsify(flat, 3)
    with pytest.raises(ValueError, match="CUDA"):
        int8_roundtrip(flat)
    with pytest.raises(ValueError, match="CUDA"):
        sq_norm(flat)
    with pytest.raises(ValueError, match="CUDA"):
        clip_noise(flat, torch.ones(()), flat, 0.1)


# ------------------------------------------------- federated uplink channel
# Leaf sizes: one whole 2048-element tile of the reference's layout, and two
# ragged ones (the reference pads them with zeros; the port's kernels mask
# the tail). The plain versions do the reference's fp32 operations in the
# same order, so top-k, int8 and the clip are held bitwise; the norm is a
# sum taken in another order: 1e-6 relative. With noise, XLA's CPU compiler
# contracts x·scale + (σ·noise) into one FMA where the port (kernel and
# plain version alike) rounds the product first: within one ulp of x·scale
# plus one of the result.
CHANNEL_SIZES = (2048, 1000, 300)
# Top-k and int8 inputs: continuous data with planted ties, negative zeros
# and zeros; the sync's kind of update (a bf16-grid difference times a clip
# scale, whose k-th magnitude ties in most blocks); and that update with
# edge blocks (all zeros, 1 or 2 nonzeros, int8 half steps) planted.
CHANNEL_KINDS = ("randn", "bf16_update", "edge_blocks")
CHANNEL_INPUTS = [pytest.param(n, kind, id=str(n) if kind == "randn" else f"{n}-{kind}")
                  for kind in CHANNEL_KINDS for n in CHANNEL_SIZES]


def _channel_input(n, seed, scale=1.0, kind="randn"):
    rng = np.random.default_rng(seed)
    if kind != "randn":
        p = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) * 0.02
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        x = channel_cases.bf16_grid_update(p, g, clip=0.37 * scale)
        if kind == "edge_blocks":
            x = channel_cases.plant_edge_blocks(x)
        return x.numpy()
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    x[5:9] = x[4]                    # ties
    x[9:13] = -0.0                   # negative zeros: |x| is +0, as the kernels' bits say
    x[256:300] = 0.0                 # a run of zeros (a whole block at n >= 512)
    if n > 768:
        x[512:768] = 0.0
    return x


@pytest.mark.parametrize("n,kind", CHANNEL_INPUTS)
@pytest.mark.parametrize("k", [1, 3, 26, 256])
def test_topk_plain_matches_reference_and_pallas(n, k, kind):
    from repro.core.compression import topk_block_sparsify
    from repro.kernels import ops as jops

    x = _channel_input(n, k, kind=kind)
    got = ops.topk_sparsify_leaf(torch.from_numpy(x), k / 256).numpy()
    for use_kernel in (False, True):
        want = jops.topk_sparsify_leaf(_to_jax(x, np.float32), k / 256,
                                       use_kernel=use_kernel, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(topk_block_sparsify(_to_jax(x, np.float32),
                                                                      k / 256)))


@pytest.mark.parametrize("n,kind", CHANNEL_INPUTS)
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_int8_roundtrip_plain_matches_reference_and_pallas(n, scale, kind):
    from repro.core.compression import int8_roundtrip
    from repro.kernels import ops as jops

    x = _channel_input(n, 3, scale, kind)
    got = ops.int8_roundtrip_leaf(torch.from_numpy(x)).numpy()
    for use_kernel in (False, True):
        want = jops.int8_roundtrip_leaf(_to_jax(x, np.float32), use_kernel=use_kernel,
                                        interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(int8_roundtrip(_to_jax(x, np.float32))))


@pytest.mark.parametrize("n", CHANNEL_SIZES)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_sq_norm_plain_matches_reference_and_pallas(n, dtype):
    from repro.kernels import ops as jops

    tree = {"a": _channel_input(n, 4), "b": _channel_input(n + 17, 5, 0.1)}
    got = ops.tree_sq_norm({k: _to_torch(v, dtype) for k, v in tree.items()}).item()
    for use_kernel in (False, True):
        want = float(jops.tree_sq_norm({k: _to_jax(v, dtype) for k, v in tree.items()},
                                       use_kernel=use_kernel, interpret=True))
        assert got == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("n", CHANNEL_SIZES)
@pytest.mark.parametrize("stddev", [0.0, 0.3])
def test_clip_noise_plain_matches_reference_and_pallas(n, stddev):
    from repro.kernels import dp_clip as jdp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    x = _channel_input(n, 6)
    noise = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    scale = np.float32(0.37)
    got = ops.clip_noise(torch.from_numpy(x), torch.tensor(scale), torch.from_numpy(noise),
                         stddev).numpy()
    tiles, _ = jops._to_tiles(_to_jax(x, np.float32))
    ntiles, _ = jops._to_tiles(_to_jax(noise, np.float32))
    for fn in (lambda *a: jdp.clip_noise(*a, interpret=True), jref.clip_noise_ref):
        want = np.asarray(fn(tiles, jnp_f32(scale), ntiles, stddev)).ravel()[:n]
        if stddev == 0.0:
            np.testing.assert_array_equal(got, want)
        else:  # XLA's CPU compiler fuses x·scale + (σ·noise) into one FMA
            ulp = np.spacing(np.abs(x * scale)) + np.spacing(np.abs(want))
            assert np.all(np.abs(got - want) <= ulp)
    if stddev == 0.0:      # the clip alone reads no noise: x·scale, as privacy.clip_update
        clip = ops.clip_noise(torch.from_numpy(x), torch.tensor(scale)).numpy()
        np.testing.assert_array_equal(clip, np.asarray(_to_jax(x, np.float32) * scale))


def jnp_f32(v):
    import jax.numpy as jnp

    return jnp.float32(v)


# ---------------------------------------------------------------- card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd", [(1, 64), (4, 128), (2, 32), (4, 160), (3, 128)])
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


@pytest.mark.parametrize("n", [300, 2048 * 5 + 3, 1 << 20])
def test_channel_kernels_match_plain_versions_cuda(sm90, n):
    """The four channel kernels against their plain versions on the card:
    top-k, int8 and clip/noise bitwise, the norm within 1e-6 relative."""
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=gen)
    x[5:9] = x[4]
    x = x.cuda()
    for k in (1, 3, 26, 256):
        assert torch.equal(ops.topk_sparsify_leaf(x, k / 256), ref.topk_sparsify_ref(x, k))
    for scale in (1e-3, 1.0, 1e3):
        assert torch.equal(ops.int8_roundtrip_leaf(x * scale), ref.int8_roundtrip_ref(x * scale))
    noise = torch.randn(n, generator=gen).cuda()
    s = torch.tensor(0.37, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        want = ref.sq_norm_ref(xd).item()
        assert ops.sq_norm(xd).item() == pytest.approx(want, rel=1e-6, abs=0)
        assert torch.equal(ops.clip_noise(xd, s, noise, 0.3), ref.clip_noise_ref(xd, s, noise, 0.3))
        assert torch.equal(ops.clip_noise(xd, s), ref.clip_noise_ref(xd, s))


@pytest.mark.parametrize("n", [2048 * 5 + 3, 1_000_077])
def test_block_kernels_on_the_sync_kind_of_update_cuda(sm90, n):
    """Top-k and int8 bitwise against their plain versions on the sync's
    kind of update (its k-th magnitude ties in most blocks) and on it with
    edge blocks (all zeros, 1 or 2 nonzeros, int8 half steps), at a ragged
    length and as a view 4 bytes off a 16-byte boundary. The planted faults
    (top-k keeping exactly k per block; int8 rounding half away from zero)
    must differ."""
    gen = torch.Generator().manual_seed(n)
    u = channel_cases.bf16_grid_update(torch.randn(n + 1, generator=gen) * 0.02,
                                       torch.randn(n + 1, generator=gen)).cuda()
    edge = channel_cases.plant_edge_blocks(u)
    for x in (u[:n], edge[:n], edge[1:]):
        for k in (1, 3, 26, 256):
            assert torch.equal(ops.topk_sparsify_leaf(x, k / 256), ref.topk_sparsify_ref(x, k))
        assert torch.equal(ops.int8_roundtrip_leaf(x), ref.int8_roundtrip_ref(x))
        assert not torch.equal(ref.topk_sparsify_ref(x, 3), channel_cases.topk_exact_k(x, 3))
    for x in (edge[:n], edge[1:]):
        assert not torch.equal(ref.int8_roundtrip_ref(x), channel_cases.int8_half_away(x))


def test_channel_launch_counters_cuda(sm90):
    build.reset_launches()
    x = torch.randn(5000, device="cuda")
    ops.topk_sparsify_leaf(x, 0.01)
    ops.int8_roundtrip_leaf(x)
    ops.tree_sq_norm({"a": x, "b": x})
    ops.clip_noise(x, 0.5)
    assert {k: ops.LAUNCHES[k] for k in ("topk_sparsify", "int8_roundtrip", "sq_norm",
                                         "clip_noise")} == {
        "topk_sparsify": 1, "int8_roundtrip": 1, "sq_norm": 2, "clip_noise": 1}
    with pytest.raises(TypeError, match="float32"):
        from repro_torch.kernels.topk_compress import topk_sparsify

        topk_sparsify(x.bfloat16(), 3)


# ------------------------------------------------------- int8 KV pages
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd", [(1, 64), (4, 128), (2, 32), (4, 160), (3, 128)])
def test_int8_kernels_match_plain_and_fp_kernels_cuda(sm90, dtype, g, hd):
    """The int8-pool decode and suffix kernels against their plain versions
    (fp32 within 1e-5, bf16 within 2e-2) and BITWISE against the fp kernels
    run over the dequantized pool (in-kernel dequant rounds to q's dtype,
    then the same math)."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    gen = torch.Generator().manual_seed(7 * g + hd)
    b, hkv, page, t_w, pages = 3, 2, 16, 6, 24

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    kq, ks = ref.kv_quant_ref(torch.randn(pages, page, hkv, hd, generator=gen).cuda())
    vq, vs = ref.kv_quant_ref(torch.randn(pages, page, hkv, hd, generator=gen).cuda())
    kd, vd = ref.dequant_pool_ref(kq, ks, dtype), ref.dequant_pool_ref(vq, vs, dtype)
    table = torch.zeros(b, t_w, dtype=torch.int32)
    table[0, :2] = torch.tensor([5, 9])
    table[1, :] = torch.tensor([3, 11, 7, 20, 14, 2])
    table[2, :4] = torch.tensor([5, 17, 1, 8])
    table = table.cuda()
    q = rnd(b, hkv, g, hd)
    pos = torch.tensor([20, t_w * page + 9, 50], dtype=torch.int32, device="cuda")
    for window in (0, 7):
        out = ops.paged_decode_attention(q, kq, vq, pos, table, window, k_scale=ks, v_scale=vs)
        assert torch.equal(out, ops.paged_decode_attention(q, kd, vd, pos, table, window))
        torch.testing.assert_close(
            out.float(), ref.paged_decode_int8_ref(q, kq, vq, ks, vs, pos, table, window).float(),
            rtol=0, atol=tol)
    for s in (8, 100):
        qs, ksuf, vsuf = rnd(b, s, hkv, g, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
        starts = torch.tensor([0, 33, 48], dtype=torch.int32, device="cuda")
        for width in (3, 6):
            out = ops.suffix_prefill_attention(qs, ksuf, vsuf, kq, vq, table, starts,
                                               prefix_width=width, pool_k_scale=ks,
                                               pool_v_scale=vs)
            assert torch.equal(out, ops.suffix_prefill_attention(
                qs, ksuf, vsuf, kd, vd, table, starts, prefix_width=width))
            torch.testing.assert_close(
                out.float(), ref.suffix_prefill_int8_ref(qs, ksuf, vsuf, kq, vq, ks, vs, table,
                                                         starts, prefix_width=width).float(),
                rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_encode_matches_plain_version_cuda(sm90, dtype):
    """int8_encode bitwise equal to the plain version, q and scale, over
    rows of 256 at three magnitudes, and a ragged leaf."""
    from repro_torch.kernels.quantize import int8_encode

    gen = torch.Generator().manual_seed(11)
    for scale in (1e-3, 1.0, 1e3):
        x = (torch.randn(777, 256, generator=gen) * scale).to("cuda", dtype)
        x[1] = 0
        got = int8_encode(x)
        want = ref.int8_encode_ref(x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    leaf = torch.randn(256 * 40 + 77, generator=gen).cuda()
    q, s, n = ops.int8_encode_leaf(leaf)
    wq, ws = ref.int8_encode_ref(ref._blocks(leaf))
    assert n == leaf.numel() and torch.equal(q, wq) and torch.equal(s, ws)


def test_int8_launch_counters_cuda(sm90):
    build.reset_launches()
    q = torch.randn(2, 2, 1, 64, device="cuda")
    kq, ks = ref.kv_quant_ref(torch.randn(4, 16, 2, 64, device="cuda"))
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([20, 3], dtype=torch.int32, device="cuda")
    kv1 = torch.randn(2, 1, 2, 64, device="cuda")
    ops.kv_write_int8({"k": kq, "v": kq.clone(), "ks": ks, "vs": ks.clone()}, kv1, kv1, table,
                      pos)
    ops.paged_decode_attention(q, kq, kq, pos, table, k_scale=ks, v_scale=ks)
    qs, kv = torch.randn(2, 8, 2, 1, 64, device="cuda"), torch.randn(2, 8, 2, 64, device="cuda")
    ops.suffix_prefill_attention(qs, kv, kv, kq, kq, table, pos, prefix_width=2,
                                 pool_k_scale=ks, pool_v_scale=ks)
    assert {k: ops.LAUNCHES[k] for k in ("int8_encode", "kv_write_int8", "paged_decode_int8",
                                         "suffix_prefill_int8", "paged_decode")} == {
        "int8_encode": 0, "kv_write_int8": 1, "paged_decode_int8": 1, "suffix_prefill_int8": 1,
        "paged_decode": 0}
    with pytest.raises(TypeError, match="int8"):
        ops.paged_decode_attention(q, kq.float(), kq.float(), pos, table, k_scale=ks,
                                   v_scale=ks)
    assert ops.LAUNCHES["paged_decode_int8"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd", [(1, 64), (4, 128), (2, 32), (4, 160), (3, 128)])
def test_ring_kernels_match_plain_and_each_other_cuda(sm90, dtype, g, hd):
    """``paged_decode_ring`` and ``swa_decode`` against their plain versions
    (tolerances as above), over rings of 256 (pages of 256, or 64 and 128
    when asked) and of 40 (one page, a ragged tile): rows short of the ring,
    wrapped, per-row and scalar positions, windows 0 and 7. The two kernels
    are BITWISE equal, the page size changes no bit, and neither does the
    layout: the table kernel over the same keys in pool pages of 8 gives the
    same bits."""
    from repro_torch.kernels.paged_decode import paged_decode_ring
    from repro_torch.kernels.swa_decode import swa_decode

    tol = 1e-5 if dtype == torch.float32 else 2e-2
    gen = torch.Generator().manual_seed(g * hd + 1)
    for cap in (256, 40):
        q = torch.randn(3, 2, g, hd, generator=gen).to("cuda", dtype)
        k, v = (torch.randn(3, cap, 2, hd, generator=gen).to("cuda", dtype) for _ in "kv")
        for pos in ([5, cap + 9, 2 * cap - 1], [cap + 3] * 3, [70, 3, 200]):
            pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
            for window in (0, 7):
                swa = swa_decode(q, k, v, pos, window)
                torch.testing.assert_close(
                    swa.float(), ref.swa_decode_ref(q, k, v, pos, window).float(), rtol=0,
                    atol=tol)
                for page in ((0, 64, 128) if cap == 256 else (0,)):
                    torch.testing.assert_close(paged_decode_ring(q, k, v, pos, window, page=page),
                                               swa, rtol=0, atol=0)
                table = (torch.arange(3 * cap // 8, dtype=torch.int32) + 1).flip(0)
                table = table.reshape(3, cap // 8).cuda()
                pools = [torch.zeros(3 * cap // 8 + 1, 8, 2, hd, dtype=dtype, device="cuda")
                         for _ in "kv"]
                for pool, ring in zip(pools, (k, v)):
                    pool[table.long().reshape(-1)] = ring.reshape(-1, 8, 2, hd)
                torch.testing.assert_close(ops.paged_decode_attention(q, *pools, pos, table, window),
                                           swa, rtol=0, atol=0)
    # rings long enough to split into ranges of split_len(C, hd) slots (at
    # C 2048: 512 / 256 / 128 at hd 32 / 64 / 128): rows ending mid-range,
    # on a range boundary, and wrapped; and long_500k's shape (B 1, C 8192,
    # pos 524287), cut to 2 kv heads. Same tolerances, same bitwise checks.
    for cap, b in ((2048, 4), (8192, 1)):
        split = split_len(cap, hd)
        q = torch.randn(b, 2, g, hd, generator=gen).to("cuda", dtype)
        k, v = (torch.randn(b, cap, 2, hd, generator=gen).to("cuda", dtype) for _ in "kv")
        positions = ([[split - 1, 2 * split - 1, split + 37, cap + split - 1],
                      [3 * split + 5, 2 * split, cap + 3, 5]] if b > 1 else [[524287]])
        for pos in positions:
            pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
            for window in (0, 7, split // 2 + 3):
                swa = swa_decode(q, k, v, pos, window)
                torch.testing.assert_close(
                    swa.float(), ref.swa_decode_ref(q, k, v, pos, window).float(), rtol=0,
                    atol=tol)
                for page in (0, 64, 128, 256, 512):
                    assert torch.equal(paged_decode_ring(q, k, v, pos, window, page=page), swa)
                pk, pv, table = _ring_as_pool(k, v, 16)
                assert torch.equal(ops.paged_decode_attention(q, pk, pv, pos, table, window), swa)


def _ring_as_pool(k, v, page):
    """Rings (B, C, Hkv, hd) as a pool of pages of ``page`` keys at
    scattered physical pages (page 0 left as scratch) and the (B, C/page)
    table mapping each row's logical pages to them."""
    b, cap = k.shape[:2]
    t_w = cap // page
    table = (torch.randperm(b * t_w, generator=torch.Generator().manual_seed(cap)) + 1)
    table = table.reshape(b, t_w).to(torch.int32).to(k.device)
    pools = []
    for ring in (k, v):
        pool = ring.new_zeros(b * t_w + 1, page, *ring.shape[2:])
        pool[table.long().reshape(-1)] = ring.reshape(b * t_w, page, *ring.shape[2:])
        pools.append(pool)
    return pools[0], pools[1], table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd", [(1, 64), (4, 128), (2, 32), (4, 160), (3, 128)])
def test_decode_rows_are_batch_invariant_cuda(sm90, dtype, g, hd):
    """A row's output from a B 4 call is bitwise that row run alone (B 1),
    for the ring, swa and table entries over fp and int8 pools: the split
    depends on the capacity only, so a row's ranges do not depend on the
    rows beside it."""
    from repro_torch.kernels.paged_decode import paged_decode_ring
    from repro_torch.kernels.swa_decode import swa_decode

    gen = torch.Generator().manual_seed(3 * g + hd)
    b, cap = 4, 2048
    split = split_len(cap, hd)
    q = torch.randn(b, 2, g, hd, generator=gen).to("cuda", dtype)
    k, v = (torch.randn(b, cap, 2, hd, generator=gen).to("cuda", dtype) for _ in "kv")
    pos = torch.tensor([split - 1, 700, cap + 100, 5], dtype=torch.int32, device="cuda")
    pk, pv, table = _ring_as_pool(k, v, 16)
    kq, ks = ref.kv_quant_ref(pk)
    vq, vs = ref.kv_quant_ref(pv)
    entries = {
        "paged_decode_ring": lambda q, k, v, pos, table, w: paged_decode_ring(q, k, v, pos, w),
        "swa_decode": lambda q, k, v, pos, table, w: swa_decode(q, k, v, pos, w),
        "paged_decode": lambda q, k, v, pos, table, w: ops.paged_decode_attention(
            q, pk, pv, pos, table, w),
        "paged_decode_int8": lambda q, k, v, pos, table, w: ops.paged_decode_attention(
            q, kq, vq, pos, table, w, k_scale=ks, v_scale=vs),
    }
    for window in (0, 300):
        for name, fn in entries.items():
            batch = fn(q, k, v, pos, table, window)
            for r in range(b):
                alone = fn(*(x[r:r + 1].contiguous() for x in (q, k, v, pos, table)), window)
                assert torch.equal(batch[r:r + 1], alone), (name, window, r)


def test_ring_launch_counters_cuda(sm90):
    build.reset_launches()
    q = torch.randn(2, 2, 1, 64, device="cuda")
    ring = torch.randn(2, 128, 2, 64, device="cuda")
    pos = torch.tensor(7, dtype=torch.int32, device="cuda")   # a lockstep position
    for paged in (True, True, False):
        ops.swa_decode_attention(q, ring, ring, pos, 0, paged=paged)
    assert ops.LAUNCHES["paged_decode_ring"] == 2 and ops.LAUNCHES["swa_decode"] == 1
    with pytest.raises(ValueError, match="head dim"):
        ops.swa_decode_attention(torch.randn(2, 2, 1, 48, device="cuda"),
                                 torch.randn(2, 128, 2, 48, device="cuda"),
                                 torch.randn(2, 128, 2, 48, device="cuda"), 3, paged=True)
    assert ops.LAUNCHES["paged_decode_ring"] == 2


# ------------------------------------------- bf16 prefill on the tensor cores
# chip_smoke.py's gates: kernel vs plain max abs error relative to the RMS
# of the plain output.
RTOL = {"bfloat16": 0.05, "float32": 1e-4}
LOG2E = 1.4426950408889634
BK_TC = 128   # keys per K/V tile of the tensor-core body


def _err_rms(out, want):
    w = want.float()
    return ((out.float() - w).abs().max() / w.pow(2).mean().sqrt()).item()


def _tc_prefill_emulation(q, k, v, window=0, p_terms=3):
    """The bf16 tensor-core flash prefill's rounding points, on the CPU:
    scores from the bf16 inputs summed in fp32, scale·log2(e) folded into
    them and exp2 for the exponential, masked scores NEG, the online softmax
    over tiles of 128 keys in fp32, P into P·V as three bf16 terms (hi =
    bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid); ``p_terms=1``: hi
    alone, the one rounding of most tensor-core flash attentions) with its
    sum l unrounded, fp32 accumulation, the output rounded to bf16."""
    b, s, hkv, g, hd = q.shape
    t = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = torch.tensor(hd**-0.5 * LOG2E, dtype=torch.float32)
    m = torch.full((b, hkv, g, s), ref.NEG)
    l = torch.zeros(b, hkv, g, s)
    o = torch.zeros(b, hkv, g, s, hd)
    qpos = torch.arange(s)[:, None]
    for k_lo in range(0, t, BK_TC):
        kk, vv = kf[:, k_lo:k_lo + BK_TC], vf[:, k_lo:k_lo + BK_TC]
        kpos = torch.arange(k_lo, k_lo + kk.shape[1])[None, :]
        live = kpos <= qpos
        if window > 0:
            live &= qpos - kpos < window
        sc = torch.einsum("bqkgd,bckd->bkgqc", qf, kk) * scale_log2
        sc = torch.where(live, sc, torch.full_like(sc, ref.NEG))
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(sc - mx[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None]
        for _ in range(p_terms):
            term = p.to(torch.bfloat16).float()
            o = o + torch.einsum("bkgqc,bckd->bkgqd", term, vv)
            p = p - term
        m = mx
    out = o / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,hkv,g,hd,window", [
    (2, 160, 2, 2, 32, 0),      # smoke widths (hd 32), ragged last tile
    (2, 160, 2, 2, 32, 40),
    (1, 300, 2, 1, 64, 0),      # the serving path's head dim, three tiles
    (1, 300, 2, 1, 64, 130),    # a window wider than a tile
    (1, 200, 1, 4, 128, 0),     # GQA at hd 128
    (1, 200, 1, 8, 64, 1),      # a window of one key
])
def test_tensor_core_rounding_points_stay_inside_the_bf16_gate(b, s, hkv, g, hd, window):
    """The bf16 kernel differs from the plain versions (fp32 softmax, fp32
    P·V) in where it rounds: bf16 products summed in fp32, exp2 of scores
    with scale·log2(e) folded in, the online rescaling per tile, and P as
    three bf16 terms (~24 bits). Each moves an output by ~1e-7 of itself
    before its bf16 rounding, as the SIMT body's fp32 arithmetic does, so
    kernel and plain version round to the same bf16 but for rare one-ulp
    flips: inside RTOL["bfloat16"] = 0.05 × RMS, where the sound readings on
    the card were <= 0.024. The emulation of those rounding points is held
    against the port's plain version and the JAX package's oracle at that
    gate, and the planted fault stays outside it."""
    from repro.kernels import ref as jref

    rng = np.random.default_rng(s + g + hd + window)
    q = rng.standard_normal((b, s, hkv, g, hd), np.float32)
    k = rng.standard_normal((b, s, hkv, hd), np.float32)
    v = rng.standard_normal((b, s, hkv, hd), np.float32)
    qt, kt, vt = (_to_torch(a, "bfloat16") for a in (q, k, v))
    got = _tc_prefill_emulation(qt, kt, vt, window)
    plain = ref.flash_prefill_ref(qt, kt, vt, window=window)
    oracle = torch.from_numpy(np.asarray(jref.flash_prefill_ref(
        *(_to_jax(a, "bfloat16") for a in (q, k, v)), causal=True, window=window),
        np.float32))
    assert got.shape == plain.shape
    assert _err_rms(got, plain) <= RTOL["bfloat16"]
    assert _err_rms(got, oracle) <= RTOL["bfloat16"]
    # the planted fault of chip_smoke.py (mask shifted by one key) stays
    # outside the gate at these shapes
    shifted = torch.cat([ref.flash_prefill_ref(qt[:, :1], kt[:, :1], vt[:, :1], window=window),
                         ref.flash_prefill_ref(qt[:, 1:], kt[:, :-1], vt[:, :-1],
                                               window=window)], 1)
    assert _err_rms(got, shifted) > RTOL["bfloat16"]


def test_one_bf16_rounding_of_p_would_cross_the_bf16_gate():
    """Why P goes into P·V as three bf16 terms: with one rounding (8 bits of
    p, as most tensor-core flash attentions keep) an early row's output
    (few keys, values of 1-4) moves by ~2**-9 of itself and its bf16
    rounding flips by one ulp, 0.0156 at a value above 2: here that is
    beyond RTOL["bfloat16"] × RMS of the serving path's shape (hd 64, a
    512-token bucket, 16 heads), where the three terms stay inside."""
    rng = np.random.default_rng(15)
    q = _to_torch(rng.standard_normal((1, 512, 16, 1, 64), np.float32), "bfloat16")
    k, v = (_to_torch(rng.standard_normal((1, 512, 16, 64), np.float32), "bfloat16")
            for _ in "kv")
    plain = ref.flash_prefill_ref(q, k, v)
    assert _err_rms(_tc_prefill_emulation(q, k, v, p_terms=1), plain) > RTOL["bfloat16"]
    assert _err_rms(_tc_prefill_emulation(q, k, v), plain) <= RTOL["bfloat16"]


@pytest.mark.parametrize("offset", [1, 4, 7])
def test_check_tma_refuses_misaligned_operands(offset):
    """The tensor-core kernels' operands start at 16-byte aligned addresses:
    a contiguous view that starts ``offset`` bf16 elements (2-14 bytes) past
    an aligned one is refused, the aligned views beside it pass."""
    x = torch.zeros(2 * 8 * 64 + 8, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    build.check_tma("t", q=x[:2 * 8 * 64].view(2, 8, 64), k=x[8:].view(2, 8, 64))
    with pytest.raises(ValueError, match="k must start at a 16-byte aligned"):
        build.check_tma("t", q=x[8:].view(2, 8, 64),
                        k=x[offset:offset + 2 * 8 * 64].view(2, 8, 64))


def _prefill_case(gen, dtype, b, s, hkv, g, hd):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    return rnd(b, s, hkv, g, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)


def _suffix_tables(gen, page, n_pages, t_w=6):
    """Rows 0-2 at starts 0, page-unaligned (37) and beyond the prefix
    width's 3 pages (5 pages and 3 keys); row 2's first page aliases row
    1's; scratch page 0 past each row's pages."""
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    table = torch.zeros(3, t_w, dtype=torch.int32)
    table[1, :2] = perm[:2]
    table[2, :] = torch.cat([perm[:1], perm[2:7]])
    starts = torch.tensor([0, 37, 5 * page + 3], dtype=torch.int32)
    return table.cuda(), starts.cuda()


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 128, 160])
def test_bf16_prefill_tensor_core_kernels_match_plain_cuda(sm90, hd, g):
    """The bf16 tensor-core flash and suffix prefill against their plain
    versions within RTOL["bfloat16"] of the plain output's RMS: ragged S
    (100, 129, 1000), windows 0, 1, 40 and 4096; suffix rows at starts 0,
    page-unaligned and beyond the prefix width, pages of 12, 16 and 256;
    suffix_prefill_int8 BITWISE equal to suffix_prefill over the pool
    dequantized to bf16, and within the gate of its plain version."""
    dt, tol = torch.bfloat16, RTOL["bfloat16"]
    gen = torch.Generator().manual_seed(hd * 10 + g)
    for s in (100, 129, 1000):
        q, k, v = _prefill_case(gen, dt, 2, s, 2, g, hd)
        for window in (0, 1, 40, 4096):
            out = ops.flash_prefill_attention(q, k, v, window=window)
            want = ref.flash_prefill_ref(q, k, v, window=window)
            assert _err_rms(out, want) <= tol, (s, window)
    for page in (12, 16, 256):
        n_pages = 8
        kp, vp = (torch.randn(n_pages, page, 2, hd, generator=gen).to("cuda", dt) for _ in "kv")
        kq, ks = ref.kv_quant_ref(kp)
        vq, vs = ref.kv_quant_ref(vp)
        kd, vd = ref.dequant_pool_ref(kq, ks, dt), ref.dequant_pool_ref(vq, vs, dt)
        table, starts = _suffix_tables(gen, page, n_pages)
        for s in (64, 129):
            q, ksuf, vsuf = _prefill_case(gen, dt, 3, s, 2, g, hd)
            for width in (3, 6):
                out = ops.suffix_prefill_attention(q, ksuf, vsuf, kp, vp, table, starts,
                                                   prefix_width=width)
                want = ref.suffix_prefill_ref(q, ksuf, vsuf, kp, vp, table, starts,
                                              prefix_width=width)
                assert _err_rms(out, want) <= tol, (page, s, width)
                out8 = ops.suffix_prefill_attention(q, ksuf, vsuf, kq, vq, table, starts,
                                                    prefix_width=width, pool_k_scale=ks,
                                                    pool_v_scale=vs)
                assert torch.equal(out8, ops.suffix_prefill_attention(
                    q, ksuf, vsuf, kd, vd, table, starts, prefix_width=width)), (page, s, width)
                want8 = ref.suffix_prefill_int8_ref(q, ksuf, vsuf, kq, vq, ks, vs, table, starts,
                                                    prefix_width=width)
                assert _err_rms(out8, want8) <= tol, (page, s, width)


@pytest.mark.parametrize("g,hd", [(1, 64), (4, 128), (8, 32), (4, 160), (3, 128)])
def test_fp32_prefill_stays_on_the_simt_body_cuda(sm90, g, hd):
    """float32 runs the SIMT body in fp32 FMAs: within RTOL["float32"] =
    1e-4 of the plain version's RMS, which TF32 (~3 digits) would miss."""
    gen = torch.Generator().manual_seed(g + hd)
    tol = RTOL["float32"]
    q, k, v = _prefill_case(gen, torch.float32, 2, 129, 2, g, hd)
    for window in (0, 40):
        assert _err_rms(ops.flash_prefill_attention(q, k, v, window=window),
                        ref.flash_prefill_ref(q, k, v, window=window)) <= tol
    kp, vp = (torch.randn(8, 16, 2, hd, generator=gen).cuda() for _ in "kv")
    table, starts = _suffix_tables(gen, 16, 8)
    q, ksuf, vsuf = _prefill_case(gen, torch.float32, 3, 64, 2, g, hd)
    assert _err_rms(ops.suffix_prefill_attention(q, ksuf, vsuf, kp, vp, table, starts,
                                                 prefix_width=3),
                    ref.suffix_prefill_ref(q, ksuf, vsuf, kp, vp, table, starts,
                                           prefix_width=3)) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd", [(1, 32), (2, 32), (1, 64), (2, 64)])
def test_noncausal_flash_prefill_matches_plain_cuda(sm90, dtype, g, hd):
    """``flash_prefill(causal=False)`` in both bodies (float32: SIMT; bf16:
    tensor cores) against its plain version within RTOL of the plain
    output's RMS, at whisper's shapes: S = T = 1500 (the encoder), 64 and 1
    queries against 1500 frames (cross-attention), and ragged S / T (the
    last key tile crossing T); dropping the last key must read outside."""
    gen = torch.Generator().manual_seed(g * 1000 + hd)
    tol = RTOL[str(dtype).split(".")[1]]
    for s, t in ((1500, 1500), (64, 1500), (1, 1500), (100, 129), (129, 65)):
        q = torch.randn(2, s, 2, g, hd, generator=gen).to("cuda", dtype)
        k, v = (torch.randn(2, t, 2, hd, generator=gen).to("cuda", dtype) for _ in "kv")
        out = ops.flash_prefill_attention(q, k, v, causal=False)
        want = ref.flash_prefill_ref(q, k, v, causal=False)
        assert _err_rms(out, want) <= tol, (s, t)
        short = ref.flash_prefill_ref(q, k[:, :-1], v[:, :-1], causal=False)
        assert _err_rms(out, short) > tol or t > 200, (s, t)
    with pytest.raises(ValueError, match="window"):
        ops.flash_prefill_attention(q, k, v, causal=False, window=8)


def test_prefill_libraries_run_on_tensor_cores_cuda(sm90):
    """The built prefill libraries hold tensor-core wgmma (HGMMA) and TMA
    loads (UTMALDG); the tensor-core wrappers refuse a misaligned operand and
    a group a block cannot hold, and count only launches."""
    for source in ("flash_prefill", "flash_suffix_prefill"):
        assert {"HGMMA", "UTMALDG"} <= build.sass_opcodes(source), source
    build.reset_launches()
    x = torch.randn(2 * 16 * 2 * 64 + 1, device="cuda").bfloat16()
    kv = x[1:].view(2, 16, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_prefill_attention(kv[:, :, :, None].contiguous(), kv, kv)
    with pytest.raises(ValueError, match="group 65"):
        ops.flash_prefill_attention(torch.zeros(1, 4, 1, 65, 64, device="cuda"),
                                    torch.zeros(1, 4, 1, 64, device="cuda"),
                                    torch.zeros(1, 4, 1, 64, device="cuda"))
    assert ops.LAUNCHES["flash_prefill"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hd256_kernels_match_plain_cuda(sm90, dtype):
    """recurrentgemma-2b's local attention (hd 256, 10 query heads over 1 kv
    head): ``paged_decode_ring`` and ``swa_decode`` against their plain
    versions over rings of 2048 (rows short of the ring, on a range
    boundary, wrapped; windows 0 and 2048), BITWISE equal to each other at
    every page size and batch invariant; ``flash_prefill`` (ragged S,
    windows 0, 40 and 2048) within the gate of its plain version. The table
    decode refuses hd 256 (no paged pool serves the hybrid)."""
    from repro_torch.kernels.paged_decode import paged_decode_ring
    from repro_torch.kernels.swa_decode import swa_decode

    gen = torch.Generator().manual_seed(256)
    tol = RTOL[{torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]]
    b, cap, g, hd = 4, 2048, 10, 256
    q = torch.randn(b, 1, g, hd, generator=gen).to("cuda", dtype)
    k, v = (torch.randn(b, cap, 1, hd, generator=gen).to("cuda", dtype) for _ in "kv")
    split = split_len(cap, hd)
    pos = torch.tensor([split - 1, 700, cap + 100, 3 * cap + 5], dtype=torch.int32,
                       device="cuda")
    for window in (0, 2048):
        swa = swa_decode(q, k, v, pos, window)
        assert _err_rms(swa, ref.swa_decode_ref(q.float(), k.float(), v.float(), pos,
                                                window)) <= tol
        for page in (0, 64, 256, 512):
            assert torch.equal(paged_decode_ring(q, k, v, pos, window, page=page), swa)
        for r in range(b):
            alone = swa_decode(*(x[r:r + 1].contiguous() for x in (q, k, v, pos)), window)
            assert torch.equal(alone, swa[r:r + 1])
    pk, pv, table = _ring_as_pool(k, v, 16)
    with pytest.raises(ValueError, match="head dim 256"):
        ops.paged_decode_attention(q, pk, pv, pos, table)
    for s in (100, 1000):
        qs, ks, vs = _prefill_case(gen, dtype, 2, s, 1, g, hd)
        for window in (0, 40, 2048):
            out = ops.flash_prefill_attention(qs, ks, vs, window=window)
            exact = ref.flash_prefill_ref(qs.float(), ks.float(), vs.float(), window=window)
            err = (out.float() - exact).abs()
            if dtype == torch.bfloat16:
                # elements within one bf16 ulp of the exact output rounded to
                # bf16 are rounding flips, left out (chip_smoke.py's
                # _flip_gated): the early rows' outputs (few keys) are many
                # times the RMS, so one ulp there is ~0.13 x RMS
                ulps = (out.view(torch.int16).int()
                        - exact.to(dtype).view(torch.int16).int()).abs()
                err = torch.where(ulps > 1, err, torch.zeros_like(err))
            assert (err.max() / exact.pow(2).mean().sqrt()).item() <= tol, (s, window)
