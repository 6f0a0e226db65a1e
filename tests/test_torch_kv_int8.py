"""int8 KV pages in the port, against the reference.

Layers, from the quantizer up:

* The row quantizer (``ref.kv_quant_ref`` / ``int8_encode_ref``,
  ``ops.int8_encode_leaf`` on the CPU) is held BITWISE
  against ``repro.kernels.quantize.kv_quant`` and the reference's oracle
  ``int8_encode_ref``: the same IEEE quotient max|x| / 127, half-to-even
  rounding and clip, over rows of 256 and of each head dim, including exact
  .5 ties. The Pallas ``int8_encode`` (interpret mode) runs under ``jit``,
  where XLA's CPU compiler turns the division by 127 into a multiply by its
  reciprocal: its scale may sit one ulp from the IEEE quotient. Rows whose
  scales agree are held bitwise; the others to one ulp of scale and one
  step of q.
* The int8 attention plain versions are held against the reference's int8
  oracles and the Pallas kernels' scale branches (interpret mode) at the
  tolerances of ``tests/test_torch_kernels.py``: float32 1e-5 (summation
  order only), bfloat16 1e-2 (one bf16 ulp of an O(1) output).
* The port's int8 engine against the reference's int8 engine on bridged
  float32 smoke weights: identical greedy tokens and pool counters on the
  traces of ``tests/test_kv_int8.py`` (agreement with fp, preemption
  resume, prefix sharing warm == cold). At float32 the two packages' k/v
  differ by ~1e-6 relative (summation order), and the reference's engine
  quantizes under ``jit`` (the reciprocal multiply above), so a quantized
  element may land one step apart where x / scale sits next to a .5
  boundary: after a
  trace the two pools agree on every page but scratch page 0 within
  |Δq| <= 1, and their scales within 1e-5 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops as jops
from repro.kernels import quantize as jquant
from repro.kernels import ref as jref
from repro.launch import engine as ref_engine
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import engine as port_engine
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
TOL = {np.float32: 1e-5, "bfloat16": 1e-2}
PAGE, T_W, P = 8, 4, 12
COUNTERS = ("prefill_tokens", "prefix_hit_pages", "cow_copies", "suffix_dispatches",
            "cold_dispatches", "preemptions")


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(a, dtype=np.float32):
    t = torch.from_numpy(np.array(a))
    if t.is_floating_point():
        t = t.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return t


def _assert_matches_pallas_encode(q, s, pq, ps):
    """Bitwise where the Pallas scale is the IEEE quotient; within one ulp
    of scale and one step of q where it is the reciprocal multiply's."""
    q, s = q.numpy(), s.numpy()
    pq, ps = np.asarray(pq)[: len(s)], np.asarray(ps)[: len(s), 0]
    same = s == ps
    np.testing.assert_array_equal(q[same], pq[same])
    assert np.all(np.abs(s - ps) <= np.spacing(s))
    assert np.all(np.abs(q.astype(np.int32) - pq.astype(np.int32)) <= 1)
    assert same.mean() > 0.5


def _rows(n, r, seed, scale=1.0):
    """Normal rows with an all-zero row, and one row whose max is 127 so
    that x / scale hits exact .5 ties (2.5, -3.5, 0.5: half to even)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, r)) * scale).astype(np.float32)
    x[1] = 0.0
    x[2, :4] = [127.0, 2.5, -3.5, 0.5]
    x[2, 4:] = 0.0
    return x


# ------------------------------------------------------------------ quantizer
@pytest.mark.parametrize("r", [32, 64, 128, 256])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_kv_quant_bitwise_matches_reference(r, scale):
    x = _rows(9, r, r, scale)
    q, s = ref.kv_quant_ref(torch.from_numpy(x))
    jq, js = jquant.kv_quant(_jax(x, np.float32))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (9,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q[2, :4].numpy(), [127, 2, -4, 0])   # half to even
    eq, es = jref.int8_encode_ref(_jax(x, np.float32))
    q2, s2 = ref.int8_encode_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(eq))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(es)[:, 0])


def test_kv_quant_bf16_and_dequant_match_reference():
    x = _rows(6, 64, 4).reshape(2, 3, 64)
    xb = _torch(x, "bfloat16")
    q, s = ref.kv_quant_ref(xb)
    jq, js = jquant.kv_quant(_jax(x, "bfloat16"))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = ref.kv_dequant_ref(q, s, tdt).float().numpy()
        want = np.asarray(jquant.kv_dequant(jq, js, jdt), np.float32)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, ref.dequant_pool_ref(q, s, tdt).float().numpy())


@pytest.mark.parametrize("n", [256 * 11, 2048, 1000, 300])
def test_int8_encode_leaf_matches_reference_and_pallas(n):
    """The wire form of one leaf: the reference pads the rows to a multiple
    of 8 (TPU tiling; its extra rows are q 0, scale 1e-12) and keeps the
    scale as (nb, 1); the port's nb rows equal its first nb."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[256:300] = 0.0
    q, s, m = ops.int8_encode_leaf(torch.from_numpy(x))
    nb = -(-n // 256)
    assert m == n and q.shape == (nb, 256) and s.shape == (nb,)
    jq, js, jn = jops.int8_encode_leaf(_jax(x, np.float32), use_kernel=False)
    assert jn == n
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq)[:nb])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[:nb, 0])
    assert not np.asarray(jq)[nb:].any()
    jq, js, _ = jops.int8_encode_leaf(_jax(x, np.float32), use_kernel=True, interpret=True)
    _assert_matches_pallas_encode(q, s, jq, js)
    assert not np.asarray(jq)[nb:].any()
    # the Pallas encoder on rows of 256 directly
    rows = _rows(10, 256, 5)
    pq, ps = jquant.int8_encode(_jax(rows, np.float32), interpret=True)
    _assert_matches_pallas_encode(*ref.int8_encode_ref(torch.from_numpy(rows)), pq, ps)


# ------------------------------------------------------- int8 attention
def _tables(rng, b):
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((b, T_W), np.int32)
    table[0, :2] = perm[:2]
    table[1, :] = perm[2:6]
    if b > 2:
        table[2, :3] = [perm[0], perm[6], perm[7]]   # aliases row 0's first page
    return table


def _int8_pool(rng, hd):
    """An int8 pool and its scales, quantized by the reference from normal
    k/v with per-row magnitudes that vary."""
    x = rng.standard_normal((P, PAGE, 2, hd)).astype(np.float32)
    x *= rng.uniform(0.2, 3.0, (P, PAGE, 2, 1)).astype(np.float32)
    q, s = jquant.kv_quant(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


CASES = [(g, hd, dt) for g in (1, 4) for hd in (32, 128) for dt in (np.float32, "bfloat16")]


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("g,hd,dtype", CASES)
def test_paged_decode_int8_plain_matches_reference_and_pallas(g, hd, dtype):
    from repro.kernels.paged_decode import paged_decode

    rng = np.random.default_rng(g * hd)
    q = rng.standard_normal((3, 2, g, hd)).astype(np.float32)
    kq, ks = _int8_pool(rng, hd)
    vq, vs = _int8_pool(rng, hd)
    pos = np.array([9, T_W * PAGE + 5, 20], np.int32)   # row 1 has wrapped
    table = _tables(rng, 3)
    for window in (0, 5):
        got = ref.paged_decode_int8_ref(_torch(q, dtype), *map(_torch, (kq, vq, ks, vs, pos,
                                                                      table)), window)
        assert got.dtype == _torch(q, dtype).dtype
        jargs = (_jax(q, dtype), kq, vq, ks, vs, pos, table, window)
        _close(got, jref.paged_table_decode_int8_ref(*jargs), dtype)
        want = paged_decode(_jax(q, dtype), kq, vq, pos, window, table=table, k_scale=ks,
                            v_scale=vs, interpret=True)
        _close(got, want, dtype)
        # the ops dispatch on a CPU tensor is the plain version, bitwise
        torch.testing.assert_close(
            ops.paged_decode_attention(_torch(q, dtype), _torch(kq), _torch(vq), _torch(pos),
                                       _torch(table), window, k_scale=_torch(ks),
                                       v_scale=_torch(vs)), got, rtol=0, atol=0)


@pytest.mark.parametrize("g,hd,dtype", CASES)
def test_suffix_prefill_int8_plain_matches_reference_and_pallas(g, hd, dtype):
    from repro.kernels.flash_suffix_prefill import suffix_prefill

    rng = np.random.default_rng(7 + g * hd)
    n, s = 3, 8
    q = rng.standard_normal((n, s, 2, g, hd)).astype(np.float32)
    k_suf = rng.standard_normal((n, s, 2, hd)).astype(np.float32)
    v_suf = rng.standard_normal((n, s, 2, hd)).astype(np.float32)
    kq, ks = _int8_pool(rng, hd)
    vq, vs = _int8_pool(rng, hd)
    table = _tables(rng, n)
    starts = np.array([0, 11, 16], np.int32)
    for width in (2, 4):
        targs = (_torch(q, dtype), _torch(k_suf, dtype), _torch(v_suf, dtype),
                 *map(_torch, (kq, vq, ks, vs, table, starts)))
        got = ref.suffix_prefill_int8_ref(*targs, prefix_width=width)
        jq, jk, jv = (_jax(a, dtype) for a in (q, k_suf, v_suf))
        _close(got, jref.suffix_prefill_int8_ref(jq, jk, jv, kq, vq, ks, vs, table, starts,
                                                 prefix_width=width), dtype)
        want = suffix_prefill(jq, jk, jv, kq, vq, table, starts, prefix_width=width,
                              pool_k_scale=ks, pool_v_scale=vs, interpret=True)
        _close(got, want, dtype)
        torch.testing.assert_close(
            ops.suffix_prefill_attention(*targs[:5], table=targs[7], starts=targs[8],
                                         prefix_width=width, pool_k_scale=targs[5],
                                         pool_v_scale=targs[6]), got, rtol=0, atol=0)


def test_int8_kernel_wrappers_refuse_cpu_tensors_and_bad_pools():
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_suffix_prefill import suffix_prefill_int8
    from repro_torch.kernels.paged_decode import paged_decode_int8
    from repro_torch.kernels.quantize import int8_encode

    q = torch.zeros(2, 2, 1, 32)
    pool = torch.zeros(4, 8, 2, 32, dtype=torch.int8)
    sc = torch.ones(4, 8, 2)
    pos = torch.zeros(2, dtype=torch.int32)
    table = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_int8(q, pool, pool, sc, sc, pos, table)
    qs, kv = torch.zeros(2, 8, 2, 1, 32), torch.zeros(2, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        suffix_prefill_int8(qs, kv, kv, pool, pool, sc, sc, table, pos, prefix_width=1)
    with pytest.raises(ValueError, match="CUDA"):
        int8_encode(torch.zeros(4, 256))
    # the pool/scale type rules, checked before any launch
    with pytest.raises(TypeError, match="int8"):
        build.check_pool("t", q, pool.float(), pool.float(), sc, sc)
    with pytest.raises(ValueError, match="float32"):
        build.check_pool("t", q, pool, pool, sc[..., :1], sc)
    with pytest.raises(ValueError, match="both"):
        build.check_pool("t", q, pool, pool, sc, None)
    build.check_pool("t", q, pool, pool, sc, sc)
    build.check_pool("t", q, q, q, None, None)


# ------------------------------------------------------------- model layer
def _f32_configs():
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(ref_smoke_config(ARCH), dtype="float32"))


def test_init_paged_cache_int8_layout_matches_reference():
    cfg, ref_cfg = _f32_configs()
    tree = numpy_params(cfg, 0)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    jc = ref_build_model(ref_cfg).init_paged_cache(ref_params, 3, 9, 4, 8, kv_dtype="int8")
    tc = build_model(cfg).init_paged_cache(3, 9, 4, 8, device="cpu", kv_dtype="int8")
    for name in ("k", "v", "ks", "vs", "pos", "table"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype), name
        assert not tc[name].any()
    assert tc["k"].dtype == torch.int8 and tc["ks"].shape == tc["k"].shape[:-1]
    assert "ks" not in build_model(cfg).init_paged_cache(3, 9, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        build_model(cfg).init_paged_cache(3, 9, 4, 8, device="cpu", kv_dtype="int4")


# ------------------------------------------------------------ engine layer
def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed + 1)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _serve_both(prompts, gen, **kw):
    cfg, ref_cfg = _f32_configs()
    tree = numpy_params(cfg, 0)
    ref_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    ref = ref_engine.ServeEngine(ref_build_model(ref_cfg), ref_params, paged_cache=True, **kw)
    ref_out = ref.run([ref_engine.Request(uid=u, prompt=p, max_new_tokens=gen)
                       for u, p in enumerate(prompts)])
    port = port_engine.ServeEngine(build_model(cfg), params_from_numpy(tree, cfg, "cpu"),
                                   device="cpu", paged_cache=True, **kw)
    port_out = port.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=gen)
                         for u, p in enumerate(prompts)])
    assert [o.tokens for o in port_out] == [o.tokens for o in ref_out]
    for key in COUNTERS:
        assert port.pool_stats[key] == ref.pool_stats[key], key
    assert port.pool_stats["kv_dtype"] == ref.pool_stats["kv_dtype"] == kw.get("kv_dtype", "fp")
    return ref, ref_out, port, port_out


def _assert_pools_agree(ref, port):
    """Every page but scratch page 0: |Δq| <= 1, scales within 1e-5."""
    for name, sname in (("k", "ks"), ("v", "vs")):
        rq = np.asarray(ref.cache[name])[:, 1:].astype(np.int32)
        pq = port.cache[name][:, 1:].numpy().astype(np.int32)
        assert np.abs(rq - pq).max() <= 1, name
        rs = np.asarray(ref.cache[sname])[:, 1:]
        ps = port.cache[sname][:, 1:].numpy()
        np.testing.assert_allclose(ps, rs, rtol=1e-5, atol=0)


BASE = dict(num_slots=2, max_seq=14, page_size=4, kv_dtype="int8")


def test_int8_engine_matches_reference_and_agrees_with_fp():
    """Tokens and counters equal to the reference's int8 engine; against
    the port's own fp engine, greedy tokens agree on >= 60 % of requests
    (the reference's floor: quantized KV may move a logit across a tie)."""
    lens = [4, 8, 3, 7, 6]
    ref, _, port, outs = _serve_both(_prompts(lens), 6, **BASE)
    _assert_pools_agree(ref, port)
    _, _, _, fp_outs = _serve_both(_prompts(lens), 6, **dict(BASE, kv_dtype="fp"))
    agree = sum(a.tokens == b.tokens for a, b in zip(outs, fp_outs)) / len(outs)
    assert agree >= 0.6, f"int8 engine agreed with fp on only {agree:.0%} of requests"
    assert all(len(o.tokens) == 6 for o in outs)


def test_int8_preemption_resume_matches_reference_and_ample_pool():
    lens = [8, 8, 7]
    _, _, ample, ample_out = _serve_both(_prompts(lens), 6, **BASE)
    ref, _, tight, tight_out = _serve_both(_prompts(lens), 6, **dict(BASE, num_pages=6))
    assert tight.preemptions > 0 and ample.preemptions == 0
    assert [o.tokens for o in tight_out] == [o.tokens for o in ample_out]
    assert tight.pool.in_use == 0
    _assert_pools_agree(ref, tight)


def test_int8_prefix_sharing_warm_equals_cold_and_reference():
    p = _prompts([8])[0]
    kw = dict(BASE, num_slots=1)
    ref, _, warm, warm_out = _serve_both([p, p.copy()], 4, **dict(kw, prefix_cache=True))
    _, _, _, cold_out = _serve_both([p, p.copy()], 4, **kw)
    assert warm.pool_stats["prefix_hit_rate"] > 0 and warm.cow_copies > 0
    assert [o.tokens for o in warm_out] == [o.tokens for o in cold_out]
    _assert_pools_agree(ref, warm)


def test_int8_cow_split_copies_the_scale_planes():
    """A copy-on-write split of a shared int8 page copies q AND scales: the
    port's CoW'd page equals its source on every plane (the slot written
    into its last lane excepted)."""
    cfg, _ = _f32_configs()
    eng = port_engine.ServeEngine(
        build_model(cfg), params_from_numpy(numpy_params(cfg, 0), cfg, "cpu"),
        device="cpu", prefix_cache=True, paged_cache=True, **dict(BASE, num_slots=1))
    p = _prompts([8])[0]
    eng.run([port_engine.Request(uid=0, prompt=p, max_new_tokens=2)])
    src = eng.prefix.match(p)[-1]
    eng.submit(port_engine.Request(uid=1, prompt=p.copy(), max_new_tokens=2))
    eng._admit(0.0)
    dst = eng._slot_pages[0][-1]
    assert eng.cow_copies == 1 and dst != src
    for name in ("k", "v", "ks", "vs"):
        torch.testing.assert_close(eng.cache[name][:, dst, :3], eng.cache[name][:, src, :3],
                                   rtol=0, atol=0)
