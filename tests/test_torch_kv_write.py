"""The int8 KV pool's write (``kv_write_int8``) against the reference.

The port writes one layer's int8 pool in one call: the live tokens of k/v
quantized per kv head (s = max(max|x| / 127, 1e-12), q = clip(round(x / s),
±127)) and stored, q and scale, in their ring slots through the page table.
The reference writes the same pool in two places, mirrored here line by
line with its own functions (``repro.kernels.quantize.kv_quant``,
``repro.models.attention.fill_cache_rows``):

* the decode write (``src/repro/models/attention.py:497-516``): each row's
  one fresh token at ``(table[r, slot // page], slot % page)``, slot = pos
  mod T·page;
* the prefill write (``src/repro/models/transformer.py:588-603``): whole
  gathered ring rows requantized, the fresh (q, scale) kept only in the
  slots the round writes and every other slot scattered back with its
  original bits. The port writes only those slots, which leaves the same
  pool.

The plain version ``ref.kv_write_int8_ref`` is held BITWISE against both
run eagerly, on numpy-drawn inputs: rings that wrap, prefix pages two rows
share (which must keep their bits), a row longer than its ring, a row of
length 0, an all-zero head row (the 1e-12 floor) and exact .5 ties, at hd
32, 64 and 128 in float32 and bfloat16. Under ``jax.jit`` XLA's CPU compiler
turns the division by 127 into a multiply by its reciprocal, so the
reference's jitted decode write is held within one ulp of scale and one
step of q (bitwise where the scales agree).

Scratch page 0 is left out of every comparison. A decode step writes its
dead rows there, so two rows may hit one of its slots, and neither
``index_put_``, XLA's scatter nor the kernel orders such writes; no live
read dereferences the page.

The CUDA kernel is held bitwise against the plain version on the same
cases in ``test_kv_write_int8_kernel_matches_plain_version_cuda``, which
needs an sm_90 card and skips elsewhere. This module imports JAX and the
reference only inside the tests that use them, so on the card's machine
(no JAX) it runs with ``python -m pytest -q --noconftest
tests/test_torch_kv_write.py -k cuda``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref

PAGE, T_W, P, HKV = 8, 4, 24, 2
CAP = PAGE * T_W
HEAD_DIMS = (32, 64, 128, 160)
DTYPES = ("float32", "bfloat16")


@pytest.fixture
def sm90():
    """Skip unless an sm_90 (Hopper) card is present — decided here, at run
    time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")


# ------------------------------------------------------------------ inputs
def _pool(rng, hd):
    """A used pool: random int8 q and positive scales in every slot, so an
    untouched slot that changed shows."""
    q = lambda: rng.integers(-127, 128, (P, PAGE, HKV, hd), dtype=np.int8)  # noqa: E731
    s = lambda: rng.uniform(1e-3, 1e-1, (P, PAGE, HKV)).astype(np.float32)  # noqa: E731
    return {"k": q(), "v": q(), "ks": s(), "vs": s()}


def _kv(rng, n, s, hd):
    """Normal k/v (n, S, Hkv, hd) at a few scales, with an all-zero head row
    (the scale floor) and one whose max is 127 so x / scale hits exact .5
    ties (2.5, -3.5, 0.5: half to even). All are bf16-exact where it
    matters: the ties and the zeros."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((n, s, HKV, hd)).astype(np.float32)
        x *= np.float32(10.0) ** rng.integers(-3, 3, (n, s, HKV, 1)).astype(np.float32)
        x[0, 0, 0] = 0.0
        x[0, 0, 1] = 0.0
        x[0, 0, 1, :4] = [127.0, 2.5, -3.5, 0.5]
        out.append(x)
    return out


def decode_case(rng, hd):
    """Six rows, one token each at pos: row 1 and 2 wrapped (pos >= T·page),
    row 3 at the ring's last slot; rows 4 and 5 dead (their table rows all
    scratch page 0), both landing on page 0's slot 5."""
    pos = np.array([3, 37, 100, 31, 5, 5], np.int32)
    table = np.zeros((6, T_W), np.int32)
    table[:4] = rng.permutation(np.arange(1, P))[: 4 * T_W].reshape(4, T_W)
    k, v = _kv(rng, 6, 1, hd)
    return dict(pool=_pool(rng, hd), k=k, v=v, table=table, starts=pos, lengths=None)


def prefill_case(rng, hd):
    """Six rows of a round padded to S = 48:

    row 0: 20 tokens from slot 0 (pages 0-2 of its table, the last entry
           scratch);
    rows 1, 2: 10 and 16 tokens behind a 16-token prefix on two pages both
           rows share, which must keep their bits;
    row 3: 12 tokens from slot 28, wrapping its ring to slots 0-7;
    row 4: 45 tokens from slot 5, longer than its 32-slot ring: only its
           last 32 land, every slot once;
    row 5: 0 tokens (its one page untouched)."""
    own = iter(rng.permutation(np.arange(1, P)))
    a, b = next(own), next(own)
    table = np.array([[next(own), next(own), next(own), 0],
                      [a, b, next(own), next(own)],
                      [a, b, next(own), next(own)],
                      [next(own), next(own), next(own), next(own)],
                      [next(own), next(own), next(own), next(own)],
                      [next(own), 0, 0, 0]], np.int32)
    starts = np.array([0, 16, 16, 28, 5, 3], np.int32)
    lengths = np.array([20, 10, 16, 12, 45, 0], np.int32)
    k, v = _kv(rng, 6, 48, hd)
    return dict(pool=_pool(rng, hd), k=k, v=v, table=table, starts=starts, lengths=lengths)


def _torch_case(case, dtype, device="cpu"):
    dt = getattr(torch, dtype)
    pool = {key: torch.from_numpy(a.copy()).to(device) for key, a in case["pool"].items()}
    k, v = (torch.from_numpy(case[x]).to(device, dt) for x in ("k", "v"))
    idx = [torch.from_numpy(case[x]).to(device) if case[x] is not None else None
           for x in ("table", "starts", "lengths")]
    return pool, k, v, idx


def _assert_planes_equal(got, want):
    """Every plane bitwise, scratch page 0 left out (see the module
    docstring)."""
    for key in ("k", "v", "ks", "vs"):
        g, w = np.asarray(got[key])[1:], np.asarray(want[key])[1:]
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=key)


# ------------------------------------------- the reference's writes, mirrored
def _jax(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _ref_decode_write(pool, k, v, pos, table):
    """``src/repro/models/attention.py:497-516``, int8 branch: the one fresh
    token per kv head quantized and set at (phys_page, off)."""
    import jax.numpy as jnp
    from repro.kernels.quantize import kv_quant

    page = pool["k"].shape[1]
    cap = table.shape[1] * page
    slot = pos % cap
    rows = jnp.arange(k.shape[0])
    phys_page = table[rows, slot // page]
    off = slot % page
    kq, ksc = kv_quant(k[:, 0])
    vq, vsc = kv_quant(v[:, 0])
    return {"k": pool["k"].at[phys_page, off].set(kq),
            "v": pool["v"].at[phys_page, off].set(vq),
            "ks": pool["ks"].at[phys_page, off].set(ksc),
            "vs": pool["vs"].at[phys_page, off].set(vsc)}


def _ref_prefill_write(pool, k, v, table, starts, lengths):
    """``src/repro/models/transformer.py:588-603`` with the ``written`` mask
    (:488-494) and the gathers (:515-518) it reads: whole gathered rows
    through ``fill_cache_rows``, requantized, the fresh (q, scale) kept in
    written slots only, scattered back over the rows' pages."""
    import jax.numpy as jnp
    from repro.kernels.quantize import kv_dequant, kv_quant
    from repro.models import attention as attn

    ck, cv, cks, cvs = pool["k"], pool["v"], pool["ks"], pool["vs"]
    n, t_w = table.shape
    page, hkv, hd = ck.shape[1:]
    flat_pages = table.reshape(-1)
    cap_r = t_w * page
    ring = jnp.arange(cap_r)[None, :]
    c_rel = (ring - starts[:, None]) % cap_r
    written = c_rel <= (lengths[:, None] - 1)
    gkq = ck[flat_pages].reshape(n, t_w * page, hkv, hd)
    gvq = cv[flat_pages].reshape(n, t_w * page, hkv, hd)
    gks = cks[flat_pages].reshape(n, t_w * page, hkv)
    gvs = cvs[flat_pages].reshape(n, t_w * page, hkv)
    gk = kv_dequant(gkq, gks, k.dtype)
    gv = kv_dequant(gvq, gvs, k.dtype)
    rows_k, rows_v = attn.fill_cache_rows(gk, gv, k, v, lengths, starts=starts)
    rq_k, rs_k = kv_quant(rows_k)
    rq_v, rs_v = kv_quant(rows_v)
    w4 = written[:, :, None, None]
    w3 = written[:, :, None]
    return {"k": ck.at[flat_pages].set(jnp.where(w4, rq_k, gkq).reshape(n * t_w, page, hkv, hd)),
            "v": cv.at[flat_pages].set(jnp.where(w4, rq_v, gvq).reshape(n * t_w, page, hkv, hd)),
            "ks": cks.at[flat_pages].set(jnp.where(w3, rs_k, gks).reshape(n * t_w, page, hkv)),
            "vs": cvs.at[flat_pages].set(jnp.where(w3, rs_v, gvs).reshape(n * t_w, page, hkv))}


def _ref_args(case, dtype):
    import jax.numpy as jnp

    pool = {key: jnp.asarray(a) for key, a in case["pool"].items()}
    idx = [None if case[x] is None else jnp.asarray(case[x])
           for x in ("table", "starts", "lengths")]
    return pool, _jax(case["k"], dtype), _jax(case["v"], dtype), idx


def _plain(case, dtype):
    pool, k, v, (table, starts, lengths) = _torch_case(case, dtype)
    ref.kv_write_int8_ref(pool, k, v, table, starts, lengths)
    return {key: t.numpy() for key, t in pool.items()}


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_write_matches_reference_decode_write(hd, dtype):
    import jax

    case = decode_case(np.random.default_rng(hd), hd)
    got = _plain(case, dtype)
    pool, k, v, (table, pos, _) = _ref_args(case, dtype)
    _assert_planes_equal(got, _ref_decode_write(pool, k, v, pos, table))
    # the slots the rows own changed, and nothing else outside page 0
    changed = np.any(got["k"] != case["pool"]["k"], axis=(2, 3))
    live = {(int(case["table"][r, p % CAP // PAGE]), p % PAGE)
            for r, p in enumerate(case["starts"][:4])}
    assert {tuple(s) for s in np.argwhere(changed[1:]) + [1, 0]} <= live
    # under jit the scale may be the reciprocal multiply's, one ulp off
    jit = jax.jit(_ref_decode_write)(pool, k, v, pos, table)
    for q, s in (("k", "ks"), ("v", "vs")):
        gq, gs = got[q][1:], got[s][1:]
        jq, js = np.asarray(jit[q])[1:], np.asarray(jit[s])[1:]
        same = gs == js
        assert np.all(np.abs(gs - js) <= np.spacing(gs))
        np.testing.assert_array_equal(gq[same], jq[same])
        assert np.all(np.abs(gq.astype(np.int32) - jq.astype(np.int32)) <= 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_write_matches_reference_prefill_write(hd, dtype):
    case = prefill_case(np.random.default_rng(100 + hd), hd)
    got = _plain(case, dtype)
    pool, k, v, (table, starts, lengths) = _ref_args(case, dtype)
    _assert_planes_equal(got, _ref_prefill_write(pool, k, v, table, starts, lengths))
    # the shared prefix pages and row 5's page kept their bits; the ring of
    # the row longer than its ring was written whole
    t = case["table"]
    for page in (t[1, 0], t[1, 1], t[5, 0], t[3, 1], t[3, 2]):
        for key in ("k", "v", "ks", "vs"):
            np.testing.assert_array_equal(got[key][page], case["pool"][key][page])
    assert np.all(got["ks"][t[4]] != case["pool"]["ks"][t[4]])


def test_ops_write_on_the_cpu_is_the_plain_version():
    case = prefill_case(np.random.default_rng(7), 64)
    pool, k, v, (table, starts, lengths) = _torch_case(case, "bfloat16")
    ops.kv_write_int8(pool, k, v, table, starts, lengths)
    _assert_planes_equal({key: t.numpy() for key, t in pool.items()}, _plain(case, "bfloat16"))


def test_kv_write_int8_wrapper_refuses_cpu_tensors_bad_shapes_and_strides():
    from repro_torch.kernels.quantize import kv_write_int8

    case = decode_case(np.random.default_rng(0), 64)
    pool, k, v, (table, pos, _) = _torch_case(case, "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        kv_write_int8(pool, k, v, table, pos)
    # hd 30 (a bf16 row of 60 bytes: no 16-byte lanes)
    k30 = torch.zeros(6, 1, HKV, 30, dtype=torch.bfloat16)
    pool30 = {"k": torch.zeros(P, PAGE, HKV, 30, dtype=torch.int8),
              "v": torch.zeros(P, PAGE, HKV, 30, dtype=torch.int8),
              "ks": torch.zeros(P, PAGE, HKV), "vs": torch.zeros(P, PAGE, HKV)}
    with pytest.raises(ValueError, match="head dims"):
        kv_write_int8(pool30, k30, k30, table, pos)
    # a row stride, then a token stride, of Hkv·hd + 4 bf16 elements: token
    # rows off 16-byte boundaries
    for s in (1, 2):
        wide = torch.zeros(6, s, HKV * 64 + 4, dtype=torch.bfloat16)
        kw = wide[:, :, : HKV * 64].unflatten(2, (HKV, 64))
        with pytest.raises(ValueError, match="16-byte"):
            kv_write_int8(pool, kw, kw, table, pos)
    # a view one element on: the first row starts off a 16-byte boundary
    flat = torch.zeros(6 * HKV * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(6, 1, HKV, 64)
    with pytest.raises(ValueError, match="16-byte"):
        kv_write_int8(pool, off, off, table, pos)
    # heads not contiguous within a token
    with pytest.raises(ValueError, match="contiguous"):
        kv_write_int8(pool, k.transpose(2, 3).contiguous().transpose(2, 3), v, table, pos)
    with pytest.raises(TypeError):
        kv_write_int8(pool, k.half(), v.half(), table, pos)
    with pytest.raises(TypeError, match="int8"):
        kv_write_int8(dict(pool, k=pool["k"].float(), v=pool["v"].float()), k, v, table, pos)
    with pytest.raises(ValueError, match="float32"):
        kv_write_int8(dict(pool, ks=pool["ks"][..., :1]), k, v, table, pos)
    with pytest.raises(ValueError, match="int32"):
        kv_write_int8(pool, k, v, table.long(), pos)
    with pytest.raises(ValueError, match="int32"):
        kv_write_int8(pool, k, v, table, pos[:3])


def test_the_int8_pool_writes_go_through_one_call_per_layer(monkeypatch):
    """A prefill round and a decode step over an int8 pool each write every
    layer once through ``ops.kv_write_int8`` and quantize nothing else; an
    fp pool never calls it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import quantize
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    calls = []
    write = ops.kv_write_int8
    monkeypatch.setattr(ops, "kv_write_int8",
                        lambda *a, **kw: (calls.append(a[1].shape), write(*a, **kw)))
    monkeypatch.setattr(quantize, "int8_encode", lambda *a: pytest.fail("int8_encode called"))
    for kv_dtype in ("int8", "fp"):
        calls.clear()
        cache = model.init_paged_cache(2, 9, 4, 4, device="cpu", kv_dtype=kv_dtype)
        cache["table"].copy_(torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]], dtype=torch.int32))
        tokens = torch.arange(16, dtype=torch.int32).reshape(2, 8) % cfg.vocab_size
        cache, logits = model.prefill_slots(params, cache, tokens,
                                            torch.tensor([5, 8], dtype=torch.int32),
                                            torch.arange(2))
        cache, logits = model.decode(params, cache, logits.argmax(-1, keepdim=True)
                                     .to(torch.int32))
        assert torch.isfinite(logits).all()
        if kv_dtype == "fp":
            assert calls == []
        else:
            assert calls == [(2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)] * cfg.n_layers \
                + [(2, 1, cfg.n_kv_heads, cfg.resolved_head_dim)] * cfg.n_layers


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kv_write_int8_kernel_matches_plain_version_cuda(sm90, hd, dtype):
    """Bitwise on every plane outside page 0, one launch per call, on the
    decode and prefill cases, and on k/v whose tokens sit in a wider buffer
    (the wrapper passes the strides; no copy)."""
    rng = np.random.default_rng(200 + hd)
    for case in (decode_case(rng, hd), prefill_case(rng, hd)):
        pool, k, v, (table, starts, lengths) = _torch_case(case, dtype, "cuda")
        n, s = k.shape[:2]
        wide = torch.zeros(n, s, 3 * HKV, hd, dtype=k.dtype, device="cuda")
        wide[:, :, HKV: 2 * HKV] = v
        for kk, vv in ((k, v), (k, wide[:, :, HKV: 2 * HKV])):
            got = {key: t.clone() for key, t in pool.items()}
            before = dict(build.LAUNCHES)
            ops.kv_write_int8(got, kk, vv, table, starts, lengths)
            torch.cuda.synchronize()
            assert build.LAUNCHES["kv_write_int8"] == before["kv_write_int8"] + 1
            assert {n_: c for n_, c in build.LAUNCHES.items() if n_ != "kv_write_int8"} == \
                {n_: c for n_, c in before.items() if n_ != "kv_write_int8"}
            want = {key: t.clone() for key, t in pool.items()}
            ref.kv_write_int8_ref(want, kk, vv, table, starts, lengths)
            _assert_planes_equal({key: t.cpu().numpy() for key, t in got.items()},
                                 {key: t.cpu().numpy() for key, t in want.items()})
