"""Ring mode of the port against the reference: per-slot contiguous ring
caches, sliding windows, interleaved prefill and the single-batch path.

Layers, from the kernels' plain versions up, each on the same numpy-drawn
inputs or bridged weights (``repro_torch.bridge.numpy_params``) in float32:

* ``ref.swa_decode_ref`` / ``ref.ring_paged_decode_ref`` against the
  reference's oracles ``swa_decode_ref`` / ``paged_decode_ref`` and the
  Pallas ``swa_decode`` / contiguous ``paged_decode`` (interpret mode):
  hd 32 and 128, scalar and per-row ``pos``, window 0 and below C, rows
  short of the ring (dead pages) and wrapped. The two plain versions are
  bitwise equal to each other (as the reference's two are); across the
  packages they agree to ~3e-7 (PyTorch's and XLA's fp32 contractions sum
  in other orders): held within 1e-5.
* ``fill_cache_rows`` (with and without ``starts``) is data movement:
  held bitwise.
* ``decode_attend`` and the ring branch of ``prefill_slots``: caches and
  logits within 1e-5.
* Engines: the port's ``ServeEngine`` against the reference's on the
  reference's ``make_requests`` prompts, ring (chunked and interleaved,
  window 0 and 6, which the 8-token prompts wrap), ring with paged decode
  off, and the windowed paged pool: identical greedy tokens (at fp32 the
  logits agree to ~1e-6, far inside the top-2 gaps of these traces). The
  single-batch path against the reference's ``serve_batch`` on its own
  prompts and the bridged weights: identical tokens.
* The golden ring file the card replays
  (``src/repro_torch/testdata/golden_stablelm_smoke_ring.json``; rewrite it
  with ``PYTHONPATH=src:. python tests/test_torch_ring.py``) equals a fresh
  reference run."""
import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_decode as pallas_paged_decode
from repro.kernels.swa_decode import swa_decode as pallas_swa_decode
from repro.launch import engine as ref_engine
from repro.launch import serve as ref_serve
from repro.models import attention as jattn
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import engine as port_engine
from repro_torch.launch.serve import generate_batch
from repro_torch.models import attention as attn
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
TOL = 1e-5
P, G = 8, 6  # prompt / generated tokens per request
GOLDEN = (pathlib.Path(__file__).resolve().parents[1]
          / "src" / "repro_torch" / "testdata" / "golden_stablelm_smoke_ring.json")


def _f32_configs():
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(ref_smoke_config(ARCH), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _models(seed=0):
    cfg, ref_cfg = _f32_configs()
    tree = numpy_params(cfg, seed)
    ref_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    return (cfg, build_model(cfg), params_from_numpy(tree, cfg, "cpu"),
            ref_build_model(ref_cfg), ref_params)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------ plain ring decode
CAP = 128  # two pages of the ring page (64): row 0 stays inside the first


def _ring_inputs(seed, b, g, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 2, g, hd), np.float32)
    k = rng.standard_normal((b, CAP, 2, hd), np.float32)
    v = rng.standard_normal((b, CAP, 2, hd), np.float32)
    return q, k, v


POS = {"rows": np.array([3, CAP + 5, 2 * CAP - 1], np.int32),  # short, wrapped, wrapped
       "scalar_short": np.int32(5), "scalar_wrapped": np.int32(CAP + 3)}


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("pos_kind", sorted(POS))
@pytest.mark.parametrize("g,hd", [(1, 32), (2, 128)])
def test_ring_plain_versions_match_reference_and_pallas(g, hd, pos_kind, window):
    q, k, v = _ring_inputs(hd + g, 3, g, hd)
    pos = POS[pos_kind]
    tq, tk, tv, tp = _t(q), _t(k), _t(v), _t(np.asarray(pos))
    swa = ref.swa_decode_ref(tq, tk, tv, tp, window)
    paged = ref.ring_paged_decode_ref(tq, tk, tv, tp, window)
    torch.testing.assert_close(paged, swa, rtol=0, atol=0)   # skipping is invisible
    jq, jk, jv, jp = (jnp.asarray(a) for a in (q, k, v, pos))
    _close(swa, jref.swa_decode_ref(jq, jk, jv, jp, window))
    _close(paged, jref.paged_decode_ref(jq, jk, jv, jp, window))
    _close(swa, pallas_swa_decode(jq, jk, jv, jp, window, interpret=True))
    _close(paged, pallas_paged_decode(jq, jk, jv, jp, window, interpret=True))
    # the ops entry point on CPU tensors: the plain versions, no launch
    for flag, want in ((True, paged), (False, swa)):
        torch.testing.assert_close(ops.swa_decode_attention(tq, tk, tv, tp, window, paged=flag),
                                   want, rtol=0, atol=0)


def test_ring_plain_versions_bfloat16_match_reference():
    """bf16 rings: both packages cast an fp32 softmax to bf16 (one bf16 ulp
    of an O(1) output apart at most)."""
    q, k, v = _ring_inputs(7, 3, 2, 64)
    pos, window = POS["rows"], 30
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = ref.ring_paged_decode_ref(tq, tk, tv, _t(pos), window)
    want = jref.paged_decode_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                 jnp.asarray(pos), window)
    _close(got, want, tol=1e-2)


# ------------------------------------------------------------ ring writes
@pytest.mark.parametrize("with_starts", [False, True])
@pytest.mark.parametrize("cap", [4, 6, 16])
def test_fill_cache_rows_matches_reference_bitwise(cap, with_starts):
    """Rows of 0 (padding), short, C (or short of it) and past C tokens into
    rings of ``cap``, with and without start offsets: each slot holds the
    LAST index landing on it, slots never reached keep their old value."""
    rng = np.random.default_rng(3 + cap)
    n, s = 4, 15
    k = rng.standard_normal((n, s, 2, 32), np.float32)
    v = rng.standard_normal((n, s, 2, 32), np.float32)
    ck = rng.standard_normal((n, cap, 2, 32), np.float32)
    cv = rng.standard_normal((n, cap, 2, 32), np.float32)
    lengths = np.array([0, 4, min(cap, s), 15], np.int32)
    starts = np.array([3, 5, 2, 4], np.int32) if with_starts else None
    got = attn.fill_cache_rows(_t(ck), _t(cv), _t(k), _t(v), _t(lengths),
                               None if starts is None else _t(starts))
    want = jattn.fill_cache_rows(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lengths),
                                 None if starts is None else jnp.asarray(starts))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[0][0].numpy(), ck[0])  # the padding row


# ---------------------------------------------------------------- model
def _ring_caches(model, ref_model, ref_params, b, max_seq, window, per_slot):
    if per_slot:
        return (model.init_slot_cache(b, max_seq, window=window, device="cpu"),
                ref_model.init_slot_cache(ref_params, b, max_seq, window=window))
    return (model.init_cache(None, {"tokens": torch.zeros((b, 1), dtype=torch.long)}, max_seq,
                             window=window),
            ref_model.init_cache(ref_params, {"tokens": jnp.zeros((b, 1), jnp.int32)},
                                 max_seq, window=window))


def _same_cache(tc, jc):
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("per_slot,window", [(False, 0), (True, 0), (True, 5), (False, 5)])
def test_decode_steps_match_reference(per_slot, window):
    """Decode steps from empty rings past the wrap (window 5 shrinks the
    ring to 5 slots; 7 steps wrap it): the port's ``decode_attend`` through
    ``decode_step`` (both ring kernels' plain versions) against the
    reference's jnp path."""
    cfg, model, params, ref_model, ref_params = _models()
    tc, jc = _ring_caches(model, ref_model, ref_params, 3, 12, window, per_slot)
    rng = np.random.default_rng(5)
    if per_slot:  # rows at different depths
        tc["pos"] = _t(np.array([0, 2, 4], np.int32))
        jc["pos"] = jnp.asarray([0, 2, 4], jnp.int32)
    for step in range(7):
        feed = rng.integers(1, 500, (3, 1)).astype(np.int32)
        tc, tl = model.decode(params, tc, _t(feed), window=window, paged=step % 2 == 0)
        jc, jl = ref_model.decode(ref_params, jc, jnp.asarray(feed), window=window)
        _close(tl, jl)
    _same_cache(tc, jc)


@pytest.mark.parametrize("lens", [(9, 3, 0), (16, 1, 5)])
@pytest.mark.parametrize("window", [0, 4, 6])
def test_ring_prefill_slots_match_reference(window, lens):
    """Two batched ring rounds into a per-slot cache (rings of 24, or of the
    window, which the longer prompts wrap): a 7-token prompt into slot 1,
    then ``lens`` into slots 0, 2, 1 (a length-0 row is padding and leaves
    slot 1 live), then a decode step over every slot."""
    cfg, model, params, ref_model, ref_params = _models()
    rng = np.random.default_rng(8 + window)
    tc, jc = _ring_caches(model, ref_model, ref_params, 3, 24, window, True)
    for lengths, slots in (((7,), (1,)), (lens, (0, 2, 1))):
        toks = rng.integers(1, 500, (len(lengths), max(lengths))).astype(np.int32)
        tl_, sl_ = np.array(lengths, np.int32), np.array(slots, np.int32)
        tc, tl = model.prefill_slots(params, tc, _t(toks), _t(tl_), _t(sl_), window=window)
        jc, jl = ref_model.prefill_slots(ref_params, jc, jnp.asarray(toks), jnp.asarray(tl_),
                                         jnp.asarray(sl_), window=window)
        live = tl_ > 0
        _close(tl[torch.from_numpy(live)], np.asarray(jl)[live])
        _same_cache(tc, jc)
    feed = rng.integers(1, 500, (3, 1)).astype(np.int32)
    tc, tl = model.decode(params, tc, _t(feed), window=window)
    jc, jl = ref_model.decode(ref_params, jc, jnp.asarray(feed), window=window)
    _close(tl, jl)
    _same_cache(tc, jc)


# -------------------------------------------------------------- engines
# Each run: engine settings (both packages), and whether the golden file
# carries it. The reference engine's kernel switch changes no token: its
# runs use the jnp path; ``paged_decode`` only reaches the port.
RUNS = {
    "ring_chunked": (dict(), False),
    "ring_chunked_window6": (dict(window=6), True),
    "ring_interleaved": (dict(prefill="interleaved"), True),
    "ring_interleaved_window6": (dict(prefill="interleaved", window=6), False),
    "ring_swa_decode_window6": (dict(window=6, paged_decode=False), True),
    "paged_window6": (dict(paged_cache=True, page_size=4, window=6), True),
    "paged_interleaved_window6": (dict(paged_cache=True, page_size=4, window=6,
                                       prefill="interleaved"), False),
}
N_REQ = 5


@functools.lru_cache(maxsize=None)
def _ref_prompts():
    _, ref_cfg = _f32_configs()
    return tuple(np.asarray(r.prompt) for r in ref_engine.make_requests(
        ref_cfg, n_requests=N_REQ, prompt_len=P, gen_tokens=G, seed=0))


def _engine_kw(run):
    return dict(num_slots=2, max_seq=P + G, **RUNS[run][0])


@functools.lru_cache(maxsize=None)
def _ref_tokens(run):
    """The reference engine's tokens on its own make_requests prompts."""
    cfg, model, params, ref_model, ref_params = _models()
    kw = {k: v for k, v in _engine_kw(run).items() if k != "paged_decode"}
    eng = ref_engine.ServeEngine(ref_model, ref_params, **kw)
    outs = eng.run([ref_engine.Request(uid=u, prompt=p, max_new_tokens=G)
                    for u, p in enumerate(_ref_prompts())])
    return tuple(tuple(int(t) for t in o.tokens) for o in outs)


def _port_tokens(run, device="cpu"):
    cfg, model, params, ref_model, ref_params = _models()
    eng = port_engine.ServeEngine(model, params, device=device, **_engine_kw(run))
    outs = eng.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=G)
                    for u, p in enumerate(_ref_prompts())])
    return tuple(tuple(o.tokens) for o in outs), eng


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_tokens_match_reference(run):
    got, eng = _port_tokens(run)
    assert got == _ref_tokens(run), run
    assert all(len(t) == G for t in got)
    kw = RUNS[run][0]
    if kw.get("paged_cache"):
        assert eng.pool.in_use == 0 and eng.table_width == 2   # ceil(6 / 4) pages
    else:
        assert eng.pool_stats is None
        assert eng.cache["k"].shape[2] == (6 if kw.get("window") else P + G)
    if kw.get("prefill") == "interleaved":
        assert eng.prefill_dispatches == 0


def _ref_serve_batch(window):
    """The reference's ``serve_batch`` at float32 on the bridged weights (its
    prompts are its corpus sample, the same as its make_requests)."""
    cfg, model, params, ref_model, ref_params = _models()
    _, ref_cfg = _f32_configs()
    orig = (ref_serve.get_smoke_config, ref_serve.build_model)
    ref_serve.get_smoke_config = lambda arch: ref_cfg
    ref_serve.build_model = lambda c: dataclasses.replace(ref_model, init=lambda key: ref_params)
    try:
        out = ref_serve.serve_batch(ARCH, batch=N_REQ, prompt_len=P, gen_tokens=G,
                                    window=window, seed=0, log_fn=lambda *_: None)
    finally:
        ref_serve.get_smoke_config, ref_serve.build_model = orig
    return [list(t) for t in out["generated"]]


@pytest.mark.parametrize("window", [0, 6])
def test_serve_batch_tokens_match_reference(window):
    cfg, model, params, ref_model, ref_params = _models()
    prompts = torch.from_numpy(np.stack(_ref_prompts()))
    gen, _, _ = generate_batch(model, params, prompts, G, window=window)
    want = _ref_serve_batch(window)
    assert gen.tolist() == want
    # the oracle property: the ring engine's uid r is serve_batch's row r
    run = "ring_chunked_window6" if window else "ring_chunked"
    assert [list(t) for t in _ref_tokens(run)] == want


def test_interleaved_swap_of_a_mid_prefill_victim_matches_reference():
    """Interleaved prefill over a pool too small for both slots' prompts: a
    slot is preempted while still teacher-forcing its prompt; with a host
    tier it swaps out and resumes mid-prompt. Tokens and counters equal the
    reference engine's."""
    cfg, model, params, ref_model, ref_params = _models()
    kw = dict(num_slots=2, max_seq=20, page_size=4, num_pages=5, host_pages=16,
              prefill="interleaved", paged_cache=True)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in (10, 9, 6)]
    ref = ref_engine.ServeEngine(ref_model, ref_params, **kw)
    want = ref.run([ref_engine.Request(uid=u, prompt=p, max_new_tokens=6)
                    for u, p in enumerate(prompts)])
    port = port_engine.ServeEngine(model, params, device="cpu", **kw)
    got = port.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=6)
                    for u, p in enumerate(prompts)])
    assert [o.tokens for o in got] == [o.tokens for o in want]
    for key in ("preemptions", "swapped_out_pages", "swapped_in_pages", "prefill_tokens"):
        assert port.pool_stats[key] == ref.pool_stats[key], key
    assert port.preemptions > 0 and port.swapped_in_pages > 0


def test_ring_engine_rules():
    """What ring mode refuses or turns off, as the reference does."""
    cfg, model, params, ref_model, ref_params = _models()
    eng = port_engine.ServeEngine(model, params, num_slots=2, max_seq=10, device="cpu",
                                  prefix_cache=True)
    assert eng.prefix is None and "paged_cache=False" in eng.prefix_disabled_reason
    with pytest.raises(port_engine.AdmissionError) as err:
        eng.submit(port_engine.Request(uid=3, prompt=np.ones(8, np.int32), max_new_tokens=3))
    assert err.value.reason == "exceeds_max_seq"
    windowed = port_engine.ServeEngine(model, params, num_slots=2, max_seq=10, window=4,
                                       device="cpu")
    assert windowed.capacity_shortfall(
        port_engine.Request(uid=0, prompt=np.ones(30, np.int32), max_new_tokens=30)) == 0
    paged = port_engine.ServeEngine(model, params, num_slots=2, max_seq=10, window=4,
                                    paged_cache=True, page_size=4, prefix_cache=True,
                                    device="cpu")
    assert paged.prefix is None and "window=4" in paged.prefix_disabled_reason
    with pytest.raises(ValueError, match="cannot back a table"):
        port_engine.ServeEngine(model, params, max_seq=64, window=32, paged_cache=True,
                                page_size=4, num_pages=5, device="cpu")
    for kw in (dict(kv_dtype="int8"), dict(host_pages=4)):
        with pytest.raises(ValueError, match="paged_cache=True"):
            port_engine.ServeEngine(model, params, device="cpu", **kw)


def test_serve_cli_batch_and_ring_modes_on_cpu(capsys):
    from repro_torch.launch.serve import main

    res = main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4",
                "--window", "4"])
    assert res["window"] == 4 and np.asarray(res["generated"]).shape == (2, 4)
    res = main(["--continuous", "--no-paged-cache", "--prefill", "interleaved", "--window",
                "4", "--device", "cpu", "--requests", "3", "--gen", "3", "--prompt-len", "6",
                "--slots", "2", "--no-paged-decode"])
    assert res["pool"] is None and res["paged_cache"] is False and not res["prefix_cache"]
    assert all(len(t) == 3 for t in res["generated"])
    for bad in (["--kv-dtype", "int8"], ["--continuous", "--no-paged-cache", "--host-pages",
                                         "4"]):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", *bad])
    assert "tok/s" in capsys.readouterr().out


# --------------------------------------------------------------- golden
def make_golden() -> dict:
    """The reference's tokens for the golden runs and its windowed
    ``serve_batch``, on the bridged float32 smoke weights (seed 0)."""
    return {
        "config": f"{ARCH} smoke, dtype float32",
        "seed": 0,
        "max_new_tokens": G,
        "prompts": [p.tolist() for p in _ref_prompts()],
        "runs": [{"name": run, "engine": _engine_kw(run), "tokens": [list(t) for t in
                                                                    _ref_tokens(run)]}
                 for run in sorted(RUNS) if RUNS[run][1]],
        "serve_batch": {"window": 6, "tokens": _ref_serve_batch(6)},
    }


def test_golden_ring_file_matches_reference():
    assert json.loads(GOLDEN.read_text()) == make_golden()


def test_port_replays_golden_ring_on_cpu():
    """What chip_smoke.py's golden ring phase does on the card, on the CPU."""
    g = json.loads(GOLDEN.read_text())
    cfg, model, params, _, _ = _models(g["seed"])
    for run in g["runs"]:
        eng = port_engine.ServeEngine(model, params, device="cpu", **run["engine"])
        outs = eng.run([port_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                            max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(g["prompts"])])
        assert [o.tokens for o in outs] == run["tokens"], run["name"]
    gen, _, _ = generate_batch(model, params, torch.tensor(g["prompts"]),
                               g["max_new_tokens"], window=g["serve_batch"]["window"])
    assert gen.tolist() == g["serve_batch"]["tokens"]


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
