"""The port's speculative decoding (``repro_torch.launch.spec_decode`` and
the engine's speculative round) and the k-token verify
(``prefill_slots(return_all_logits=True)``), against the reference.

Speculation must not show in greedy tokens: on the same numpy-drawn float32
weights the port's speculative engine emits the port's plain engine's
tokens and the reference speculative engine's tokens, with the reference's
round counters, whatever the draft (the same params: full acceptance and
the bonus token; foreign params: every round rolls back), over fp and int8
pages, with and without prefix sharing. Sampled rounds draw exactly from
the target's law (checked by distribution: the port's streams are its
own). Rollback never leaks a page. Also here: the golden file the card
replays (``src/repro_torch/testdata/golden_stablelm_smoke_spec.json``;
rewrite it with ``PYTHONPATH=src:. python tests/test_torch_spec_decode.py``)."""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests._hypothesis_compat import given, settings, st

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import engine as ref_engine
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch.sampling import SamplingParams, filter_logits, speculative_acceptance
from repro_torch.launch.spec_decode import make_draft_backend
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
P, G = 16, 10
GOLDEN = (pathlib.Path(__file__).resolve().parents[1]
          / "src" / "repro_torch" / "testdata" / "golden_stablelm_smoke_spec.json")
SPEC_COUNTERS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_emitted")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's smoke-size ops gain nothing from intra-op threads, and in a
    loaded test run (a worker per core) an OpenMP region stalls on its
    descheduled threads: this module's torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(ref_smoke_config(ARCH), dtype="float32"))


def _port_params(seed):
    cfg, _ = _cfgs()
    return params_from_numpy(numpy_params(cfg, seed), cfg, "cpu")


def _ref_params(seed):
    cfg, _ = _cfgs()
    return jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, seed))


def _port(draft_seed=None, spec_tokens=3, **kw):
    cfg, _ = _cfgs()
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", P + G)
    kw.setdefault("paged_cache", True)
    kw.setdefault("page_size", 4)
    if draft_seed is not None:
        kw.update(draft_model=build_model(cfg), draft_params=_port_params(draft_seed),
                  spec_tokens=spec_tokens)
    return port_engine.ServeEngine(build_model(cfg), _port_params(0), device="cpu", **kw)


def _ref(draft_seed=None, spec_tokens=3, **kw):
    _, ref_cfg = _cfgs()
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", P + G)
    kw.setdefault("paged_cache", True)
    kw.setdefault("page_size", 4)
    if draft_seed is not None:
        kw.update(draft_model=ref_build_model(ref_cfg), draft_params=_ref_params(draft_seed),
                  spec_tokens=spec_tokens)
    return ref_engine.ServeEngine(ref_build_model(ref_cfg), _ref_params(0), **kw)


def _prompts(n=4, shared_prefix=False, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 512, P) for _ in range(n)]
    if shared_prefix:
        prompts = [np.concatenate([prompts[0][: P - 2], p[P - 2:]]) for p in prompts]
    return prompts


def _run(engine, prompts, gen=G, sampling=None, module=port_engine):
    outs = engine.run([module.Request(uid=u, prompt=p, max_new_tokens=gen,
                                      sampling=None if sampling is None else sampling(u))
                       for u, p in enumerate(prompts)])
    return {o.uid: o.tokens for o in outs}


# ------------------------------------------------------------ acceptance
def test_acceptance_marginal_matches_target():
    """Leviathan exactness, empirically: whatever the draft proposes, the
    first emitted token's law over 1500 rounds matches the filtered target
    distribution (accepted mass + residual draw rebuild p)."""
    v, draws = 8, 1500
    gen = torch.Generator().manual_seed(42)
    tgt = torch.randn(4, v, generator=gen) * 2.0
    dq = torch.log_softmax(torch.randn(3, v, generator=gen), -1)
    drafts = torch.multinomial(dq.exp(), draws, replacement=True, generator=gen).T  # (N, 3)
    u = torch.rand(draws, 5, generator=gen, dtype=torch.float64)
    n_emit, emitted = speculative_acceptance(
        u, tgt.expand(draws, -1, -1), drafts, dq.expand(draws, -1, -1),
        torch.full((draws,), 3), 1.0, 0, 1.0, v)
    firsts = torch.bincount(emitted[:, 0], minlength=v).double() / draws
    p = torch.softmax(filter_logits(tgt[:1], 1.0, 0, 1.0, v), -1)[0]
    np.testing.assert_allclose(firsts.numpy(), p.double().numpy(), atol=0.05)
    assert bool(((n_emit >= 1) & (n_emit <= 4)).all())


def test_a_draft_equal_to_the_target_is_always_accepted():
    """q = p at every step: u·q(d) < p(d) for every u < 1, so every draft
    lands and the bonus token is drawn from p_{k_live}."""
    gen = torch.Generator().manual_seed(3)
    tgt = torch.randn(6, 4, 32, generator=gen)
    logq = torch.log_softmax(filter_logits(tgt[:, :3].reshape(18, 32), 1.0, 0, 1.0, 32), -1)
    drafts = torch.randint(0, 32, (6, 3), generator=gen)
    k_live = torch.tensor([3, 3, 2, 1, 0, 3])
    n_emit, emitted = speculative_acceptance(torch.rand(6, 5, generator=gen), tgt, drafts,
                                             logq.reshape(6, 3, 32), k_live, 1.0, 0, 1.0, 32)
    assert n_emit.tolist() == (k_live + 1).tolist()
    for r, k in enumerate(k_live.tolist()):
        assert emitted[r, :k].tolist() == drafts[r, :k].tolist()


@settings(max_examples=20, deadline=None)
@given(k_live=st.integers(0, 3), temp=st.floats(0.2, 2.0), top_k=st.sampled_from([0, 2, 5]),
       seed=st.integers(0, 10**6))
def test_acceptance_invariants(k_live, temp, top_k, seed):
    """1 <= n_emit <= k_live + 1, every emission before the last is its
    draft token, and every emission is a vocabulary id."""
    v = 16
    gen = torch.Generator().manual_seed(seed)
    tgt = torch.randn(1, 4, v, generator=gen)
    dq = torch.log_softmax(torch.randn(1, 3, v, generator=gen) / temp, -1)
    drafts = torch.multinomial(dq[0].exp(), 1, generator=gen).T
    n_emit, emitted = speculative_acceptance(
        torch.rand(1, 5, generator=gen), tgt, drafts, dq, torch.tensor([k_live]), temp, top_k,
        1.0, v)
    n, em = int(n_emit[0]), emitted[0].tolist()
    assert 1 <= n <= k_live + 1
    assert all(0 <= t < v for t in em[:n])
    assert em[: n - 1] == drafts[0, : n - 1].tolist()


# --------------------------------------------------------- k-token verify
def _verify_rounds(kv_dtype, return_all):
    """A cold round, then a verify round over the same pool: row 0 at a
    mid-page start behind its cached tokens, row 1 cold (start 0), row 2 a
    padding row (length 0). Returns the port's and the reference's (logits,
    pool) of the verify."""
    cfg, ref_cfg = _cfgs()
    model, ref_model = build_model(cfg), ref_build_model(ref_cfg)
    params, ref_params = _port_params(0), _ref_params(0)
    table = np.array([[3, 1, 5, 12, 10, 0], [2, 7, 0, 0, 0, 0], [9, 4, 6, 8, 11, 13]], np.int32)
    tc = model.init_paged_cache(3, 14, 4, 6, device="cpu", kv_dtype=kv_dtype)
    jc = ref_model.init_paged_cache(ref_params, 3, 14, 4, 6, kv_dtype=kv_dtype)
    tc["table"] = torch.from_numpy(table.copy())
    jc["table"] = jnp.asarray(table)
    rng = np.random.default_rng(5)
    toks = rng.integers(1, 500, (2, 16)).astype(np.int32)
    lens, slots = np.array([13, 6], np.int32), np.array([0, 2], np.int32)
    T = torch.from_numpy
    tc, _ = model.prefill_slots(params, tc, T(toks), T(lens), T(slots))
    jc, _ = ref_model.prefill_slots(ref_params, jc, jnp.asarray(toks), jnp.asarray(lens),
                                    jnp.asarray(slots))
    vt = rng.integers(1, 500, (3, 8)).astype(np.int32)
    starts, vl, vs = (np.array([13, 0, 0], np.int32), np.array([5, 3, 0], np.int32),
                      np.array([0, 1, 2], np.int32))
    tc, tl = model.prefill_slots(params, tc, T(vt), T(vl), T(vs), starts=T(starts),
                                 prefix_pages=4, return_all_logits=return_all)
    jc, jl = ref_model.prefill_slots(ref_params, jc, jnp.asarray(vt), jnp.asarray(vl),
                                     jnp.asarray(vs), starts=jnp.asarray(starts), prefix_pages=4,
                                     return_all_logits=return_all)
    return cfg, (tl, tc), (np.asarray(jl), jc), vl


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_verify_logits_match_reference_at_every_live_position(kv_dtype):
    cfg, (tl, tc), (jl, jc), vl = _verify_rounds(kv_dtype, True)
    assert tl.shape == (3, 8, tl.shape[-1]) and jl.shape == tl.shape
    for r, n in enumerate(vl):
        np.testing.assert_allclose(tl[r, :n].numpy(), jl[r, :n], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tl[r, :n, : cfg.vocab_size].argmax(-1).numpy(),
                                      jl[r, :n, : cfg.vocab_size].argmax(-1))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_verify_writes_the_cache_of_the_last_logit_path(kv_dtype):
    """return_all_logits changes what comes back, not what is written: on fp
    pages the pools equal the False path's bitwise and the last live
    position's logits equal its logits. On int8 pages the suffix attends
    its own k/v through the int8 round trip, which moves the residual
    stream: layer 0's pool write is still bitwise the False path's, the
    later layers' dequantized values within two int8 steps of it, the
    logits within the round trip's noise (1e-2; ``test_verify_equals_
    sequential_decode_steps`` holds them to the decode step at 1e-4)."""
    _, (all_l, all_c), _, vl = _verify_rounds(kv_dtype, True)
    _, (last_l, last_c), _, _ = _verify_rounds(kv_dtype, False)
    for name in all_c:
        if kv_dtype == "fp" or name in ("pos", "table"):
            assert torch.equal(all_c[name], last_c[name]), name
        else:
            assert torch.equal(all_c[name][0], last_c[name][0]), name
    if kv_dtype == "int8":
        for q, sc in (("k", "ks"), ("v", "vs")):
            a = all_c[q].float() * all_c[sc][..., None]
            b = last_c[q].float() * last_c[sc][..., None]
            step = torch.maximum(all_c[sc], last_c[sc])[..., None]
            assert bool(((a - b).abs() <= 2 * step + 1e-6).all()), q
    for r, n in enumerate(vl[:2]):
        tol = 0 if kv_dtype == "fp" else 1e-2
        torch.testing.assert_close(all_l[r, n - 1], last_l[r], rtol=0, atol=tol)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_verify_equals_sequential_decode_steps(kv_dtype):
    """The verify's logits at position start + j equal the decode step's
    after the same j tokens: on int8 pages the round's own k/v go through
    the int8 round trip, as the decode step reads them back from the pool."""
    cfg, _ = _cfgs()
    model, params = build_model(cfg), _port_params(0)
    table = torch.tensor([[3, 1, 5, 12, 10, 0]], dtype=torch.int32)

    def fresh():
        c = model.init_paged_cache(1, 14, 4, 6, device="cpu", kv_dtype=kv_dtype)
        c["table"] = table.clone()
        toks = torch.from_numpy(np.random.default_rng(2).integers(1, 500, (1, 16)))
        c, _ = model.prefill_slots(params, c, toks.int(), torch.tensor([13]),
                                   torch.tensor([0]))
        return c

    feed = torch.from_numpy(np.random.default_rng(4).integers(1, 500, (1, 5))).int()
    _, vlog = model.prefill_slots(params, fresh(), feed, torch.tensor([5]), torch.tensor([0]),
                                  starts=torch.tensor([13]), prefix_pages=4,
                                  return_all_logits=True)
    c = fresh()
    for j in range(5):
        c, lg = model.decode(params, c, feed[:, j:j + 1])
        torch.testing.assert_close(vlog[0, j], lg[0], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- greedy identity
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("draft_seed", [0, 7])
def test_greedy_identity_and_counters(kv_dtype, prefix_cache, draft_seed):
    """Speculative == plain, token for token, and == the reference's
    speculative engine with its round counters, over fp/int8 pages, prefix
    sharing on/off and a same-params (seed 0) or foreign (seed 7) draft.
    With prefix sharing the trace is the golden file's (cold, suffix and
    copy-on-write admissions), whose reference tokens and counters
    ``test_golden_file_matches_reference`` pins; without, the reference
    runs here. No page outlives the trace but those the index pins."""
    if prefix_cache:
        g = json.loads(GOLDEN.read_text())
        case = next(c for c in g["cases"]
                    if c["engine"]["kv_dtype"] == kv_dtype and c["draft_seed"] == draft_seed)
        kw, prompts, gen = case["engine"], g["prompts"], g["max_new_tokens"]
        want = dict(enumerate(case["tokens"]))
        want_counters, want_in_use = case["counters"], None
    else:
        kw, prompts, gen = dict(kv_dtype=kv_dtype, prefix_cache=False), _prompts(4), G
        ref = _ref(draft_seed, **kw)
        want = _run(ref, prompts, module=ref_engine)
        want_counters = {k: ref.pool_stats[k] for k in SPEC_COUNTERS}
        want_in_use = ref.pool.in_use
    plain = _run(_port(**kw), prompts, gen)
    spec = _port(draft_seed, **kw)
    assert _run(spec, prompts, gen) == plain == want
    assert {k: spec.pool_stats[k] for k in SPEC_COUNTERS} == want_counters
    pinned = spec.prefix.size if spec.prefix is not None else 0
    assert spec.pool.in_use == pinned
    if prefix_cache:
        assert spec.prefix_hit_pages > 0 and spec.cow_copies > 0
    else:
        assert spec.pool.in_use == want_in_use == 0


def test_spec_uses_fewer_target_dispatches():
    plain = _port()
    _run(plain, _prompts(4))
    spec = _port(0)
    _run(spec, _prompts(4))
    assert spec.pool_stats["spec_accept_rate"] > 0.9
    assert plain.steps >= 1.5 * spec.steps, (plain.steps, spec.steps)


def test_spec_counters():
    eng = _port(7)
    _run(eng, _prompts(2))
    ps = eng.pool_stats
    assert ps["spec_enabled"] and ps["spec_tokens"] == 3
    assert ps["spec_rounds"] == eng.steps > 0
    # admission emits each request's first token; the rounds emit the rest
    assert ps["spec_emitted"] == 2 * (G - 1)
    assert 0.0 <= ps["spec_accept_rate"] <= 1.0
    assert ps["spec_dispatches_per_token"] <= 1.0
    eng.reset_metrics()
    assert all(eng.pool_stats[k] == 0 for k in SPEC_COUNTERS)
    plain = _port().pool_stats
    assert not plain["spec_enabled"] and plain["spec_rounds"] == 0


def test_eos_in_a_speculative_round_matches_reference():
    """An EOS inside a round's accepted run ends the request there, with the
    plain engine's tokens and the reference speculative engine's."""
    prompts = _prompts(4)
    eos = _run(_port(), prompts)[2][4]
    plain = _port(eos_id=eos)
    spec = _port(0, eos_id=eos)
    ref = _ref(0, eos_id=eos)
    got = spec.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=G)
                    for u, p in enumerate(prompts)])
    want = ref.run([ref_engine.Request(uid=u, prompt=p, max_new_tokens=G)
                    for u, p in enumerate(prompts)])
    assert [o.tokens for o in got] == [o.tokens for o in want] == list(
        _run(plain, prompts).values())
    assert [o.finish_reason for o in got] == [o.finish_reason for o in want]
    assert got[2].finish_reason == "eos" and got[2].tokens[-1] == eos
    assert spec.pool.in_use == 0


# --------------------------------------------------------------- sampling
def test_sampled_deterministic_and_mixed():
    """Sampled speculative runs repeat from the request seeds, and greedy
    requests beside sampled ones keep the plain engine's tokens."""
    sp = SamplingParams(temperature=0.9, top_k=12, top_p=0.95)
    mixed = lambda u: dataclasses.replace(sp, seed=11 + u) if u % 2 == 0 else None  # noqa: E731
    a = _run(_port(7), _prompts(4), sampling=mixed)
    b = _run(_port(7), _prompts(4), sampling=mixed)
    assert a == b
    base = _run(_port(), _prompts(4))
    assert all(a[u] == base[u] for u in (1, 3))
    assert any(a[u] != base[u] for u in (0, 2))


def test_sampled_speculation_keeps_the_target_law():
    """Over 256 request seeds, the law of a sampled request's first two
    tokens (the prefill's draw, then a one-draft round's emission) is the
    target's, p(t0) p(t1 | t0) of the filtered distributions, whether the
    draft is the target itself (every draft accepted) or foreign (most
    rejected, the residual drawn)."""
    cfg, _ = _cfgs()
    model, params = build_model(cfg), _port_params(0)
    prompt = _prompts(1)[0]
    sp = SamplingParams(temperature=1.0, top_k=3)

    def law(tokens):  # the filtered next-token distribution after ``tokens``
        c = model.init_paged_cache(1, 8, 4, 6, device="cpu")
        c["table"] = torch.arange(1, 7, dtype=torch.int32)[None]
        _, lg = model.prefill_slots(params, c, torch.tensor([tokens], dtype=torch.int32),
                                    torch.tensor([len(tokens)]), torch.tensor([0]))
        return torch.softmax(filter_logits(lg, 1.0, 3, 1.0, cfg.vocab_size), -1)[0].double()

    p0 = law(prompt.tolist())
    exact = {(int(a), int(b)): float(p0[a] * pb)
             for a in torch.nonzero(p0).flatten()
             for pb_row in [law(prompt.tolist() + [int(a)])]
             for b, pb in enumerate(pb_row.tolist()) if pb > 0}
    n = 192
    for draft_seed in (0, 7):
        eng = _port(draft_seed, num_slots=8, max_seq=P + 3)
        outs = eng.run([port_engine.Request(uid=u, prompt=prompt, max_new_tokens=3,
                                            sampling=dataclasses.replace(sp, seed=u))
                        for u in range(n)])
        pairs = [tuple(o.tokens[:2]) for o in outs]
        emp = {k: pairs.count(k) / n for k in set(pairs)}
        assert set(emp) <= set(exact), draft_seed
        tv = 0.5 * sum(abs(emp.get(k, 0.0) - v) for k, v in exact.items())
        assert tv < 0.1, (draft_seed, tv)
        assert eng.spec_drafted > 0
        if draft_seed == 0:
            assert eng.spec_accepted == eng.spec_drafted
        else:
            assert eng.spec_accepted < eng.spec_drafted


# -------------------------------------------------------- page accounting
def test_rollback_never_leaks_pages():
    sp = SamplingParams(temperature=1.2)
    eng = _port(7, prefix_cache=False, num_slots=2, page_size=2)
    _run(eng, _prompts(5), sampling=lambda u: dataclasses.replace(sp, seed=3 + u))
    assert eng.pool.in_use == 0
    assert all(not p for p in eng._slot_pages)
    ps = eng.pool_stats
    assert ps["spec_accepted"] < ps["spec_drafted"] and ps["spec_accept_rate"] < 1.0


def test_tight_pool_shrinks_lookahead():
    """A pool too small for full lookahead runs shallower rounds instead of
    preempting or failing, with the plain engine's tokens."""
    kw = dict(num_slots=2, page_size=2, num_pages=2 * ((P + G) // 2) + 2)
    base = _run(_port(**kw), _prompts(3))
    spec = _port(7, **kw)
    assert spec.pool.capacity * 2 < 2 * (P + G) + 2 * 3
    assert _run(spec, _prompts(3)) == base


# ------------------------------------------------------------------ gating
def test_gating_errors():
    cfg, _ = _cfgs()
    m = build_model(cfg)
    with pytest.raises(ValueError, match="spec_tokens must be >= 1"):
        _port(0, spec_tokens=0)
    with pytest.raises(ValueError, match="draft_model and draft_params"):
        port_engine.ServeEngine(m, {}, device="cpu", paged_cache=True, draft_params={},
                                spec_tokens=2)
    for kw, what in ((dict(paged_cache=False), "paged_cache"),
                     (dict(prefill="interleaved"), "prefill"), (dict(window=4), "window")):
        with pytest.raises(ValueError, match=what):
            _port(0, **kw)
    other = dataclasses.replace(cfg, vocab_size=cfg.vocab_size - 1)
    with pytest.raises(ValueError, match="vocab"):
        port_engine.ServeEngine(m, {}, device="cpu", paged_cache=True, spec_tokens=2,
                                draft_model=build_model(other), draft_params={})


def test_ssm_draft_raises():
    """A draft with neither the slot-cache API nor recurrent (ssm) state is
    refused, as the reference refuses it; an ssm draft gets the recurrent
    backend (``tests/test_torch_xlstm.py`` holds its tokens to the
    reference's)."""
    hybrid = build_model(get_smoke_config("recurrentgemma-2b"))
    with pytest.raises(ValueError, match="neither a slot-cache API"):
        make_draft_backend(hybrid, {}, num_slots=2, cap=16, spec_tokens=2, device="cpu")
    ssm = build_model(get_smoke_config("xlstm-125m"))
    draft = make_draft_backend(ssm, ssm.init(torch.Generator().manual_seed(0), "cpu"),
                               num_slots=2, cap=16, spec_tokens=2, device="cpu")
    assert type(draft).__name__ == "XlstmDraft"


def test_serve_cli_speculates_on_cpu(capsys):
    from repro_torch.launch.serve import main

    args = ["--continuous", "--device", "cpu", "--requests", "3", "--gen", "6",
            "--prompt-len", "8", "--slots", "2"]
    plain = main(args)
    spec = main(args + ["--draft", "stablelm-1.6b", "--spec-tokens", "3"])
    assert spec["generated"] == plain["generated"]
    assert spec["draft"] == "stablelm-1.6b-smoke" and spec["pool"]["spec_accept_rate"] > 0.9
    assert "spec k=3 accept" in capsys.readouterr().out
    for bad in (["--spec-tokens", "2"], ["--draft", "stablelm-1.6b"],
                ["--draft", "stablelm-1.6b", "--spec-tokens", "2", "--no-paged-cache"]):
        with pytest.raises(SystemExit):
            main(args + bad)


# ------------------------------------------------------------------ golden
def _shared_prefix_prompts(seed=3, page=4):
    rng = np.random.default_rng(seed)
    common = rng.integers(1, 512, 3 * page)
    cold = [rng.integers(1, 512, n) for n in (5, 9, 13)]
    shared = [np.concatenate([common, rng.integers(1, 512, k)]) for k in (0, 3, 6)]
    return cold + shared + [common.copy()]


def golden_trace() -> dict:
    """The speculative traces the card replays: the shared-prefix trace
    (cold, suffix and copy-on-write admissions) under a same-params and a
    foreign draft, on fp pages and on int8 pages."""
    engine = dict(num_slots=3, max_seq=32, page_size=4, prefix_cache=True, paged_cache=True)
    return {
        "config": f"{ARCH} smoke, dtype float32",
        "seed": 0,
        "spec_tokens": 3,
        "max_new_tokens": 10,
        "prompts": [p.tolist() for p in _shared_prefix_prompts()],
        "cases": [
            {"name": f"{kv}_draft{ds}", "draft_seed": ds, "engine": {**engine, "kv_dtype": kv}}
            for kv in ("fp", "int8") for ds in (0, 7)
        ],
    }


def make_golden() -> dict:
    """Run the reference engine, plain (once per page type) and speculative,
    on every case of ``golden_trace()``; add its tokens, finish reasons and
    round counters."""
    g = golden_trace()
    _, ref_cfg = _cfgs()
    plain = {}
    for case in g["cases"]:
        reqs = lambda: [ref_engine.Request(uid=u, prompt=np.asarray(p, np.int32),  # noqa: E731
                                           max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(g["prompts"])]
        kv = case["engine"]["kv_dtype"]
        if kv not in plain:
            plain[kv] = ref_engine.ServeEngine(ref_build_model(ref_cfg), _ref_params(g["seed"]),
                                               **case["engine"]).run(reqs())
        eng = ref_engine.ServeEngine(
            ref_build_model(ref_cfg), _ref_params(g["seed"]), **case["engine"],
            draft_model=ref_build_model(ref_cfg), draft_params=_ref_params(case["draft_seed"]),
            spec_tokens=g["spec_tokens"])
        outs = eng.run(reqs())
        case["tokens"] = [[int(t) for t in o.tokens] for o in outs]
        case["plain_tokens"] = [[int(t) for t in o.tokens] for o in plain[kv]]
        case["finish_reasons"] = [o.finish_reason for o in outs]
        case["counters"] = {k: eng.pool_stats[k] for k in SPEC_COUNTERS}
    return g


def test_golden_file_matches_reference():
    g = json.loads(GOLDEN.read_text())
    assert g == make_golden()
    assert all(c["tokens"] == c["plain_tokens"] for c in g["cases"])
    by = {c["name"]: c["counters"] for c in g["cases"]}
    assert by["fp_draft0"]["spec_accepted"] == by["fp_draft0"]["spec_drafted"] > 0
    assert by["fp_draft7"]["spec_accepted"] < by["fp_draft7"]["spec_drafted"]


def test_port_replays_golden_on_cpu():
    """What chip_smoke.py's golden speculative phase does on the card."""
    g = json.loads(GOLDEN.read_text())
    cfg, _ = _cfgs()
    for case in g["cases"]:
        eng = port_engine.ServeEngine(
            build_model(cfg), _port_params(g["seed"]), device="cpu", **case["engine"],
            draft_model=build_model(cfg), draft_params=_port_params(case["draft_seed"]),
            spec_tokens=g["spec_tokens"])
        outs = eng.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(g["prompts"])])
        assert [o.tokens for o in outs] == case["tokens"], case["name"]
        assert [o.finish_reason for o in outs] == case["finish_reasons"]
        assert {k: eng.pool_stats[k] for k in SPEC_COUNTERS} == case["counters"], case["name"]


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
