"""The port's sampling (``repro_torch.launch.sampling``) and the engine's
sampled decoding and EOS, against the reference.

The filter chain is held against the reference's ``filter_logits`` value
for value. The draws cannot be: the port's streams are its own (a Philox
generator per request, not the reference's threefry keys), so sampled
draws are checked by their law and by the reference's stream rules (a seed
fixes the tokens; a reused slot gets a fresh stream; an explicit seed does
not depend on the slot; greedy neighbours are untouched; chunked and
interleaved prefill agree). Greedy and EOS traces are held against the
reference engine token for token, on the same numpy-drawn float32 weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import engine as ref_engine
from repro.launch import sampling as ref_sampling
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch.sampling import (
    NEG_INF, SamplingParams, draw, filter_logits, request_stream, sample_rows, sample_token,
)
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
P, G = 8, 6


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


@pytest.fixture(scope="module")
def parts():
    cfg, _ = _cfgs()
    return cfg, build_model(cfg), params_from_numpy(numpy_params(cfg, 0), cfg, "cpu")


def _engine(parts, **kw):
    _, model, params = parts
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", P + G)
    return port_engine.ServeEngine(model, params, device="cpu", **kw)


def _requests(cfg, n=3, gen=G):
    return port_engine.make_requests(cfg, n_requests=n, prompt_len=P, gen_tokens=gen, seed=0)


# ----------------------------------------------------------- filter chain
@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.6), (0.9, 12, 0.8), (2.0, 1, 1.0),
    (1.0, 0, 1e-6),
])
def test_filter_logits_matches_reference(temperature, top_k, top_p):
    """Same kept set as the reference's filter on seeded logits (padded
    vocab columns included), kept values within 1e-6."""
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    vocab, vp = 200, 256
    logits = (rng.standard_normal((4, vp)) * 3).astype(np.float32)
    logits[:, vocab:] = NEG_INF
    want = np.stack([np.asarray(ref_sampling.filter_logits(
        jnp.asarray(row), jnp.float32(temperature), jnp.int32(top_k), jnp.float32(top_p),
        vocab)) for row in logits])
    got = filter_logits(torch.from_numpy(logits), temperature, top_k, top_p, vocab).numpy()
    assert got.shape == (4, vocab)
    np.testing.assert_array_equal(got == NEG_INF, want == NEG_INF)
    kept = want != NEG_INF
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)


def test_filter_logits_per_row_parameters():
    """Each row's own temperature/top-k/top-p: a batched call equals the
    rows filtered one at a time."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    temps, ks, ps = [0.5, 1.0, 1.7], [0, 4, 10], [0.9, 1.0, 0.5]
    batched = filter_logits(logits, torch.tensor(temps), torch.tensor(ks), torch.tensor(ps), 64)
    for r in range(3):
        one = filter_logits(logits[r:r + 1], temps[r], ks[r], ps[r], 64)
        torch.testing.assert_close(batched[r:r + 1], one, rtol=0, atol=0)


def test_top_k_one_and_tiny_top_p_are_greedy():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    best = int(logits.argmax())
    stream = np.random.default_rng(1)
    for _ in range(8):
        assert sample_token(stream, logits, 1.0, 1, 1.0, 64) == best
        assert sample_token(stream, logits, 1.0, 0, 1e-6, 64) == best


def test_top_k_restricts_support_and_top_p_keeps_nucleus():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    top5 = set(torch.argsort(-logits)[:5].tolist())
    u = torch.from_numpy(np.random.default_rng(5).random(256))
    seen = set(sample_rows(logits.expand(256, -1), u, 2.0, 5, 1.0, 64).tolist())
    assert seen <= top5 and len(seen) > 1, seen
    # one dominant token (p ~ 0.88) and a tail: top_p 0.5 always takes it
    dominant = torch.zeros(16)
    dominant[3] = 5.0
    assert set(sample_rows(dominant.expand(64, -1), u[:64], 1.0, 0, 0.5, 16).tolist()) == {3}


def test_draw_never_takes_a_zero_probability_token():
    probs = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.0], [0.0, 0.0, 1.0, 0.0, 0.0]])
    for u in (0.0, 0.25, 0.5, 0.999999, 1.0 - 2.0**-53):
        toks = draw(probs, torch.full((2,), u, dtype=torch.float64)).tolist()
        assert toks[0] in (1, 3) and toks[1] == 2, (u, toks)


def test_sampler_law_matches_filtered_softmax():
    """4096 draws of one row through the batched sampler: the empirical law
    is within 0.05 total variation of softmax(filter_logits(row))."""
    rng = np.random.default_rng(11)
    vocab = 512
    row = torch.from_numpy((rng.standard_normal(vocab) * 2).astype(np.float32))
    n = 4096
    u = torch.from_numpy(rng.random(n))
    toks = sample_rows(row.expand(n, -1), u, 0.8, 40, 0.95, vocab)
    p = torch.softmax(filter_logits(row[None], 0.8, 40, 0.95, vocab), -1)[0]
    emp = torch.bincount(toks, minlength=vocab).double() / n
    tv = 0.5 * (emp - p.double()).abs().sum().item()
    assert tv < 0.05, tv
    assert bool((p[toks] > 0).all())


def test_sampling_params_validation():
    for bad in (dict(temperature=-0.1), dict(top_p=0.0), dict(top_p=1.5), dict(top_k=-1)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert SamplingParams(temperature=0.0).is_greedy
    assert not SamplingParams().is_greedy


def test_request_streams_are_keyed_by_request():
    """Engine-derived streams differ by uid (negative warm-up uids too) and
    never replay an explicit seed's stream; a stream is a function of its
    key alone."""
    draws = {
        "uid0": request_stream(None, 7, 0).random(4),
        "uid1": request_stream(None, 7, 1).random(4),
        "uid-1": request_stream(None, 7, -1).random(4),
        "seed7": request_stream(7, 0, 0).random(4),
        "seed0": request_stream(0, 7, 0).random(4),
    }
    vals = [tuple(v) for v in draws.values()]
    assert len(set(vals)) == len(vals)
    np.testing.assert_array_equal(request_stream(None, 7, 1).random(4), draws["uid1"])


# ------------------------------------------------------ engine stream rules
def test_same_seed_same_tokens(parts):
    cfg = parts[0]
    sp = SamplingParams(temperature=0.9, top_k=0, top_p=0.95, seed=42)

    def run():
        reqs = _requests(cfg)
        for r in reqs:
            r.sampling = sp
        return [o.tokens for o in _engine(parts).run(reqs)]

    a, b = run(), run()
    assert a == b
    greedy = [o.tokens for o in _engine(parts).run(_requests(cfg))]
    assert a != greedy, "temperature 0.9 sampled exactly the greedy trace"


def test_slot_reuse_gets_fresh_stream(parts):
    """Two identical prompts without explicit seeds, served one after the
    other through ONE slot: the stream is keyed by the request (engine seed
    + uid), so the second occupant does not replay the first's tokens."""
    base = _requests(parts[0], 1)[0]
    reqs = [port_engine.Request(uid=i, prompt=base.prompt, max_new_tokens=G,
                                sampling=SamplingParams(temperature=5.0)) for i in range(2)]
    outs = _engine(parts, num_slots=1, seed=7).run(reqs)
    assert outs[0].slot == outs[1].slot == 0
    assert outs[0].tokens != outs[1].tokens


def test_same_explicit_seed_is_slot_independent(parts):
    """The same request (prompt and explicit seed) served from different
    slots, beside different neighbours, gives identical tokens."""
    base = _requests(parts[0], 1)[0]
    sp = SamplingParams(temperature=0.9, seed=11)

    def run(n_slots, engine_seed):
        reqs = [port_engine.Request(uid=1, prompt=base.prompt, max_new_tokens=G, sampling=sp)]
        if n_slots > 1:  # a filler takes slot 0
            reqs.insert(0, port_engine.Request(uid=0, prompt=base.prompt, max_new_tokens=G))
        probe = [o for o in _engine(parts, num_slots=n_slots, seed=engine_seed).run(reqs)
                 if o.uid == 1][0]
        return probe.slot, probe.tokens

    slot_a, toks_a = run(1, 100)
    slot_b, toks_b = run(2, 200)
    assert slot_a != slot_b
    assert toks_a == toks_b


def test_greedy_requests_unaffected_by_sampling_neighbors(parts):
    cfg = parts[0]
    reqs = _requests(cfg)
    reqs[0].sampling = SamplingParams(temperature=1.5, seed=3)
    reqs[2].sampling = SamplingParams(temperature=1.5, seed=4)
    mixed = {o.uid: o.tokens for o in _engine(parts, num_slots=3).run(reqs)}
    solo = _engine(parts, num_slots=1).run(_requests(cfg)[1:2])
    assert mixed[1] == solo[0].tokens


@pytest.mark.parametrize("prefill", ["chunked", "interleaved"])
def test_sampling_deterministic_across_prefill_modes(parts, prefill):
    """The first sampled token comes from the prefill logits (chunked) or
    the last teacher-forced decode step (interleaved): the same logits, so
    the same sampled sequence."""
    cfg = parts[0]

    def run(mode):
        reqs = _requests(cfg, 2)
        for r in reqs:
            r.sampling = SamplingParams(temperature=0.8, top_k=50, seed=21 + r.uid)
        return [o.tokens for o in _engine(parts, prefill=mode).run(reqs)]

    assert run("chunked") == run(prefill)


def test_preempted_sampled_request_keeps_its_stream(parts):
    """A tight pool preempts and re-prefills a sampled request: its stream
    rides along in the resume record, so its tokens equal those of an
    ample pool's run."""
    cfg = parts[0]

    def run(num_pages):
        reqs = _requests(cfg, 3, gen=10)
        for r in reqs:
            r.sampling = SamplingParams(temperature=1.0, seed=5 + r.uid)
        eng = _engine(parts, num_slots=3, max_seq=P + 10, paged_cache=True, page_size=4,
                      num_pages=num_pages)
        return [o.tokens for o in eng.run(reqs)], eng.preemptions

    tight, n_pre = run(10)
    ample, _ = run(0)
    assert n_pre > 0 and tight == ample


# ------------------------------------------------------------------ EOS
@pytest.mark.parametrize("paged_cache", [True, False])
def test_eos_tokens_and_finish_reason_match_reference(paged_cache):
    """``eos_id`` set to a token the greedy trace emits mid-way: the port's
    tokens and finish reasons equal the reference engine's."""
    cfg, ref_cfg = _cfgs()
    tree = numpy_params(cfg, 0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, n) for n in (3, 8, 11, 6, 16)]
    kw = dict(num_slots=3, max_seq=32, paged_cache=paged_cache, page_size=4)
    plain = port_engine.ServeEngine(build_model(cfg), params_from_numpy(tree, cfg, "cpu"),
                                    device="cpu", **kw)
    toks = [o.tokens for o in plain.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=8)
                                         for u, p in enumerate(prompts)])]
    eos = toks[1][3]
    ref = ref_engine.ServeEngine(
        ref_build_model(ref_cfg), jax.tree_util.tree_map(jnp.asarray, tree), eos_id=eos, **kw)
    ref_out = ref.run([ref_engine.Request(uid=u, prompt=p, max_new_tokens=8)
                       for u, p in enumerate(prompts)])
    port = port_engine.ServeEngine(build_model(cfg), params_from_numpy(tree, cfg, "cpu"),
                                   device="cpu", eos_id=eos, **kw)
    port_out = port.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=8)
                         for u, p in enumerate(prompts)])
    assert [o.tokens for o in port_out] == [o.tokens for o in ref_out]
    assert [o.finish_reason for o in port_out] == [o.finish_reason for o in ref_out]
    assert port_out[1].finish_reason == "eos" and port_out[1].tokens == toks[1][:4]
    for o, full in zip(port_out, toks):
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert o.tokens == full[:cut]
        assert o.finish_reason == ("eos" if eos in full else "length")


def test_serve_cli_samples_on_cpu(capsys):
    from repro_torch.launch.serve import main

    args = ["--continuous", "--device", "cpu", "--requests", "3", "--gen", "4",
            "--prompt-len", "8", "--slots", "2"]
    a = main(args + ["--temperature", "0.8", "--top-k", "40", "--top-p", "0.95"])
    b = main(args + ["--temperature", "0.8", "--top-k", "40", "--top-p", "0.95"])
    greedy = main(args)
    assert a["generated"] == b["generated"] != greedy["generated"]
    assert a["sampling"] == dict(temperature=0.8, top_k=40, top_p=0.95, seed=0)
    assert a["finish_reasons"] == ["length"] * 3
    with pytest.raises(SystemExit):
        main(args + ["--top-k", "4"])           # top-k without a temperature
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--temperature", "0.8"])  # the single batch is greedy
