"""The port's bounded specializations (``launch/graphs.py``): one CUDA graph
per shape key on the card, counted as the engine's ``compiles``.

The gates of the reference's ``tests/test_engine_perf.py`` on the port at the
smoke config, on the CPU, where the graph cache runs each function eagerly
through the same static buffers: the bucket ladders; many round shapes
specialize ``prefill_slots`` at most bucket-many times with ``decode`` once;
a warmed engine adds no specialization; ``bucket_prefill=False`` specializes
once per shape; suffix rounds stay in their ladder; the speculative entries.
Beside them: the counts equal the reference engine's on a mixed trace over
bridged weights (with equal tokens); ``graphs=False`` (every dispatch eager)
gives the tokens and counters of the default over every serving layout; the
fp pool's unmasked write equals the masked one outside scratch page 0; the
static-output aliasing holds on the CPU. On the card: replays count their
launches, a host read raises at capture, and the cyclic collector frees no
dead graph inside a capture. The ``*_cuda`` tests need an sm_90
card and skip elsewhere; only the reference parity test imports JAX, so the
card's machine runs them with ``python -m pytest -q --noconftest
tests/test_torch_graphs.py -k cuda``."""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build, ref
from repro_torch.launch.engine import (
    Request, ServeEngine, bucket_length, bucket_pages, bucket_width, make_requests,
)
from repro_torch.launch.graphs import GraphCache
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.serve import generate_batch
from repro_torch.models import attention
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
G = 4  # generated tokens per request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's smoke-size ops gain nothing from intra-op threads, and in a
    loaded test run (a worker per core) an OpenMP region stalls on its
    descheduled threads: this module's torch ops run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_and_params():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def _build(model_and_params, **kw):
    _, model, params = model_and_params
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq", 32)
    return ServeEngine(model, params, device="cpu", **kw)


def _reqs(cfg, lens, *, uid0=0, gen=G, seed=0, sampling=None):
    """One request per entry of ``lens``, sliced from one corpus draw."""
    base = make_requests(cfg, n_requests=len(lens), prompt_len=max(lens), gen_tokens=gen,
                         seed=seed)
    return [Request(uid=uid0 + j, prompt=r.prompt[: lens[j]], max_new_tokens=gen,
                    sampling=None if sampling is None else sampling(uid0 + j))
            for j, r in enumerate(base)]


# ------------------------------------------------------------ bucket helpers
def test_bucket_ladders():
    assert [bucket_width(n, 4) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    assert [bucket_width(n, 6) for n in (1, 3, 5, 6)] == [1, 4, 6, 6]
    assert [bucket_length(s) for s in (1, 8, 9, 16, 17, 100)] == [8, 8, 16, 16, 32, 128]
    assert [bucket_pages(p, 5) for p in (1, 2, 3, 5, 9)] == [1, 2, 4, 5, 5]


# ------------------------------------------------------------ recompile guard
@pytest.mark.parametrize("paged", [False, True], ids=["rings", "pool"])
def test_many_round_shapes_stay_in_the_bucket_ladder(model_and_params, paged):
    """>= 20 distinct (round width, round max length) admission shapes
    specialize ``prefill_slots`` at most bucket-ladder-many times, ``decode``
    once; more traffic in covered buckets adds nothing."""
    cfg = model_and_params[0]
    kw = dict(paged_cache=True, page_size=8) if paged else {}
    engine = _build(model_and_params, **kw)
    shapes = [(w, n) for w in (1, 2, 3, 4) for n in (3, 5, 7, 9, 11, 13)][:21]
    uid = 0
    for w, n in shapes:
        engine.run(_reqs(cfg, [n] * w, uid0=uid))
        uid += w
    n_buckets = len({(bucket_width(w, 4), bucket_length(n)) for w, n in shapes})
    compiled = engine.compiles["prefill_slots"]
    assert compiled <= n_buckets < len(shapes)
    assert engine.compiles["decode"] == 1
    assert engine.compiles["prefill_suffix"] == engine.compiles["prefill"] == 0
    before = engine.compiles
    engine.reset_metrics()  # compiles outlive a metrics window
    engine.run(_reqs(cfg, [4, 6, 12], uid0=uid))
    assert engine.compiles == before


def test_warmed_engine_adds_no_specialization(model_and_params):
    cfg = model_and_params[0]
    engine = _build(model_and_params, paged_cache=True, page_size=8, prefix_cache=True)
    lens = [5, 9, 13, 16]
    engine.warm(lens)
    before = engine.compiles
    assert before["decode"] == 1 and before["prefill_slots"] > 0
    for j, w in enumerate((1, 3, 4, 2)):
        engine.run(_reqs(cfg, lens[:w], uid0=10 * j, seed=j))
    assert engine.compiles["prefill_slots"] == before["prefill_slots"]
    assert engine.compiles["decode"] == 1


def test_unbucketed_engine_specializes_per_shape(model_and_params):
    """The contrast case: ``bucket_prefill=False`` dispatches each round at
    its exact shape, one specialization per distinct (width, length); the
    tokens are the bucketed engine's."""
    cfg = model_and_params[0]
    shapes = [(1, 3), (1, 5), (2, 3), (2, 5), (3, 7)]
    outs = {}
    for bucketed in (True, False):
        engine = _build(model_and_params, bucket_prefill=bucketed)
        outs[bucketed] = [engine.run(_reqs(cfg, [n] * w, uid0=100 * j))
                          for j, (w, n) in enumerate(shapes)]
        if not bucketed:
            assert engine.compiles["prefill_slots"] == len(shapes)
        else:
            assert engine.compiles["prefill_slots"] == len(
                {(bucket_width(w, 4), bucket_length(n)) for w, n in shapes})
    for a, b in zip(outs[True], outs[False]):
        assert [o.tokens for o in a] == [o.tokens for o in b]


def test_suffix_rounds_stay_in_the_bucket_ladder(model_and_params):
    """Suffix rounds bucket (width, suffix length) like cold rounds, and
    every round here hits the same 4 shared pages (one prefix-width
    bucket): the suffix specializations stay inside that ladder."""
    cfg = model_and_params[0]
    engine = _build(model_and_params, paged_cache=True, page_size=4, prefix_cache=True)
    rng = np.random.default_rng(0)
    common = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    engine.run([Request(uid=0, prompt=common, max_new_tokens=2)])
    suffix_shapes = set()
    uid = 1
    for w, sl in [(1, 3), (1, 5), (2, 3), (2, 7), (3, 5), (4, 9), (2, 11), (1, 9), (3, 11),
                  (4, 3)]:
        reqs = []
        for _ in range(w):
            tail = rng.integers(1, cfg.vocab_size, sl).astype(np.int32)
            reqs.append(Request(uid=uid, max_new_tokens=2,
                                prompt=np.concatenate([common, tail])))
            uid += 1
        engine.run(reqs)
        suffix_shapes.add((bucket_width(w, 4), bucket_length(sl)))
    assert engine.prefix_hit_pages > 0
    assert engine.compiles["prefill_slots"] <= 1
    assert engine.compiles["prefill_suffix"] <= len(suffix_shapes)
    assert engine.compiles["decode"] == 1
    before = engine.prefill_compiles
    tail = rng.integers(1, cfg.vocab_size, 4).astype(np.int32)
    engine.run([Request(uid=uid, max_new_tokens=2, prompt=np.concatenate([common, tail]))])
    assert engine.prefill_compiles == before


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_speculative_entries(model_and_params, sampled):
    """The speculative round's entries: the verify per (width, length,
    prefix width), the draft's prefill per length bucket and its propose
    per whether any row samples; decode never runs."""
    cfg, model, params = model_and_params
    engine = _build(model_and_params, paged_cache=True, page_size=4, draft_model=model,
                    draft_params=params, spec_tokens=3)
    sp = (lambda u: SamplingParams(temperature=0.8, top_k=8, seed=u)) if sampled else None
    engine.run(_reqs(cfg, [5, 9, 7], sampling=sp))
    c = engine.compiles
    assert c["spec_verify"] >= 1 and c["draft_prefill"] >= 1
    assert c["draft_propose"] == 1 and c["decode"] == 0
    assert c.get("sample_rows", 0) == (1 if sampled else 0)
    before = engine.compiles
    engine.run(_reqs(cfg, [5, 9, 7], uid0=10, sampling=sp))
    assert engine.compiles == before


# ------------------------------------------------------- parity with JAX
def test_compiles_match_the_reference_engine():
    """A mixed trace (cold rounds of widths 1, 2 and 3, then a round whose
    rows hit the prefix index) through the reference engine and the port on
    the same weights: equal decode, prefill_slots and prefill_suffix
    counts, and equal tokens."""
    import jax.numpy as jnp
    from jax.tree_util import tree_map

    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.launch import engine as ref_engine
    from repro.models import build_model as ref_build_model

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config(ARCH), dtype="float32")
    tree = numpy_params(cfg, 0)
    rng = np.random.default_rng(5)
    common = rng.integers(1, 512, 8)
    rounds = [[rng.integers(1, 512, 5)],
              [rng.integers(1, 512, n) for n in (9, 12)],
              [np.concatenate([common, rng.integers(1, 512, 3)])]
              + [rng.integers(1, 512, n) for n in (3, 20)],
              [np.concatenate([common, rng.integers(1, 512, n)]) for n in (2, 6)]]
    kw = dict(num_slots=4, max_seq=32, paged_cache=True, page_size=4, prefix_cache=True)
    port = ServeEngine(build_model(cfg), params_from_numpy(tree, cfg, "cpu"), device="cpu",
                       **kw)
    ref = ref_engine.ServeEngine(
        ref_build_model(ref_cfg), tree_map(lambda a: jnp.asarray(a), tree), **kw)
    uid = 0
    for prompts in rounds:
        ids = range(uid, uid + len(prompts))
        a = port.run([Request(uid=u, prompt=p, max_new_tokens=3) for u, p in zip(ids, prompts)])
        b = ref.run([ref_engine.Request(uid=u, prompt=p, max_new_tokens=3)
                     for u, p in zip(ids, prompts)])
        assert [o.tokens for o in a] == [o.tokens for o in b]
        uid += len(prompts)
    assert port.suffix_dispatches > 0
    for key in ("decode", "prefill_slots", "prefill_suffix"):
        assert port.compiles[key] == ref.compiles[key], (key, port.compiles, ref.compiles)
    assert port.prefill_compiles == ref.prefill_compiles


# -------------------------------------------------- graphs on == graphs off
def _trace(cfg, sampled=False):
    sp = (lambda u: SamplingParams(temperature=0.9, top_k=16, top_p=0.9, seed=u)
          if u % 2 == 0 else None) if sampled else None
    return (_reqs(cfg, [5, 11, 7, 16, 3], gen=6, sampling=sp)
            + _reqs(cfg, [9, 4], uid0=5, gen=5, seed=1, sampling=sp))


GRAPH_LAYOUTS = {
    "fp pages": dict(paged_cache=True, page_size=4, prefix_cache=True, num_slots=3),
    "int8 pages + host tier": dict(paged_cache=True, page_size=4, prefix_cache=True,
                                   num_slots=3, kv_dtype="int8", num_pages=9, host_pages=16),
    "rings, window": dict(num_slots=3, window=6),
    "interleaved": dict(num_slots=3, prefill="interleaved", paged_cache=True, page_size=4),
    "speculative": dict(paged_cache=True, page_size=4, prefix_cache=True, num_slots=3,
                        spec_tokens=3),
}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", sorted(GRAPH_LAYOUTS))
def test_graphs_off_gives_the_same_tokens_and_counters(model_and_params, layout, sampled):
    cfg, model, params = model_and_params
    kw = dict(GRAPH_LAYOUTS[layout])
    if "spec_tokens" in kw:
        kw.update(draft_model=model, draft_params=params)
    runs = {}
    for graphs in (True, False):
        engine = _build(model_and_params, graphs=graphs, **kw)
        outs = engine.run(_trace(cfg, sampled))
        runs[graphs] = ([(o.uid, o.tokens, o.finish_reason, o.slot) for o in outs],
                        engine.pool_stats, engine.steps, engine.compiles)
    assert runs[True] == runs[False]
    if layout == "int8 pages + host tier":
        assert runs[True][1]["swapped_in_pages"] > 0


def test_generate_batch_graphs_off_same_tokens(model_and_params):
    cfg, model, params = model_and_params
    prompts = torch.from_numpy(np.random.default_rng(2).integers(1, 512, (3, 7)))
    graphs = GraphCache("cpu")
    a, _, _ = generate_batch(model, params, prompts, 9, window=5, graphs=graphs)
    b, _, _ = generate_batch(model, params, prompts, 9, window=5,
                             graphs=GraphCache("cpu", enabled=False))
    assert torch.equal(a, b)
    assert graphs.counts == {"decode": 1}


# ---------------------------------------------------------- the fp write
@pytest.mark.parametrize("lengths,starts", [
    ([0, 0, 0], [0, 0, 0]),        # padding rows only
    ([1, 0, 1], [0, 5, 13]),       # one token
    ([6, 3, 0], [2, 7, 0]),        # page-crossing
    ([20, 9, 17], [0, 11, 3]),     # longer than the ring: wraps
])
def test_fp_pool_write_equals_masked_write_outside_page_0(lengths, starts):
    """All n·S tokens in one index store per plane, dead ones on scratch
    page 0: every plane equals the masked write of the live tokens outside
    page 0."""
    gen = torch.Generator().manual_seed(sum(lengths) + 1)
    n, s, page, t_w, hkv, hd = 3, 20, 4, 4, 2, 8
    pool = {name: torch.randn(13, page, hkv, hd, generator=gen) for name in ("k", "v")}
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 7], [8, 9, 10, 11]], dtype=torch.int32)
    k, v = (torch.randn(n, s, hkv, hd, generator=gen) for _ in range(2))
    st, ln = torch.tensor(starts, dtype=torch.int32), torch.tensor(lengths, dtype=torch.int32)
    masked = {name: t.clone() for name, t in pool.items()}
    live, phys, off = ref.live_slots(table, st, ln, s, page)
    masked["k"][phys, off] = k[live]
    masked["v"][phys, off] = v[live]
    attention.fill_pages_rows(pool, k, v, table, st, ln)
    for name in ("k", "v"):
        assert torch.equal(pool[name][1:], masked[name][1:]), name


# --------------------------------------------------- the cache's own rules
def test_cpu_static_outputs_alias_like_graphs():
    """On the CPU the cache runs the function eagerly through static
    buffers: a returned output is the key's static output, so reading it
    after the next call of that key sees the newer values (as a graph's
    static output would); other keys own other buffers; ``enabled=False``
    returns fresh outputs. Keys are counted once in both modes."""
    calls = []

    def fn(x, y):
        calls.append(1)
        return x * 2, (x + y if y is not None else None)

    for enabled in (True, False):
        cache = GraphCache("cpu", enabled=enabled, entries=("f",))
        a1, s1 = cache("f", (), fn, torch.tensor([1.0, 2.0]), torch.tensor([1.0, 1.0]))
        a2, s2 = cache("f", (), fn, torch.tensor([3.0, 4.0]), torch.tensor([0.0, 1.0]))
        a3, s3 = cache("f", (7,), fn, torch.tensor([5.0, 6.0]), None)
        assert a2.tolist() == [6.0, 8.0] and s2.tolist() == [3.0, 5.0] and s3 is None
        assert a3.tolist() == [10.0, 12.0]
        assert (a1 is a2) == enabled
        assert a1.tolist() == ([6.0, 8.0] if enabled else [2.0, 4.0])
        assert cache.counts == {"f": 2}
        assert cache.graphs == (2 if enabled else 0) and cache.pool_bytes() == 0
    assert len(calls) == 6  # no graphs on the CPU: every call runs


@pytest.fixture
def sm90():
    """Skip unless an sm_90 (Hopper) card is present, decided at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs capture the sm_90a kernels")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")


def test_replays_count_launches_and_host_syncs_raise_cuda(sm90):
    """A replay adds its captured launches to ``LAUNCHES`` (the capture
    counts none); the first call is the warm-up's execution, not a replay
    too; a host read inside the captured function raises at capture."""
    from repro_torch.kernels import ops

    q = torch.randn(2, 2, 1, 64, device="cuda")
    pool = torch.randn(4, 16, 2, 64, device="cuda")
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32, device="cuda")
    counter = torch.zeros((), device="cuda")

    def fn(pos):
        counter.add_(1)
        return ops.paged_decode_attention(q, pool, pool, pos, table)

    cache = GraphCache("cuda", entries=("f",))
    pos = torch.tensor([20, 3], dtype=torch.int32)
    build.reset_launches()
    outs = [cache("f", (), fn, pos).clone() for _ in range(3)]
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_decode"] == 3 and float(counter) == 3.0
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(outs[0], fn(pos.cuda()))
    bad = GraphCache("cuda")
    with pytest.raises(Exception):
        bad("f", (), lambda x: x * float(x.sum().item()), torch.ones(4))


def test_collector_frees_no_graph_inside_a_capture_cuda(sm90):
    """A dead cache in a reference cycle holds a captured graph; another
    cache's captured function allocates past the collector's thresholds.
    CUDA refuses to destroy a graph while a stream captures (the capture
    would be invalidated), so the collector stays off for the capture and
    the dead graph goes after it."""
    dead = GraphCache("cuda")
    x = torch.ones(256, device="cuda")
    for _ in range(2):
        dead("f", (), lambda t: t * 2, x)
    dead.me = dead
    assert dead.graphs == 1
    del dead

    def fn(t):
        if torch.cuda.is_current_stream_capturing():
            junk = [[] for _ in range(20000)]
            assert len(junk) == 20000
        return t + 1

    cache = GraphCache("cuda")
    outs = [cache("g", (), fn, torch.ones(4)).clone() for _ in range(2)]
    torch.cuda.synchronize()
    assert all(o.tolist() == [2.0] * 4 for o in outs)
    assert cache.graphs == 1 and gc.isenabled()
