"""The port's serving engine against the reference engine.

Both engines run the stablelm-1.6b smoke config in float32 on the same
numpy-drawn weights (``repro_torch.bridge.numpy_params``) and the same
explicit prompts, both with ``paged_cache=True``. Greedy decoding
must give IDENTICAL tokens and equal pool counters: at fp32 the two
packages' logits agree to ~1e-6, far inside the gap between the top two
logits of these traces, so any token difference is a scheduling or
page-table fault, not rounding.

Also here: the bucket ladders, the page allocator and the prefix index
(the port's copies against the reference's cases), and the golden file
the card replays (``src/repro_torch/testdata/golden_stablelm_smoke.json``;
rewrite it with ``PYTHONPATH=src:. python tests/test_torch_engine.py``)."""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import engine as ref_engine
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.prefix_cache import PrefixCache
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
GOLDEN = (pathlib.Path(__file__).resolve().parents[1]
          / "src" / "repro_torch" / "testdata" / "golden_stablelm_smoke.json")
COUNTERS = ("prefill_tokens", "prefix_hit_pages", "cow_copies", "suffix_dispatches",
            "cold_dispatches", "preemptions")


def _f32_configs():
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(ref_smoke_config(ARCH), dtype="float32"))


def _serve_both(prompts, gen, seed=0, **engine_kw):
    cfg, ref_cfg = _f32_configs()
    tree = numpy_params(cfg, seed)
    ref_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    ref = ref_engine.ServeEngine(ref_build_model(ref_cfg), ref_params, paged_cache=True,
                                 **engine_kw)
    ref_out = ref.run([ref_engine.Request(uid=u, prompt=p, max_new_tokens=gen)
                       for u, p in enumerate(prompts)])
    port = port_engine.ServeEngine(build_model(cfg), params_from_numpy(tree, cfg, "cpu"),
                                   device="cpu", paged_cache=True, **engine_kw)
    port_out = port.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=gen)
                         for u, p in enumerate(prompts)])
    return ref, ref_out, port, port_out


def _shared_prefix_prompts(seed=3, page=4):
    rng = np.random.default_rng(seed)
    common = rng.integers(1, 512, 3 * page)
    cold = [rng.integers(1, 512, n) for n in (5, 9, 13)]
    # the last prompt IS the common prefix: fully cached → copy-on-write
    shared = [np.concatenate([common, rng.integers(1, 512, k)]) for k in (0, 3, 6)]
    return cold + shared + [common.copy()]


TRACES = {
    "cold_burst": dict(
        prompts=lambda: [np.random.default_rng(1).integers(1, 512, n) for n in (3, 8, 11, 6, 16)],
        gen=6, kw=dict(num_slots=3, max_seq=32, page_size=4, prefix_cache=False)),
    "shared_prefix_cow": dict(
        prompts=_shared_prefix_prompts, gen=6,
        kw=dict(num_slots=3, max_seq=32, page_size=4, prefix_cache=True)),
    "tight_pool_preemption": dict(
        prompts=_shared_prefix_prompts, gen=6,
        kw=dict(num_slots=3, max_seq=32, page_size=4, prefix_cache=True, num_pages=9)),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_engine_tokens_and_counters_match_reference(trace):
    spec = TRACES[trace]
    ref, ref_out, port, port_out = _serve_both(spec["prompts"](), spec["gen"], **spec["kw"])
    assert [o.uid for o in port_out] == [o.uid for o in ref_out]
    for a, b in zip(port_out, ref_out):
        assert a.tokens == b.tokens, f"{trace} uid {a.uid}: {a.tokens} != {b.tokens}"
        assert len(a.tokens) == spec["gen"] and b.finish_reason == "length"
    for key in COUNTERS:
        assert port.pool_stats[key] == ref.pool_stats[key], key
    if trace == "tight_pool_preemption":
        assert port.preemptions > 0
    if trace == "shared_prefix_cow":
        assert port.cow_copies > 0 and port.suffix_dispatches > 0
    assert port.pool.in_use == ref.pool.in_use  # every slot page returned


def test_bucket_ladders_match_reference():
    for n in range(0, 70):
        for slots in (1, 3, 4, 8):
            assert port_engine.bucket_width(n, slots) == ref_engine.bucket_width(n, slots)
        assert port_engine.bucket_length(n) == ref_engine.bucket_length(n)
        for tw in (1, 5, 16):
            assert port_engine.bucket_pages(n, tw) == ref_engine.bucket_pages(n, tw)


# ------------------------------------------------------------- page pool
def test_page_pool_lifo_and_refcounts():
    """The cases of tests/test_page_pool.py on the port's copy: ascending
    fresh allocation, LIFO reuse, all-or-nothing alloc, refcounted shares,
    double-free and share-of-free guards."""
    pool = port_engine.PagePool(num_pages=8, page_size=4)
    assert pool.capacity == 7
    a, b = pool.alloc(3), pool.alloc(2)
    assert a == [1, 2, 3] and b == [4, 5]
    pool.free(a)
    pool.free(b)
    assert pool.alloc(2) == [5, 4] and pool.alloc(3) == [3, 2, 1]
    assert pool.alloc(2) == [6, 7] and pool.alloc(1) is None
    assert pool.peak_in_use == 7 and 0 not in pool._rc
    pool = port_engine.PagePool(num_pages=6, page_size=4)
    a, b = pool.alloc(2), pool.alloc(1)
    assert pool.share(a[0]) == 2 and pool.live_refs == 4
    pool.free(a)
    pool.free(b)
    assert pool.refcount(a[0]) == 1
    assert pool.alloc(2) == [3, 2]
    pool.free([a[0]])
    assert pool.alloc(1) == [a[0]]
    with pytest.raises(ValueError, match="free"):
        pool.free([4])
    pool.free([a[0]])
    with pytest.raises(ValueError, match="share"):
        pool.share(a[0])
    with pytest.raises(ValueError, match="reserved"):
        port_engine.PagePool(num_pages=1, page_size=4)


# ---------------------------------------------------------- prefix index
def test_prefix_cache_trie_cases():
    """The trie cases of tests/test_prefix_cache.py on the port's copy."""
    pool = port_engine.PagePool(num_pages=16, page_size=4)
    cache = PrefixCache(pool)
    toks = np.arange(100, 111, dtype=np.int32)
    pages = pool.alloc(3)
    assert cache.match(toks) == []
    assert cache.insert(toks, pages[:2]) == 2
    pool.free(pages)
    assert pool.refcount(pages[0]) == 1 and pool.refcount(pages[2]) == 0
    assert cache.match(toks[:8]) == pages[:2] and cache.match(toks[:7]) == pages[:1]
    divergent = toks.copy()
    divergent[5] = 999
    assert cache.match(divergent) == pages[:1]
    dup = pool.alloc(2)
    assert cache.insert(toks, dup) == 0           # dedupe keeps the first pages
    pool.free(dup)
    assert pool.refcount(dup[0]) == 0
    # LRU leaf eviction with a shared interior node
    pool = port_engine.PagePool(num_pages=16, page_size=2)
    cache = PrefixCache(pool)
    a = np.asarray([1, 1, 2, 2], np.int32)
    b = np.asarray([1, 1, 3, 3], np.int32)
    pa = pool.alloc(2)
    cache.insert(a, pa)
    pb = pool.alloc(1)
    cache.insert(b, [pa[0], pb[0]])
    pool.free(pa)
    pool.free(pb)
    cache.match(a)
    assert cache.evict(1) == 1 and cache.match(b) == [pa[0]] and cache.match(a) == pa
    assert cache.evict(10) == 2 and cache.size == 0 and pool.available == pool.capacity
    # a page a live slot still shares leaves the index but stays allocated
    pool = port_engine.PagePool(num_pages=8, page_size=4)
    cache = PrefixCache(pool, max_pages=2)
    pages = pool.alloc(2)
    cache.insert(np.arange(8, dtype=np.int32), pages)
    pool.share(pages[0])
    pool.free(pages)
    assert cache.evict(2) == 1 and pool.refcount(pages[0]) == 1


def test_submit_rejects_what_the_pool_can_never_hold():
    cfg, _ = _f32_configs()
    eng = port_engine.ServeEngine(
        build_model(cfg), params_from_numpy(numpy_params(cfg, 0), cfg, "cpu"),
        num_slots=2, max_seq=16, page_size=4, num_pages=3, device="cpu", paged_cache=True)
    with pytest.raises(port_engine.AdmissionError) as err:
        eng.submit(port_engine.Request(uid=7, prompt=np.ones(9, np.int32), max_new_tokens=2))
    assert err.value.reason == "exceeds_pool" and err.value.uid == 7
    assert not eng.waiting


@pytest.mark.parametrize("kw,err,match", [
    (dict(spec_tokens=2, paged_cache=True), ValueError, "draft_model and draft_params"),
    (dict(mesh=Mesh((torch.device("cpu"),), ("data",))), ValueError, "'model' axis"),
])
def test_settings_outside_the_slice_raise(kw, err, match):
    """Configuration errors: a mesh without a ``model`` axis (the reference's
    check; tensor-parallel serving itself is tests/test_torch_sharded_engine.py)
    and speculative decoding without a draft (the gating of
    tests/test_torch_spec_decode.py)."""
    cfg, _ = _f32_configs()
    with pytest.raises(err, match=match):
        port_engine.ServeEngine(build_model(cfg), {}, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(window=4, paged_cache=True), dict(prefill="interleaved", paged_cache=True),
    dict(paged_cache=False),
])
def test_ring_mode_settings_serve_a_trace(kw):
    """The settings ring mode brought into the port (they raised before it):
    each builds an engine that serves a short trace to its budgets (the
    tokens are held against the reference in tests/test_torch_ring.py)."""
    cfg, _ = _f32_configs()
    eng = port_engine.ServeEngine(
        build_model(cfg), params_from_numpy(numpy_params(cfg, 0), cfg, "cpu"),
        num_slots=2, max_seq=16, page_size=4, device="cpu", **kw)
    rng = np.random.default_rng(4)
    outs = eng.run([port_engine.Request(uid=u, prompt=rng.integers(1, 512, n),
                                        max_new_tokens=5) for u, n in enumerate((6, 9, 3))])
    assert [len(o.tokens) for o in outs] == [5, 5, 5]
    assert (eng.pool_stats is None) == (not kw.get("paged_cache"))


# ------------------------------------------------------------- golden
def golden_trace() -> dict:
    """The trace the card replays: the shared-prefix trace with a copy-on-
    write hit, so cold prefill, suffix prefill and decode all run."""
    return {
        "config": f"{ARCH} smoke, dtype float32",
        "seed": 0,
        "engine": dict(num_slots=3, max_seq=32, page_size=4, prefix_cache=True,
                       paged_cache=True),
        "max_new_tokens": 6,
        "prompts": [p.tolist() for p in _shared_prefix_prompts()],
    }


def make_golden() -> dict:
    """Run the reference engine on ``golden_trace()``; add its tokens."""
    g = golden_trace()
    _, ref_cfg = _f32_configs()
    cfg, _ = _f32_configs()
    ref_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                        numpy_params(cfg, g["seed"]))
    ref = ref_engine.ServeEngine(ref_build_model(ref_cfg), ref_params, **g["engine"])
    outs = ref.run([ref_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                       max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    g["tokens"] = [[int(t) for t in o.tokens] for o in outs]
    g["suffix_dispatches"] = ref.suffix_dispatches
    return g


def test_golden_file_matches_reference():
    assert json.loads(GOLDEN.read_text()) == make_golden()


def test_port_replays_golden_on_cpu():
    """What chip_smoke.py's golden phase does on the card, on the CPU."""
    g = json.loads(GOLDEN.read_text())
    cfg, _ = _f32_configs()
    eng = port_engine.ServeEngine(
        build_model(cfg), params_from_numpy(numpy_params(cfg, g["seed"]), cfg, "cpu"),
        device="cpu", **g["engine"])
    outs = eng.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    assert [o.tokens for o in outs] == g["tokens"]
    assert eng.suffix_dispatches == g["suffix_dispatches"] > 0


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    res = main(["--continuous", "--device", "cpu", "--requests", "3", "--gen", "3",
                "--prompt-len", "8", "--slots", "2"])
    assert res["device"] == "cpu" and len(res["generated"]) == 3
    assert all(len(t) == 3 for t in res["generated"])
    assert res["paged_cache"] and res["pool"] is not None  # the CLI's engine default
    assert "reqs × 3 tok over 2 slots" in capsys.readouterr().out
    res = main(["--device", "cpu", "--batch", "2", "--gen", "3", "--prompt-len", "8"])
    assert res["device"] == "cpu" and len(res["generated"]) == 2  # the single-batch default


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
