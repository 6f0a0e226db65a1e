"""Tensor-parallel serving of the port (``ServeEngine(mesh=...)``), the
cases of the reference's ``tests/test_sharded_engine.py``.

Contract: sharding is invisible in the output. The unsharded port engine is
the oracle; an engine on a ``model``-axis mesh (attention heads and the KV
pool's kv-head slices split over the shards, page tables host-side and
shard-invariant) must emit IDENTICAL token streams on every trace: greedy
and sampled, cold and prefix-hit suffix rounds, preemption and resume, int8
pages and per-slot rings. The shards run in-process, every one on the CPU
(a mesh names the device once per shard), at the bf16 smoke config; on the
CPU every kernel call takes its plain version.

Also here: the per-leaf split dims of ``launch/mesh.serve_param_specs`` and
``serve_cache_specs`` against the reference's specs of the same leaf names,
the sharded trees (split leaves joined back bitwise equal to the full
tensors, replicated leaves held once, not copied), ``localize_config`` against the
reference's, and the refusals of the engine and the CLI."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import mesh as ref_mesh
from repro.models import build_model as ref_build_model
from repro.models.model import localize_config as ref_localize_config
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.engine import (
    Request, ServeEngine, bucket_length, bucket_width, make_requests, serving_params,
)
from repro_torch.launch.mesh import (
    Mesh, make_serve_mesh, serve_cache_specs, serve_param_specs, shard_cache, shard_params,
)
from repro_torch.launch.sampling import SamplingParams
from repro_torch.models.model import build_model, localize_config

ARCH = "stablelm-1.6b"
P, G = 8, 6
TESTDATA = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "testdata"


def _golden_runs() -> dict:
    """The reference engine's fp32 golden serving runs: the paged trace and
    the ring file's engine runs, by name."""
    g = json.loads((TESTDATA / "golden_stablelm_smoke.json").read_text())
    ring = json.loads((TESTDATA / "golden_stablelm_smoke_ring.json").read_text())
    runs = {"paged": (g, g["engine"], g["tokens"])}
    runs.update({r["name"]: (ring, r["engine"], r["tokens"]) for r in ring["runs"]})
    return runs


GOLDEN_RUNS = _golden_runs()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_and_params():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def cpu_mesh(shards: int) -> Mesh:
    return make_serve_mesh(shards, devices=["cpu"] * shards)


def _build(model_and_params, shards=None, **kw):
    _, model, params = model_and_params
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_seq", P + G)
    kw.setdefault("paged_cache", True)
    kw.setdefault("page_size", 4)
    return ServeEngine(model, params, device="cpu",
                       mesh=None if shards is None else cpu_mesh(shards), **kw)


def _reqs(cfg, lens, *, gen=G, uid0=0, seed=0, sampling=None):
    base = make_requests(cfg, n_requests=len(lens), prompt_len=max(lens), gen_tokens=gen,
                         seed=seed)
    return [Request(uid=uid0 + j, prompt=r.prompt[: lens[j]], max_new_tokens=gen,
                    sampling=sampling)
            for j, r in enumerate(base)]


def _same(a, b):
    ref = {o.uid: o.tokens for o in b}
    assert len(a) == len(b)
    for o in a:
        assert o.tokens == ref[o.uid], (o.uid, o.tokens, ref[o.uid])


# ------------------------------------------------------------ fixed probes
def test_mesh1_identity_and_stats(model_and_params):
    """A 1-shard mesh runs the per-shard plumbing: same tokens as
    mesh=None, shard-aware pool_stats."""
    cfg, _, _ = model_and_params
    lens = [3, P, 5, 7]
    base = _build(model_and_params).run(_reqs(cfg, lens))
    eng = _build(model_and_params, 1)
    _same(eng.run(_reqs(cfg, lens)), base)
    ps = eng.pool_stats
    assert ps["shards"] == 1 and ps["mesh_axes"] == {"model": 1}
    assert len(ps["occupancy"]) == 1


def test_unsharded_pool_stats_fields(model_and_params):
    """mesh=None reports the degenerate shard fields."""
    ps = _build(model_and_params).pool_stats
    assert ps["shards"] == 1 and ps["mesh_axes"] is None
    assert ps["occupancy"] == [0.0]


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_greedy_identity(model_and_params, shards):
    """2- and 4-shard engines emit the unsharded engine's streams (mixed
    lengths, slot reuse)."""
    cfg, _, _ = model_and_params
    lens = [3, P, 5, 7, 2, 6]
    base = _build(model_and_params).run(_reqs(cfg, lens))
    eng = _build(model_and_params, shards)
    _same(eng.run(_reqs(cfg, lens)), base)
    assert eng.pool_stats["shards"] == shards
    assert len(set(eng.pool_stats["occupancy"])) == 1  # shard-invariant


def test_sharded_sampled_identity(model_and_params):
    """Sampled streams: the same logits and the same per-request streams
    give the same draws."""
    cfg, _, _ = model_and_params
    sp = SamplingParams(temperature=0.9, top_k=37, top_p=0.95, seed=11)
    lens = [4, P, 6, 3]
    base = _build(model_and_params).run(_reqs(cfg, lens, sampling=sp))
    _same(_build(model_and_params, 2).run(_reqs(cfg, lens, sampling=sp)), base)


def test_sharded_kernel_paths(model_and_params):
    """The decode and suffix-prefill paths per shard on the local kv-head
    slice (plain versions here): a second round over published pages takes
    the suffix dispatch, with the same tokens."""
    cfg, _, _ = model_and_params
    kw = dict(prefix_cache=True, num_slots=3)
    lens = [P, 6, P, 4]
    base = _build(model_and_params, **kw)
    ref = base.run(_reqs(cfg, lens))
    ref2 = base.run(_reqs(cfg, lens, uid0=10))
    sharded = _build(model_and_params, 2, **kw)
    _same(sharded.run(_reqs(cfg, lens)), ref)
    _same(sharded.run(_reqs(cfg, lens, uid0=10)), ref2)
    assert sharded.suffix_dispatches == base.suffix_dispatches > 0


def test_sharded_preemption_resume(model_and_params):
    """A tight pool under sharding preempts and resumes exactly as the
    unsharded one, and the streams match the roomy engine's."""
    cfg, _, _ = model_and_params
    tight = dict(num_slots=3, num_pages=10, watermark_pages=1)
    lens = [P, P, P]
    roomy = _build(model_and_params).run(_reqs(cfg, lens, gen=G + 2))
    base = _build(model_and_params, **tight)
    base_out = base.run(_reqs(cfg, lens, gen=G + 2))
    assert base.preemptions > 0
    sharded = _build(model_and_params, 2, **tight)
    out = sharded.run(_reqs(cfg, lens, gen=G + 2))
    assert sharded.preemptions == base.preemptions
    _same(out, base_out)
    _same(out, roomy)


def test_sharded_prefix_hit_rounds(model_and_params):
    """Prefix-cache admission under sharding: shared pages, suffix rounds
    and copy-on-write splits on the shard-invariant page table."""
    kw = dict(prefix_cache=True, num_slots=3, num_pages=40)
    pre = np.arange(1, 13, dtype=np.int32)

    def trace(uid0=0):
        return [Request(uid=uid0 + u, max_new_tokens=G,
                        prompt=np.concatenate([pre, np.full(3 + u, 50 + u, np.int32)]))
                for u in range(4)]

    base = _build(model_and_params, **kw)
    ref = [base.run(trace()), base.run(trace(10))]
    sharded = _build(model_and_params, 2, **kw)
    got = [sharded.run(trace()), sharded.run(trace(10))]
    for g, r in zip(got, ref):
        _same(g, r)
    assert sharded.suffix_dispatches == base.suffix_dispatches > 0
    assert sharded.cow_copies == base.cow_copies
    assert sharded.pool_stats["prefix_hit_rate"] == base.pool_stats["prefix_hit_rate"] > 0


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_int8_pages_identity(model_and_params, shards):
    """int8 pages: each shard quantizes its kv-head slice (one scale per
    token slot per kv head, the ``ks``/``vs`` planes split on their last
    dim), so the pool and the tokens are the unsharded engine's, over cold
    and suffix rounds."""
    cfg, _, _ = model_and_params
    kw = dict(kv_dtype="int8", prefix_cache=True, num_pages=40)
    lens = [P, 6, P, 4, 7]
    base = _build(model_and_params, **kw)
    ref = [base.run(_reqs(cfg, lens)), base.run(_reqs(cfg, lens, uid0=10))]
    eng = _build(model_and_params, shards, **kw)
    got = [eng.run(_reqs(cfg, lens)), eng.run(_reqs(cfg, lens, uid0=10))]
    for g, r in zip(got, ref):
        _same(g, r)
    assert eng.suffix_dispatches == base.suffix_dispatches > 0
    for name in ("k", "v", "ks", "vs"):
        dim = -2 if name in ("k", "v") else -1
        joined = torch.cat([c[name] for c in eng.cache.shards], dim=dim)
        assert torch.equal(joined, base.cache[name]), name


@pytest.mark.parametrize("kw", [dict(), dict(window=4, prefill="interleaved")],
                         ids=["rings", "windowed-interleaved"])
def test_sharded_rings_identity(model_and_params, kw):
    """Per-slot rings (the reference's ring layout splits dim -2 too):
    chunked, and interleaved with a window the prompts wrap."""
    cfg, _, _ = model_and_params
    lens = [3, P, 5, 7, 2]
    base = _build(model_and_params, paged_cache=False, **kw).run(_reqs(cfg, lens))
    for shards in (2, 4):
        eng = _build(model_and_params, shards, paged_cache=False, **kw)
        _same(eng.run(_reqs(cfg, lens)), base)


@pytest.mark.parametrize("name", sorted(GOLDEN_RUNS))
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_replays_the_reference_golden_tokens(shards, name):
    """The reference engine's fp32 golden traces served on 2 and 4 CPU
    shards give the reference's tokens exactly (what ``chip_smoke.py``'s
    phase 4g checks on the card), with the paged trace's suffix rounds."""
    src, kw, want = GOLDEN_RUNS[name]
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    params = params_from_numpy(numpy_params(cfg, src["seed"]), cfg, "cpu")
    eng = ServeEngine(build_model(cfg), params, device="cpu", mesh=cpu_mesh(shards), **kw)
    outs = eng.run([Request(uid=u, prompt=np.asarray(p, np.int32),
                            max_new_tokens=src["max_new_tokens"])
                    for u, p in enumerate(src["prompts"])])
    assert [o.tokens for o in outs] == want
    if name == "paged":
        assert eng.suffix_dispatches == src["suffix_dispatches"] > 0


# ------------------------------------------------------------ property pin
@given(lens=st.lists(st.integers(2, P), min_size=1, max_size=5),
       temperature=st.sampled_from([0.0, 0.8]))
@settings(max_examples=8, deadline=None)
def test_property_sharded_identity(model_and_params, lens, temperature):
    """Any trace the pool holds, greedy or sampled: the 2-shard engine is
    the unsharded engine."""
    cfg, _, _ = model_and_params
    sp = None if temperature == 0.0 else SamplingParams(temperature=temperature, top_k=20,
                                                        seed=3)
    base = _build(model_and_params).run(_reqs(cfg, lens, gen=3, sampling=sp))
    _same(_build(model_and_params, 2).run(_reqs(cfg, lens, gen=3, sampling=sp)), base)


# ---------------------------------------------------- compile-count gates
def test_sharded_compile_gate(model_and_params):
    """The sharded engine stays within the unsharded bucket-ladder bound:
    a mesh adds shards, not shapes."""
    cfg, _, _ = model_and_params
    engine = _build(model_and_params, 2, num_slots=4, page_size=8)
    lens = [3, 5, 7, 9, 11, 13]
    shapes = [(w, length) for w in (1, 2, 3, 4) for length in lens][:21]
    assert len(shapes) >= 20
    uid = 0
    for w, length in shapes:
        engine.run(_reqs(cfg, [length] * w, uid0=uid))
        uid += w
    n_buckets = len({(bucket_width(w, 4), bucket_length(length)) for w, length in shapes})
    compiled = engine.compiles["prefill_slots"]
    assert compiled <= n_buckets, (compiled, n_buckets)
    assert engine.compiles["decode"] == 1
    before = engine.compiles["prefill_slots"]
    engine.run(_reqs(cfg, [4, 6, 12], uid0=uid))
    assert engine.compiles["prefill_slots"] == before


def test_warm_dedupe_persists_across_calls(model_and_params):
    """``warm`` keys traced shapes by bucket shape and keeps them: a second
    warm over covered lengths adds no compile and no run."""
    eng = _build(model_and_params, 2, num_slots=4)
    eng.warm([5, 9])
    first = dict(eng.compiles)
    assert first["prefill_slots"] > 0
    steps = eng.steps
    eng.warm([5, 9, 6])  # 6 buckets with 9
    assert dict(eng.compiles) == first
    assert eng.steps == steps


# ----------------------------------------------------------- construction
def test_mesh_validation(model_and_params):
    _, model, params = model_and_params
    bad = Mesh((torch.device("cpu"),), ("data",))
    with pytest.raises(ValueError, match="model"):
        ServeEngine(model, params, mesh=bad, paged_cache=True, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        localize_config(model.cfg, 3)  # 4 heads over 3 shards
    with pytest.raises(ValueError, match="device"):
        make_serve_mesh(3, devices=["cpu"] * 2)
    # the default device list is the visible CUDA devices: none here
    with pytest.raises(ValueError, match="device"):
        make_serve_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="host"):
        ServeEngine(model, params, mesh=cpu_mesh(2), paged_cache=True, host_pages=8,
                    device="cpu")
    with pytest.raises(ValueError, match="mesh serving"):
        ServeEngine(model, params, mesh=cpu_mesh(2), paged_cache=True, device="cpu",
                    draft_model=model, draft_params=params, spec_tokens=2)


def test_export_under_a_mesh_carries_no_pages(model_and_params):
    """A mesh's in-flight requests leave without page content (the
    importer re-prefills them), as the reference's do."""
    cfg, _, _ = model_and_params
    eng = _build(model_and_params, 2)
    for r in _reqs(cfg, [P, 5, 7]):
        eng.submit(r)
    eng.step()
    eng.step()
    items = eng.export_inflight()
    assert any(res is not None and res.generated for _, res in items)
    assert all(res is None or res.host_arrays is None for _, res in items)
    assert eng.pool.in_use == 0


# ------------------------------------------------------- specs and shards
def _ref_paged_cache(kv_dtype):
    model = ref_build_model(ref_smoke_config(ARCH))
    return model.init_paged_cache(None, 3, 9, 4, 6, kv_dtype=kv_dtype)


def _spec_dim(spec, ndim):
    """The (negative) dim a reference PartitionSpec puts on ``model``."""
    axes = list(spec) + [None] * (ndim - len(spec))
    return next((i - ndim for i, a in enumerate(axes) if a == "model"), None)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _check_shards(full, sharded, specs, n):
    """Split leaves sit only in the shards' trees, and joined back equal the
    full tensor bitwise; replicated leaves sit once in the replicated tree,
    as the full tensor itself (one device), and in no shard's tree."""
    specs = dict(_leaves(specs))
    rep = dict(_leaves(sharded.full))
    per_shard = [dict(_leaves(s)) for s in sharded.shards]
    assert len(per_shard) == n
    for path, x in _leaves(full):
        d = specs[path]
        if d is None:
            assert rep[path] is x and all(path not in s for s in per_shard), path
        else:
            assert path not in rep, path
            assert all(s[path].shape[d] == x.shape[d] // n and s[path].is_contiguous()
                       for s in per_shard), path
            assert torch.equal(torch.cat([s[path] for s in per_shard], dim=d), x), path
    assert set(rep) | {p for s in per_shard for p in s} == set(specs)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_param_specs_and_shards_match_reference(model_and_params, shards):
    cfg, _, params = model_and_params
    sp = serving_params(cfg, params)
    ref_specs = dict(_leaves(ref_mesh.serve_param_specs(numpy_params(cfg, 0))))
    port_specs = serve_param_specs(sp)
    leaves = dict(_leaves(sp))
    assert set(leaves) == set(ref_specs)
    for path, d in _leaves(port_specs):
        assert d == _spec_dim(ref_specs[path], leaves[path].ndim), path
    assert {p for p, d in _leaves(port_specs) if d is not None} == {
        "layers/attn/wq", "layers/attn/wk", "layers/attn/wv"}
    _check_shards(sp, shard_params(sp, cpu_mesh(shards)), port_specs, shards)


@pytest.mark.parametrize("layout", ["fp", "int8", "rings"])
def test_cache_specs_and_shards_match_reference(model_and_params, layout):
    _, model, _ = model_and_params
    if layout == "rings":
        cache = model.init_slot_cache(3, 12, device="cpu")
        ref_cache = ref_build_model(ref_smoke_config(ARCH)).init_slot_cache(None, 3, 12)
    else:
        cache = model.init_paged_cache(3, 9, 4, 6, device="cpu", kv_dtype=layout)
        ref_cache = _ref_paged_cache(layout)
    for x in cache.values():   # distinct values, to see where each slice lands
        x.copy_(torch.arange(x.numel()).reshape(x.shape).to(x.dtype))
    ref_specs = ref_mesh.serve_cache_specs(ref_cache)
    specs = serve_cache_specs(cache)
    assert set(specs) <= set(ref_specs)
    for name, d in specs.items():
        assert d == _spec_dim(ref_specs[name], cache[name].ndim), name
    assert {n for n, d in specs.items() if d is not None} == (
        {"k", "v", "ks", "vs"} if layout == "int8" else {"k", "v"})
    for n in (1, 2, 4):
        _check_shards(cache, shard_cache(cache, cpu_mesh(n)), specs, n)


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16, 32])
def test_localize_config_matches_reference(shards):
    for port_cfg, ref_cfg in ((get_smoke_config(ARCH), ref_smoke_config(ARCH)),
                              (get_config(ARCH), ref_config(ARCH))):
        try:
            want = ref_localize_config(ref_cfg, shards)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                localize_config(port_cfg, shards)
            assert str(got.value) == str(e)
            continue
        got = localize_config(port_cfg, shards)
        assert (got.n_heads, got.n_kv_heads, got.head_dim, got.resolved_head_dim, got.d_model) \
            == (want.n_heads, want.n_kv_heads, want.head_dim, want.resolved_head_dim,
                want.d_model)


# -------------------------------------------------------------- the CLI
@pytest.mark.parametrize("argv", [
    ["--mesh", "2", "--num-devices", "2"],
    ["--continuous", "--replicas", "2", "--mesh", "2", "--num-devices", "2"],
    ["--continuous", "--host-pages", "8", "--mesh", "2", "--num-devices", "2"],
    ["--continuous", "--draft", ARCH, "--spec-tokens", "2", "--mesh", "2", "--num-devices", "2"],
    ["--continuous", "--mesh", "2"],   # no --num-devices: one visible CPU device
], ids=["no-continuous", "replicas", "host-pages", "draft", "too-few-devices"])
def test_cli_refuses_mesh_combinations(argv):
    with pytest.raises(SystemExit):
        serve_cli.main(argv + ["--device", "cpu"])


def test_cli_serves_a_mesh_with_the_unsharded_tokens():
    """``--mesh 2 --num-devices 2``: both shards on the CPU, the tokens of
    the unsharded run."""
    common = ["--continuous", "--device", "cpu", "--requests", "3", "--prompt-len", "8",
              "--gen", "4", "--slots", "2"]
    one = serve_cli.main(common)
    two = serve_cli.main(common + ["--mesh", "2", "--num-devices", "2"])
    assert one["generated"] == two["generated"]
    assert two["shards"] == 2 and two["mesh_axes"] == {"model": 2} and one["shards"] == 1
    assert two["compiles"] == one["compiles"]
