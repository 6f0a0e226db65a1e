"""The per-request prefill path of the port against the reference: the
transformer's whole-prompt ``prefill``, ``prefill_into_slot`` and the
engine with ``batch_prefill=False``.

Both packages run the smoke configs in float32 on the same numpy-drawn
weights (``repro_torch.bridge.numpy_params``); the reference's MoE runs
under ``jax.jit``, as its engine runs it.

* ``model.prefill`` (dense and MoE), with and without ``window`` and with a
  ``cache_window`` smaller than the prompt (the ring keeps the last tokens):
  logits and every cache plane within 1e-5 of their scale.
* ``model.prefill_slot`` into row 1 of a per-slot ring cache whose other
  rows are live (random k/v, positions): that row's k/v and the logits
  within 1e-5, every other row and position bitwise unchanged, short of
  the ring and at S > C (the wrap).
* The port's batched ``prefill_slots`` against ``prefill_slot`` looped over
  the same prompts: the same greedy tokens and caches within 1e-5. They
  are not bitwise: a row's attention and projections run at another batch
  shape (the reference's own pair is not bitwise either, ROADMAP Queue 3).
* Engines with ``batch_prefill=False``: on rings and on the pool the
  batched engine's tokens (the reference's ``test_engine.py:278`` and
  ``test_paged_engine.py:135``), one prefill dispatch per request, and the
  tensor-parallel engine's tokens at 2 shards.
* The golden file the card replays
  (``src/repro_torch/testdata/golden_stablelm_smoke_per_request.json``;
  rewrite it with ``PYTHONPATH=src:. python tests/test_torch_prefill_slot.py``):
  the reference engine's per-request traces on rings with a window the
  prompts wrap, on the pool with prefix hits (width-1 suffix dispatches)
  and on int8 pages with a pool that preempts; the port replays each
  token for token with the reference's dispatch counters and compiles.
  The reference's traces are made in a process of their own, beside the
  other tests (``ref_golden``)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

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
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.model import build_model

TOL = 1e-5
GOLDEN = (pathlib.Path(__file__).resolve().parents[1]
          / "src" / "repro_torch" / "testdata" / "golden_stablelm_smoke_per_request.json")
COUNTERS = ("prefill_dispatches", "cold_dispatches", "suffix_dispatches", "prefill_tokens",
            "preemptions", "cow_copies", "steps")
REF_COMPILES = ("decode", "prefill", "prefill_slots", "prefill_suffix")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def ref_golden():
    """The reference engine's golden traces (``make_golden``), computed in a
    process of its own from the module's first test on (its jit compiles
    run beside the other tests) and read when a test needs them."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", str(root)),
           "PYTHONPATH": os.pathsep.join([str(root / "src"), str(root / "tests")])}
    proc = subprocess.Popen(
        [sys.executable, "-c", "import json, sys, test_torch_prefill_slot as t; "
                               "json.dump(t.make_golden(), sys.stdout)"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    cache = {}

    def get():
        if not cache:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err
            cache.update(json.loads(out))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def both():
    """Per arch: (port model, port params, reference model, reference
    params) on the same float32 weights."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
            ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
            tree = numpy_params(cfg, 0)
            cache[arch] = (build_model(cfg), params_from_numpy(tree, cfg, "cpu"),
                           ref_build_model(ref_cfg),
                           jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree))
        return cache[arch]

    return get


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ("stablelm-1.6b", "olmoe-1b-7b"))
def test_prefill_matches_reference(both, arch):
    model, params, ref_model, ref_params = both(arch)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 10)).astype(np.int32)
    ref_prefill = jax.jit(ref_model.prefill, static_argnames=("window", "cache_window"))
    for window, cache_window in ((0, 0), (4, 6)):
        cache, logits = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                      window=window, cache_window=cache_window)
        ref_cache, ref_logits = ref_prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                                            window=window, cache_window=cache_window)
        _close(logits, ref_logits)
        for name in ("k", "v"):
            assert cache[name].shape == ref_cache[name].shape
            _close(cache[name], ref_cache[name])
        assert int(cache["pos"]) == int(ref_cache["pos"]) == 10


def _live_ring_cache(model, ref_model, ref_params, slots=3, max_seq=8, seed=4):
    """A per-slot ring cache of ``max_seq`` slots whose rows hold random k/v
    and positions, in both packages."""
    cache = model.init_slot_cache(slots, max_seq, device="cpu")
    rng = np.random.default_rng(seed)
    ref_cache = ref_model.init_slot_cache(ref_params, slots, max_seq)
    for name in ("k", "v"):
        x = rng.standard_normal(cache[name].shape).astype(np.float32)
        cache[name].copy_(torch.from_numpy(x))
        ref_cache[name] = jnp.asarray(x)
    pos = np.array([5, 0, 11], np.int32)[:slots]
    cache["pos"].copy_(torch.from_numpy(pos))
    ref_cache["pos"] = jnp.asarray(pos)
    return cache, ref_cache


@pytest.mark.parametrize("arch", ("stablelm-1.6b", "olmoe-1b-7b"))
@pytest.mark.parametrize("s", (5, 11))
def test_prefill_slot_matches_reference_and_leaves_other_slots(both, arch, s):
    model, params, ref_model, ref_params = both(arch)
    cache, ref_cache = _live_ring_cache(model, ref_model, ref_params)
    before = {k: v.clone() for k, v in cache.items()}
    tokens = np.random.default_rng(s).integers(0, 512, (1, s)).astype(np.int32)
    cache, logits = model.prefill_slot(params, cache, torch.from_numpy(tokens), 1)
    ref_cache, ref_logits = jax.jit(ref_model.prefill_slot)(ref_params, ref_cache,
                                                            jnp.asarray(tokens), 1)
    _close(logits, ref_logits)
    for name in ("k", "v"):
        _close(cache[name][:, 1], np.asarray(ref_cache[name])[:, 1])
        for row in (0, 2):
            assert torch.equal(cache[name][:, row], before[name][:, row])
    assert cache["pos"].tolist() == np.asarray(ref_cache["pos"]).tolist() == [5, s, 11]


def test_batched_prefill_slots_against_looped_prefill_slot(both):
    """Three prompts (2, 7 and 12 tokens: the last wraps the 8-slot rings)
    in one cold ``prefill_slots`` dispatch and one ``prefill_slot`` each:
    the same greedy tokens; caches and logits within 1e-5, not bitwise."""
    model, params, *_ = both("stablelm-1.6b")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (2, 7, 12)]
    batched = model.init_slot_cache(3, 8, device="cpu")
    tokens = np.zeros((3, 12), np.int32)
    for r, p in enumerate(prompts):
        tokens[r, : p.size] = p
    batched, lb = model.prefill_slots(params, batched, torch.from_numpy(tokens),
                                      torch.tensor([p.size for p in prompts]),
                                      torch.arange(3))
    looped = model.init_slot_cache(3, 8, device="cpu")
    rows = []
    for r, p in enumerate(prompts):
        looped, lg = model.prefill_slot(params, looped, torch.from_numpy(p[None]), r)
        rows.append(lg[0])
    ll = torch.stack(rows)
    assert lb.argmax(-1).tolist() == ll.argmax(-1).tolist()
    _close(lb, ll.numpy())
    for name in ("k", "v"):
        _close(batched[name], looped[name].numpy())
    assert batched["pos"].tolist() == looped["pos"].tolist() == [2, 7, 12]
    assert not torch.equal(lb, ll)


def test_prefill_slot_refuses_a_paged_or_lockstep_cache_and_two_rows(both):
    model, params, *_ = both("stablelm-1.6b")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="per-slot ring"):
        model.prefill_slot(params, model.init_paged_cache(2, 5, 4, 2, device="cpu"), tok, 0)
    with pytest.raises(ValueError, match="per-slot ring"):
        model.prefill_slot(params, model.init_cache(params, {"tokens": tok}, 8), tok, 0)
    with pytest.raises(ValueError, match="one request"):
        model.prefill_slot(params, model.init_slot_cache(2, 8, device="cpu"),
                           torch.zeros((2, 4), dtype=torch.int32), 0)


# --------------------------------------------------------------- engine
def _requests(lens, gen=5, seed=2):
    rng = np.random.default_rng(seed)
    return [port_engine.Request(uid=u, prompt=rng.integers(1, 512, n).astype(np.int32),
                                max_new_tokens=gen) for u, n in enumerate(lens)]


@pytest.mark.parametrize("layout", ("rings", "pool"))
def test_per_request_engine_gives_the_batched_engines_tokens(both, layout):
    model, params, *_ = both("stablelm-1.6b")
    lens = (3, 9, 6, 12, 4)
    kw = (dict(max_seq=20, window=8) if layout == "rings"
          else dict(max_seq=24, paged_cache=True, page_size=4, prefix_cache=True))
    outs = {}
    for batched in (True, False):
        eng = port_engine.ServeEngine(model, params, num_slots=3, device="cpu",
                                      batch_prefill=batched, **kw)
        outs[batched] = [o.tokens for o in eng.run(_requests(lens))]
        if not batched:
            assert eng.prefill_dispatches == len(lens) and not eng.bucket_prefill
            assert eng.compiles["prefill"] == (len(set(lens)) if layout == "rings" else 0)
    assert outs[True] == outs[False]


def test_per_request_rings_tensor_parallel_equal_unsharded(both):
    model, params, *_ = both("stablelm-1.6b")
    toks = []
    for shards in (0, 2):
        mesh = make_serve_mesh(shards, devices=["cpu"] * shards, kind="cpu") if shards else None
        eng = port_engine.ServeEngine(model, params, num_slots=2, max_seq=16, window=6,
                                      device="cpu", batch_prefill=False, mesh=mesh)
        toks.append([o.tokens for o in eng.run(_requests((3, 8, 5), gen=4))])
    assert toks[0] == toks[1]


def test_serve_cli_no_batch_prefill(capsys):
    from repro_torch.launch.serve import main

    res = main(["--continuous", "--device", "cpu", "--requests", "3", "--gen", "3",
                "--prompt-len", "8", "--slots", "2", "--no-batch-prefill",
                "--no-paged-cache", "--window", "6"])
    assert res["batch_prefill"] is False and res["prefill_dispatches"] == 3
    assert res["compiles"]["prefill"] == 1 and all(len(t) == 3 for t in res["generated"])
    assert "3 prefill dispatches" in capsys.readouterr().out


# --------------------------------------------------------------- golden
def golden_trace() -> dict:
    """Two prompt lengths, 9 and 12 (the shared prompts: a 9-token prefix
    and 3 more), so the reference engines compile few prefill shapes."""
    rng = np.random.default_rng(5)
    common = rng.integers(1, 512, 9)
    shared = [np.concatenate([common, rng.integers(1, 512, 3)]) for _ in range(2)]
    cold = [rng.integers(1, 512, n) for n in (9, 12, 9, 12)]
    return {
        "config": "stablelm-1.6b smoke, float32", "seed": 0, "max_new_tokens": 6,
        "runs": [
            {"name": "rings, window 8 (prompts of 9 and 12 tokens wrap)",
             "prompts": [p.tolist() for p in cold],
             "engine": dict(num_slots=3, max_seq=24, window=8, batch_prefill=False)},
            {"name": "pool with prefix hits",
             "prompts": [p.tolist() for p in cold[:2] + [common] + shared],
             "engine": dict(num_slots=2, max_seq=32, page_size=4, paged_cache=True,
                            prefix_cache=True, batch_prefill=False)},
            {"name": "int8 pages, a pool that preempts",
             "prompts": [p.tolist() for p in cold[:2] + [common] + shared],
             "engine": dict(num_slots=3, max_seq=32, page_size=4, paged_cache=True,
                            prefix_cache=True, kv_dtype="int8", num_pages=9,
                            batch_prefill=False)},
        ],
    }


def _counters(eng) -> dict:
    return {k: int(getattr(eng, k)) for k in COUNTERS}


def make_golden() -> dict:
    """Run the reference engine on ``golden_trace()``; add its tokens,
    counters and compiles."""
    g = golden_trace()
    cfg = dataclasses.replace(ref_smoke_config("stablelm-1.6b"), dtype="float32")
    ref_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                        numpy_params(cfg, g["seed"]))
    for run in g["runs"]:
        eng = ref_engine.ServeEngine(ref_build_model(cfg), ref_params, **run["engine"])
        outs = eng.run([ref_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                           max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(run["prompts"])])
        run["tokens"] = [[int(t) for t in o.tokens] for o in outs]
        run["counters"] = _counters(eng)
        run["compiles"] = {k: eng.compiles[k] for k in REF_COMPILES}
    return g


def test_golden_file_matches_reference(ref_golden):
    g = json.loads(GOLDEN.read_text())
    assert g == ref_golden()
    runs = {r["name"]: r for r in g["runs"]}
    assert runs["pool with prefix hits"]["counters"]["suffix_dispatches"] > 0
    assert runs["int8 pages, a pool that preempts"]["counters"]["preemptions"] > 0
    assert runs["rings, window 8 (prompts of 9 and 12 tokens wrap)"]["compiles"]["prefill"] > 0


def test_port_replays_golden_on_cpu():
    """What chip_smoke.py's phase 4k does on the card, on the CPU."""
    g = json.loads(GOLDEN.read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, "cpu")
    for run in g["runs"]:
        eng = port_engine.ServeEngine(model, params, device="cpu", **run["engine"])
        outs = eng.run([port_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                            max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(run["prompts"])])
        assert [o.tokens for o in outs] == run["tokens"], run["name"]
        assert _counters(eng) == run["counters"], run["name"]
        assert {k: eng.compiles[k] for k in REF_COMPILES} == run["compiles"], run["name"]


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
