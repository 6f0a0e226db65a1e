"""The port's MoE family (``models/moe.py``, ``MOE_FFN``) against the
reference's ``models/moe.py``, in float32 on the same numpy-drawn weights.

``apply_moe`` at every group size (64, 128, 256 tokens and the whole
batch), with a case that drops choices past capacity, exact ties in the
router and the Switch aux loss; the training loss of the olmoe and
qwen3-moe smoke configs; an olmoe smoke engine trace with a padded bucket
token for token with the reference engine (the golden file the card
replays, ``src/repro_torch/testdata/golden_olmoe_smoke.json``; rewrite it
with ``PYTHONPATH=src:. python tests/test_torch_moe.py``), the same trace
on a 2-shard mesh, a speculative trace (the k-token verify), the mesh's
split rule, and the shapes ``apply_moe`` builds.

The reference is run under ``jax.jit``, as its engine and trainer run it:
eagerly its ``_topk_iterative`` weighs the second choice by
``sum(p * one_hot)`` over a ``p`` that holds -inf at the first choice, and
-inf * 0 is NaN; XLA's compiled form reads the chosen probability. The
port gathers it."""
import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import engine as ref_engine
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro_torch.bridge import numpy_from_params, numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import moe
from repro_torch.models.model import build_model

ARCH = "olmoe-1b-7b"
GOLDEN = (pathlib.Path(__file__).resolve().parents[1]
          / "src" / "repro_torch" / "testdata" / "golden_olmoe_smoke.json")
COUNTERS = ("prefill_tokens", "prefix_hit_pages", "cow_copies", "suffix_dispatches",
            "cold_dispatches", "preemptions")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch=ARCH, **kw):
    return (dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw),
            dataclasses.replace(ref_smoke_config(arch), dtype="float32", **kw))


def _layer(cfg, seed=0):
    """Layer 0's expert leaves as numpy."""
    return {k: v[0] for k, v in numpy_params(cfg, seed)["layers"]["ffn"].items()}


@functools.lru_cache(maxsize=None)
def _ref_apply(ref_cfg):
    return jax.jit(lambda p, x: ref_moe.apply_moe(p, x, ref_cfg))


def _apply_both(cfg, ref_cfg, leaves, x):
    want, want_aux = _ref_apply(ref_cfg)({k: jnp.asarray(v) for k, v in leaves.items()},
                                         jnp.asarray(x))
    got, aux = moe.apply_moe({k: torch.from_numpy(v) for k, v in leaves.items()},
                             torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    return got


@pytest.mark.parametrize("tokens,group", [(64, 64), (128, 128), (512, 256), (96, 96),
                                          (8, 8)])
def test_apply_moe_matches_reference_at_every_group_size(tokens, group):
    cfg, ref_cfg = _configs()
    assert moe._group_size(tokens) == ref_moe._group_size(tokens) == group
    x = np.random.default_rng(tokens).standard_normal((2, tokens // 2, cfg.d_model))
    _apply_both(cfg, ref_cfg, _layer(cfg), x.astype(np.float32))


def test_choices_past_capacity_are_dropped_as_the_reference_drops_them():
    """A router that sends most tokens to expert 0: choices past its
    capacity drop (asserted), and the outputs still agree."""
    cfg, ref_cfg = _configs()
    leaves = _layer(cfg, 1)
    leaves["router"] = leaves["router"].copy()
    leaves["router"][:, 0] += 0.5
    x = np.random.default_rng(5).standard_normal((1, 64, cfg.d_model)).astype(np.float32) + 1
    xt = torch.from_numpy(x).reshape(1, 64, -1)
    _, kept, _, _ = moe.route({"router": torch.from_numpy(leaves["router"])}, xt, cfg)
    c = moe.capacity(cfg, 64)
    assert kept.sum() < 64 * cfg.experts_per_token          # some choices dropped
    assert int(kept[0, :, 0].sum()) == c                     # expert 0 exactly full
    _apply_both(cfg, ref_cfg, leaves, x)


def test_router_ties_take_the_first_expert():
    """Experts 1 and 3 copy the router columns of 0 and 2: every token's
    probabilities tie in pairs, and both packages take the lower index."""
    cfg, ref_cfg = _configs()
    leaves = _layer(cfg, 2)
    r = leaves["router"].copy()
    r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
    leaves["router"] = r
    x = np.random.default_rng(6).standard_normal((1, 64, cfg.d_model)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x @ r), dim=-1)
    _, idx = moe._topk_iterative(probs, 2)
    assert set(idx[..., 0].unique().tolist()) <= {0, 2}
    assert set(idx[..., 1].unique().tolist()) <= {1, 3}
    _apply_both(cfg, ref_cfg, leaves, x)


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_apply_moe_builds_no_five_dim_slot_tensor():
    """The reference's (g, n, k, E, C) slot one-hot is never built: no
    tensor of five dims, and none larger than (g, n, E, C)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", n_experts=8,
                              experts_per_token=3)
    leaves = {k: torch.from_numpy(v) for k, v in _layer(cfg).items()}
    x = torch.randn(4, 128, cfg.d_model)                      # 2 groups of 256
    with _Shapes() as rec:
        moe.apply_moe(leaves, x, cfg)
    g, n, e, k, c = 2, 256, 8, 3, moe.capacity(cfg, 256)
    # (einsum's views add dims of size 1: those are not counted)
    dims = [tuple(d for d in s if d != 1) for s in rec.shapes]
    assert dims and all(len(s) <= 4 for s in dims), [s for s in dims if len(s) > 4]
    assert (g, n, e, c) in dims
    assert max(int(np.prod(s)) for s in rec.shapes) <= g * n * e * c < g * n * k * e * c


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_loss_matches_reference(arch):
    cfg, ref_cfg = _configs(arch)
    tree = numpy_params(cfg, 3)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, 512, (2, 64)).astype(np.int32) for k in ("tokens", "labels")}
    want, want_m = jax.jit(ref_build_model(ref_cfg).loss)(
        jax.tree_util.tree_map(jnp.asarray, tree), jax.tree_util.tree_map(jnp.asarray, batch))
    got, got_m = build_model(cfg).loss(params_from_numpy(tree, cfg, "cpu"),
                                       {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["aux_loss"]), float(want_m["aux_loss"]), rtol=1e-5)
    assert float(got_m["aux_loss"]) > 0


def test_bridge_matches_reference_tree():
    """numpy_params draws the reference's MoE leaf paths and shapes; the
    router stays float32 in a bf16 model; the round trip is exact."""
    cfg = get_smoke_config(ARCH)
    tree = numpy_params(cfg, 0)
    ref_tree = ref_build_model(ref_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    shapes = lambda t: {jax.tree_util.keystr(p): tuple(x.shape)  # noqa: E731
                        for p, x in jax.tree_util.tree_leaves_with_path(t)}
    assert shapes(tree) == shapes(ref_tree)
    params = params_from_numpy(tree, cfg, "cpu")
    assert params["layers"]["ffn"]["router"].dtype == torch.float32
    assert params["layers"]["ffn"]["w_gate"].dtype == torch.bfloat16
    port = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert shapes(port) == shapes(ref_tree)
    assert port["layers"]["ffn"]["router"].dtype == torch.float32
    f32 = params_from_numpy(tree, cfg, "cpu", torch.float32)
    back = numpy_from_params(f32)
    np.testing.assert_array_equal(back["layers"]["ffn"]["w_down"],
                                  tree["layers"]["ffn"]["w_down"])


# ------------------------------------------------------------------ golden
def golden_trace() -> dict:
    """The trace the card replays: 4 slots, so the first cold round (3
    prompts) runs in a width bucket of 4 with a padding row, and every
    round pads its prompts to a length bucket; the shared-prefix prompts
    add a suffix round and a copy-on-write hit."""
    rng = np.random.default_rng(3)
    common = rng.integers(1, 512, 12)
    cold = [rng.integers(1, 512, n) for n in (5, 9, 13)]
    shared = [np.concatenate([common, rng.integers(1, 512, k)]) for k in (0, 3, 6)]
    return {
        "config": f"{ARCH} smoke, dtype float32",
        "seed": 0,
        "engine": dict(num_slots=4, max_seq=32, page_size=4, prefix_cache=True,
                       paged_cache=True),
        "max_new_tokens": 6,
        "prompts": [p.tolist() for p in cold + shared + [common.copy()]],
    }


@functools.lru_cache(maxsize=None)
def _reference_golden() -> str:
    g = golden_trace()
    cfg, ref_cfg = _configs()
    ref_params = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, g["seed"]))
    eng = ref_engine.ServeEngine(ref_build_model(ref_cfg), ref_params, **g["engine"])
    outs = eng.run([ref_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                       max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    g["tokens"] = [[int(t) for t in o.tokens] for o in outs]
    g["counters"] = {key: int(eng.pool_stats[key]) for key in COUNTERS}
    return json.dumps(g)


def make_golden() -> dict:
    return json.loads(_reference_golden())


def test_golden_file_matches_reference():
    assert json.loads(GOLDEN.read_text()) == make_golden()


def _port_run(g, **kw):
    cfg, _ = _configs()
    eng = port_engine.ServeEngine(
        build_model(cfg), params_from_numpy(numpy_params(cfg, g["seed"]), cfg, "cpu"),
        device="cpu", **g["engine"], **kw)
    outs = eng.run([port_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                        max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    return [o.tokens for o in outs], {key: eng.pool_stats[key] for key in COUNTERS}


def test_port_engine_matches_reference():
    g = make_golden()
    assert port_engine.bucket_width(3, g["engine"]["num_slots"]) == 4   # a padding row
    tokens, counters = _port_run(g)
    assert tokens == g["tokens"]
    assert counters == g["counters"] and counters["suffix_dispatches"] > 0


def test_speculative_engine_matches_reference():
    """The k-token verify hands the MoE layer the reference's rows too: a
    foreign-seed draft over olmoe smoke, k = 3, the same tokens and
    rounds as the reference's speculative engine."""
    cfg, ref_cfg = _configs()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, 8) for _ in range(4)]
    kw = dict(num_slots=2, max_seq=24, paged_cache=True, page_size=4, spec_tokens=3)

    def ref_tree(seed):
        return jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, seed))

    ref = ref_engine.ServeEngine(ref_build_model(ref_cfg), ref_tree(0),
                                 draft_model=ref_build_model(ref_cfg), draft_params=ref_tree(5),
                                 **kw)
    want = ref.run([ref_engine.Request(uid=u, prompt=p, max_new_tokens=6)
                    for u, p in enumerate(prompts)])
    port = port_engine.ServeEngine(
        build_model(cfg), params_from_numpy(numpy_params(cfg, 0), cfg, "cpu"), device="cpu",
        draft_model=build_model(cfg), draft_params=params_from_numpy(numpy_params(cfg, 5), cfg,
                                                                     "cpu"), **kw)
    got = port.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=6)
                    for u, p in enumerate(prompts)])
    assert [o.tokens for o in got] == [o.tokens for o in want]
    assert port.spec_rounds == ref.spec_rounds > 0


def test_mesh_splits_only_the_attention_projections():
    """The reference's rule (``launch/mesh.py`` serve specs): only
    ``attn/(wq|wk|wv)`` split over the model axis; the router and every
    expert leaf replicate."""
    from repro_torch.launch.mesh import serve_param_specs
    from repro_torch.models.model import localize_config

    cfg = get_smoke_config(ARCH)
    specs = serve_param_specs(build_model(cfg).init(torch.Generator().manual_seed(0), "cpu"))
    assert specs["layers"]["attn"] == {"wq": -1, "wk": -1, "wv": -1, "wo": None}
    assert set(specs["layers"]["ffn"]) == {"router", "w_gate", "w_up", "w_down"}
    assert all(v is None for v in specs["layers"]["ffn"].values())
    local = localize_config(cfg, 2)
    assert (local.n_experts, local.experts_per_token, local.d_ff) == (4, 2, cfg.d_ff)


def test_two_shard_trace_equals_unsharded():
    """Attention heads split over 2 shards, the router and experts
    replicated: the same tokens and counters as the unsharded engine."""
    g = json.loads(GOLDEN.read_text())
    assert _port_run(g, mesh=make_serve_mesh(2, devices=["cpu"] * 2)) == _port_run(g)


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
