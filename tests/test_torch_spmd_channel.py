"""The pod-axis training channel of the port against the reference: the SPMD
codecs (``topk_threshold_sparsify``, ``int8_roundtrip_rowwise``,
``Compressor(spmd=True)``), the int8 wire (``int8_wire_weighted_average``)
and the pod-mode trainer's plumbing. The pod-mode trainer's golden training
case (the reference's ``steps.make_federated_step`` on a 2-device pod mesh)
is replayed in ``tests/test_torch_train_golden.py``.

Tolerances:

* ``topk_threshold_sparsify``: bitwise, eager and jitted (compares, float32
  midpoints and exact counts below 2**24 elements on both sides);
* ``int8_roundtrip_rowwise`` and ``Compressor(spmd=True).roundtrip``:
  bitwise against the eager reference; against the jitted one (XLA turns
  the division by 127 into a reciprocal multiply, the port divides
  IEEE-exact) the scales within one ulp and the outputs within one quantum
  (one scale) per element;
* ``int8_wire_weighted_average``: against the reference's shard_map wire
  (run in a subprocess on 2 forced host devices, a pod-only mesh with
  replicated intra-pod specs: the ``tests/test_int8_wire.py`` idiom) within
  one quantum per element, Σ_c w_c·scale_c of the row, on the quantized
  leaves, and one float32 ulp of Σ_c |w_c·x_c| on the dense ones (XLA's CPU
  compiler contracts the weighted sum into an FMA); against the dense
  ``weighted_average`` within the reference's own gate, max error over the
  leaf's max magnitude < 0.03."""
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as ref_comp
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import compression as comp
from repro_torch.core.federated import FederatedTrainer
from repro_torch.launch.mesh import make_sim_mesh
from repro_torch.models.model import build_model
from repro_torch.configs import get_smoke_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [(37, 129), (300,), (4, 16, 33), (1, 2048), (2, 5)]
RATIOS = [0.01, 0.1, 0.5]
WIRE_GATE = 0.03   # tests/test_int8_wire.py:42


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed, kind):
    """float32 normal draws, or ("grid") values on a coarse grid with many
    ties at every magnitude, as bf16-rounded updates have."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "grid":
        x = np.round(x * 8) / 8
    return x


@pytest.mark.parametrize("kind", ["normal", "grid"])
@pytest.mark.parametrize("shape", SHAPES)
def test_topk_threshold_matches_reference(shape, kind):
    for i, ratio in enumerate(RATIOS):
        x = _inputs(shape, 10 + i, kind)
        got = comp.topk_threshold_sparsify(torch.from_numpy(x), ratio).numpy()
        eager = np.asarray(ref_comp.topk_threshold_sparsify(jnp.asarray(x), ratio))
        jitted = np.asarray(jax.jit(functools.partial(ref_comp.topk_threshold_sparsify,
                                                      ratio=ratio))(jnp.asarray(x)))
        assert np.array_equal(got, eager) and np.array_equal(got, jitted), (shape, ratio)
        k = max(1, round(ratio * x.size))
        assert (got != 0).sum() >= min(k, (x != 0).sum())


def test_topk_threshold_keeps_the_dtype_and_stays_on_the_device():
    x = torch.from_numpy(_inputs((64, 33), 3, "normal")).bfloat16()
    y = comp.topk_threshold_sparsify(x, 0.05)
    assert y.dtype == torch.bfloat16 and y.device == x.device
    want = ref_comp.topk_threshold_sparsify(jnp.asarray(x.float().numpy(), jnp.bfloat16), 0.05)
    assert np.array_equal(y.float().numpy(), np.asarray(want, np.float32))


def _one_quantum(x: np.ndarray) -> np.ndarray:
    """max|row|/127 per last-dim row, broadcast over the row."""
    return np.broadcast_to(np.abs(x).max(-1, keepdims=True) / np.float32(127), x.shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_rowwise_matches_reference(shape):
    x = _inputs(shape, 5, "normal")
    got = comp.int8_roundtrip_rowwise(torch.from_numpy(x)).numpy()
    eager = np.asarray(ref_comp.int8_roundtrip_rowwise(jnp.asarray(x)))
    assert np.array_equal(got, eager)
    jitted = np.asarray(jax.jit(ref_comp.int8_roundtrip_rowwise)(jnp.asarray(x)))
    assert np.all(np.abs(got - jitted) <= _one_quantum(x) * 1.0001)


def test_int8_rowwise_scale_is_one_ulp_from_the_jitted_reference():
    x = _inputs((64, 256), 6, "normal")
    amax = np.abs(x).max(-1)
    got = (torch.from_numpy(amax) / torch.tensor(127.0)).numpy()
    jitted = np.asarray(jax.jit(lambda a: a / 127.0)(jnp.asarray(amax)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - jitted.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # a zero row keeps the 1e-12 floor and dequantizes to zeros
    z = np.zeros((2, 7), np.float32)
    assert np.array_equal(comp.int8_roundtrip_rowwise(torch.from_numpy(z)).numpy(), z)


@pytest.mark.parametrize("method", ["topk", "int8", "topk+int8"])
def test_spmd_compressor_matches_reference(method):
    tree = {"a": _inputs((40, 96), 7, "normal"), "b": {"c": _inputs((500,), 8, "grid")},
            "s": np.float32(1.5)}
    port = comp.Compressor(method, 0.05, spmd=True).roundtrip(
        {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])},
         "s": torch.tensor(tree["s"])})
    ref_c = ref_comp.Compressor(method, 0.05, spmd=True)
    ref_t = jax.tree_util.tree_map(jnp.asarray, tree)
    eager = ref_c.roundtrip(ref_t)
    jitted = jax.jit(ref_c.roundtrip)(ref_t)
    for got, e, j, x in ((port["a"], eager["a"], jitted["a"], tree["a"]),
                         (port["b"]["c"], eager["b"]["c"], jitted["b"]["c"], tree["b"]["c"])):
        got = got.numpy()
        assert np.array_equal(got, np.asarray(e))
        assert np.all(np.abs(got - np.asarray(j)) <= _one_quantum(x) * 1.0001)
    assert port["s"].item() == 1.5   # a scalar passes unchanged


def test_spmd_compressor_differs_from_the_block_channel():
    """``spmd`` picks the per-leaf codecs, not the 256-element block ones."""
    x = torch.from_numpy(_inputs((8, 512), 9, "normal"))
    spmd = comp.Compressor("topk+int8", 0.01, spmd=True).roundtrip_leaf(x)
    block = comp.Compressor("topk+int8", 0.01).roundtrip_leaf(x)
    assert torch.equal(spmd, comp.int8_roundtrip_rowwise(comp.topk_threshold_sparsify(x, 0.01)))
    assert not torch.equal(spmd, block)


# ---------------------------------------------------------------- the wire
WIRE_LEAVES = {
    "w": (256, 256),     # quantized: rows of 256
    "v": (5000,),        # 1-D leaf: its pod-local slice (1, 5000) is 2-D, quantized
    "b": (16,),          # dense: 16 x 2 pods <= 8192
    "m": (40, 100),      # dense: 4000 x 2 pods <= 8192
    "s": (),             # dense: a scalar per cloud
}
WEIGHTS = np.asarray([0.3, 0.7], np.float32)

WIRE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.aggregation import int8_wire_weighted_average
from repro.launch.mesh import make_sim_mesh

d = dict(np.load(sys.argv[1]))
w = jnp.asarray(d.pop("__weights"))
mesh = make_sim_mesh(2)
specs = {k: P() for k in d}
placed = {k: jax.device_put(v, NamedSharding(mesh, P("pod"))) for k, v in d.items()}
with mesh:
    fn = jax.jit(lambda t, w: int8_wire_weighted_average(t, w, pod_axis="pod", mesh=mesh,
                                                         shard_specs=specs))
    out = fn(placed, w)
    hlo = fn.lower(placed, w).compile().as_text()
assert " s8[" in hlo
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("WIRE_OK")
"""


@pytest.fixture(scope="module")
def wire_case(tmp_path_factory):
    rng = np.random.default_rng(21)
    stacked = {k: rng.standard_normal((2, *shape)).astype(np.float32)
               for k, shape in WIRE_LEAVES.items()}
    d = tmp_path_factory.mktemp("wire")
    np.savez(d / "in.npz", __weights=WEIGHTS, **stacked)
    r = subprocess.run(
        [sys.executable, "-c", WIRE_SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin", "HOME": os.environ.get("HOME", "/tmp"),
             # pin the CPU: with libtpu installed jax otherwise probes for a TPU
             "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "WIRE_OK" in r.stdout
    return stacked, dict(np.load(d / "out.npz"))


def _port_wire(stacked):
    mesh = make_sim_mesh(2, devices=["cpu", "cpu"])
    tree = {k: [torch.from_numpy(np.asarray(v[c])) for c in range(2)] for k, v in stacked.items()}
    return agg.int8_wire_weighted_average(tree, torch.from_numpy(WEIGHTS), pod_axis="pod",
                                          mesh=mesh)


def test_int8_wire_matches_reference(wire_case):
    stacked, ref = wire_case
    got = _port_wire(stacked)
    for k, x in stacked.items():
        g = got[k].numpy()
        assert g.dtype == np.float32 and g.shape == x.shape[1:], k
        quantized = x.ndim > 1 and x[0].size * 2 > agg.WIRE_DENSE_MAX
        if quantized:
            quantum = sum(WEIGHTS[c] * _one_quantum(x[c]) for c in range(2))
            assert np.all(np.abs(g - ref[k]) <= quantum * 1.0001), k
        else:
            ulp = np.float32(2.0 ** -23) * sum(np.abs(WEIGHTS[c] * x[c]) for c in range(2))
            assert np.all(np.abs(g - ref[k]) <= ulp), k
        assert quantized == (k in ("w", "v")), k


def test_int8_wire_is_within_the_reference_gate_of_the_dense_average(wire_case):
    stacked, _ = wire_case
    got = _port_wire(stacked)
    dense = agg.weighted_average({k: torch.from_numpy(v) for k, v in stacked.items()},
                                 torch.from_numpy(WEIGHTS))
    for k in stacked:
        scale = dense[k].abs().max().item() + 1e-9
        err = (got[k] - dense[k]).abs().max().item() / scale
        assert err < WIRE_GATE, (k, err)
        if k in ("w", "v"):
            assert err > 0, k    # the int8 path really ran


def test_int8_wire_needs_the_pod_mesh():
    x = [torch.ones(4, 4), torch.ones(4, 4)]
    with pytest.raises(ValueError, match="mesh"):
        agg.int8_wire_weighted_average(x, torch.ones(2))


# ------------------------------------------------------ pod-mode plumbing
def _trainer(**fed_kw):
    cfg = get_smoke_config("stablelm-1.6b")
    fed = FederatedConfig(n_clouds=2, local_steps=1, **fed_kw)
    return cfg, FederatedTrainer(build_model(cfg), fed, TrainConfig(seq_len=8, steps=2),
                                 spmd_axis="pod",
                                 mesh=make_sim_mesh(2, devices=["cpu", "cpu"]))


def test_pod_mode_needs_a_pod_mesh_of_one_device_per_cloud():
    cfg = get_smoke_config("stablelm-1.6b")
    fed = FederatedConfig(n_clouds=2)
    with pytest.raises(ValueError, match="pod"):
        FederatedTrainer(build_model(cfg), fed, TrainConfig(), spmd_axis="pod")
    with pytest.raises(ValueError, match="pod"):
        FederatedTrainer(build_model(cfg), fed, TrainConfig(), spmd_axis="pod",
                         mesh=make_sim_mesh(1, devices=["cpu"]))
    with pytest.raises(ValueError, match="device"):
        make_sim_mesh(3, devices=["cpu", "cpu"])
    _, t = _trainer(compression="topk+int8")
    assert t.compressor.spmd


@pytest.mark.parametrize("pod, aggregation", [(False, "fedavg"), (True, "async"),
                                              (True, "gradient")],
                         ids=["no-pod-axis", "async", "gradient"])
def test_wire_int8_refused_where_the_sync_would_move_fp32(pod, aggregation):
    """``wire_int8`` is the pod-mode fedavg/dynamic sync: without a pod
    axis, and under async or gradient aggregation (whose syncs never take
    the wire), the trainer raises rather than train with the fp32 sync."""
    cfg = get_smoke_config("stablelm-1.6b")
    fed = FederatedConfig(n_clouds=2, aggregation=aggregation, wire_int8=True)
    kw = dict(spmd_axis="pod", mesh=make_sim_mesh(2, devices=["cpu", "cpu"])) if pod else {}
    with pytest.raises(ValueError, match="wire_int8"):
        FederatedTrainer(build_model(cfg), fed, TrainConfig(), **kw)


@pytest.mark.parametrize("wire", [False, True])
def test_pod_mode_sync_is_the_wire_or_the_dense_average(wire):
    """One sync of the pod-mode trainer: the new global params are the old
    plus the wire's (or the dense) average of the clouds' transmitted
    updates, which the error feedback records."""
    cfg, t = _trainer(compression="topk+int8", wire_int8=wire)
    state = t.init_state(torch.Generator().manual_seed(0), "cpu")
    old = {k: v.clone() for k, v in state["global"]["params"]["layers"]["attn"].items()}
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 2, 9),
                                                              dtype=np.int32))
    clouds = None

    def hook(state):
        nonlocal clouds
        clouds = [{k: v.clone() for k, v in c["params"]["layers"]["attn"].items()}
                  for c in state["clouds"]]

    sync = t._sync
    t._sync = lambda st, a, al: (hook(st), sync(st, a, al))[1]
    state, m = t.train_step(state, {"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    assert m["synced"] == 1.0
    w = torch.tensor([0.5, 0.5])
    for k in ("wq", "wo"):
        sent = [t.compressor.roundtrip_leaf(c[k].float() - old[k].float()) for c in clouds]
        if wire:
            d = agg.int8_wire_weighted_average(sent, w, mesh=t.mesh)
        else:
            d = agg.weighted_average(sent, w)
        want = (old[k].float() + d).to(old[k].dtype)
        assert torch.equal(state["global"]["params"]["layers"]["attn"][k], want), k
        for c in range(2):
            ef = state["ef"][c]["layers"]["attn"][k]
            assert torch.equal(ef, (clouds[c][k].float() - old[k].float()) - sent[c]), k


def test_run_training_in_pod_mode():
    """``run_training(pods=True, wire_int8=True)`` trains through the
    pod-mode step: the SPMD codecs and the int8 wire, one pod per cloud on
    the CPU."""
    from repro_torch.launch import train

    res = train.run_training(steps=2, seq_len=8, per_cloud_batch=2, n_clouds=2, local_steps=1,
                             compression="topk+int8", pods=True, wire_int8=True, log_every=1,
                             device="cpu",
                             log_fn=lambda m: None)
    t = res["trainer"]
    assert t.spmd_axis == "pod" and t.compressor.spmd and t.fed.wire_int8
    assert t.mesh.devices == (torch.device("cpu"),) * 2
    assert len(res["history"]) == 2 and all(np.isfinite(h["loss"]) for h in res["history"])
