"""The port's dry run against the reference's, for all ten full configs on
both production meshes (16 × 16 over data × model; 2 × 16 × 16 with the pod
axis), without a device on either side: the reference's specs are
``jax.eval_shape`` trees over an ``AbstractMesh``, the port's meta tensors
over a ``LogicalMesh``.

* Every spec tree (params with and without the pod prefix, AdamW state,
  training batches flat and pod-stacked, the decode caches of decode_32k
  and long_500k, the prefill cache of prefill_32k) equals the reference's
  leaf for leaf on the same leaf paths, a reference ``PartitionSpec``
  padded with None to its leaf's rank. The reference's ring caches carry a
  ``window`` scalar the port's caches do not (its decode takes the window
  as an argument); it is the only leaf the port lacks.
* The shapes and dtypes of ``state_specs``, ``train_batch_specs``,
  ``cache_specs`` and the prefill step's outputs equal the reference's.
* ``microbatch_policy``, ``layers_for_memory``, ``decode_window_for``,
  ``text_len`` and ``active_param_count`` equal the reference's; its
  ``model_flops`` and ``_effective_cfg`` come from one subprocess, since
  importing ``repro.launch.dryrun`` forces 512 host devices on JAX.
* ``memory_plan``'s ``argument_bytes`` of each of the 80 records equals a
  plain numpy sum over the reference's own trees and specs (each leaf's
  bytes over the product of the axis sizes its spec names), the federated
  step's state laid out as the reference's ``lower_federated_train`` lays
  it; the prefill and decode records' ``output_bytes`` too.
* ``slot_cache_specs``, ``paged_cache_specs`` (fp and int8) and
  ``draft_cache_specs`` equal the reference's shapes and dtypes, or raise as
  it does.
* The CLI writes its records with the reference's keys, the memory plan,
  and ``null`` for what needs a compiler.
* ``launch/steps.py``'s train step (2 microbatches, one AdamW step),
  prefill step and decode step on the stablelm smoke config in float32,
  bridged weights, against the reference's jitted steps: parameters, m,
  logits and caches within 1e-5 of their scale, v (g squared) within 2e-5
  (AdamW's eps at 1e-3, see the test)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import FederatedConfig as RefFederatedConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core.federated import FederatedTrainer as RefFederatedTrainer
from repro.launch import mesh as rmesh
from repro.launch import specs as rspecs
from repro.launch import steps as rsteps
from repro.models import build_model as ref_build_model
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.bridge import numpy_from_params, numpy_params, params_from_numpy
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape, get_smoke_config
from repro_torch.configs.base import FederatedConfig, ShapeConfig, TrainConfig
from repro_torch.optim.adamw import adamw_init
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import specs as pspecs
from repro_torch.launch import steps as psteps
from repro_torch.models.model import build_model

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's model_flops and _effective_cfg (pure_dp) per (arch, shape,
# multi-pod), from a process of their own
_SUBPROCESS = r"""
import json, sys
from jax.sharding import AbstractMesh
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro.launch import dryrun
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for mp in (False, True):
            mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if mp
                    else AbstractMesh((16, 16), ("data", "model")))
            eff = dryrun._effective_cfg(cfg, shape, mesh,
                                        federated=mp and shape.kind == "training")
            out[f"{arch}|{name}|{int(mp)}"] = [dryrun.model_flops(cfg, shape), eff.pure_dp]
json.dump(out, sys.stdout)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference dry run's ``model_flops`` and ``_effective_cfg``,
    started first and read when a test needs it."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", _ROOT),
           "PYTHONPATH": os.path.join(_ROOT, "src")}
    proc = subprocess.Popen([sys.executable, "-c", _SUBPROCESS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, text=True)
    cache = {}

    def get():
        if not cache:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err
            cache.update(json.loads(out))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _abstract(multi_pod: bool) -> AbstractMesh:
    return AbstractMesh(*MESHES[multi_pod])


def _logical(multi_pod: bool) -> pmesh.LogicalMesh:
    sizes, names = MESHES[multi_pod]
    return pmesh.LogicalMesh(names, sizes)


# ------------------------------------------------------------ tree helpers
def _ref_leaves(tree) -> dict:
    """path → leaf of a reference tree (SDS leaves or PartitionSpecs)."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {rmesh._leaf_path(p): x for p, x in flat}


def _port_leaves(tree) -> dict:
    return dict(pmesh._leaf_items(tree))


def _norm(spec: P, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _shapes_equal(ref_tree, port_tree, *, ref_only=()):
    r, p = _ref_leaves(ref_tree), _port_leaves(port_tree)
    assert set(r) - set(p) <= set(ref_only) and set(p) <= set(r), (set(r) ^ set(p))
    for path, x in p.items():
        assert tuple(x.shape) == tuple(r[path].shape), path
        assert str(x.dtype).removeprefix("torch.") == str(np.dtype(r[path].dtype)), path
        assert x.device.type == "meta", path


def _specs_equal(ref_shapes, ref_specs, port_specs, *, ref_only=()):
    rs, ps, shapes = _ref_leaves(ref_specs), _port_leaves(port_specs), _ref_leaves(ref_shapes)
    assert set(rs) - set(ps) <= set(ref_only) and set(ps) <= set(rs), (set(rs) ^ set(ps))
    for path, spec in ps.items():
        assert spec == _norm(rs[path], len(shapes[path].shape)), path


def _np_bytes(shapes, specs, sizes: dict) -> int:
    """Per-device bytes of a reference tree under its specs, in numpy."""
    sh, sp = _ref_leaves(shapes), _ref_leaves(specs)
    total = 0
    for path, x in sh.items():
        dims = np.asarray(x.shape, np.int64)
        for d, axis in enumerate(_norm(sp[path], len(dims))):
            if axis is not None:
                axes = axis if isinstance(axis, tuple) else (axis,)
                dims[d] = -(-dims[d] // int(np.prod([sizes[a] for a in axes])))
        total += int(np.prod(dims)) * np.dtype(x.dtype).itemsize
    return total


# ------------------------------------------------------------- per arch
@pytest.fixture(scope="module")
def trees():
    """Per arch, the reference's and the port's spec trees, built once."""
    out = {}

    def get(arch):
        if arch not in out:
            out[arch] = _build(arch)
        return out[arch]

    return get


def _build(arch: str) -> dict:
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    model, rmodel = build_model(cfg), ref_build_model(rcfg)
    key = jax.random.PRNGKey(0)
    t = {"cfg": cfg, "rcfg": rcfg, "model": model, "rmodel": rmodel}
    t["rparams"] = jax.eval_shape(rmodel.init, key)
    t["ropt"] = jax.eval_shape(ref_adamw_init, t["rparams"])
    t["params"], t["opt"] = pspecs.state_specs(model)
    pre = REF_SHAPES["prefill_32k"]
    rbatch = rspecs.train_batch_specs(rcfg, pre)
    rbatch.pop("labels")
    t["rprefill"] = (rbatch, jax.eval_shape(rsteps.make_prefill_step(rmodel, pre),
                                            t["rparams"], rbatch))
    t["prefill"] = dryrun._prefill_specs(cfg, get_shape("prefill_32k"))
    t["rdecode"], t["decode"] = {}, {}
    for name in ("decode_32k", "long_500k"):
        rs, ps = REF_SHAPES[name], get_shape(name)
        t["rdecode"][name] = rspecs.cache_specs(rmodel, rcfg, rs,
                                                rsteps.decode_window_for(rcfg, rs))
        t["decode"][name] = dryrun._decode_specs(cfg, ps, psteps.decode_window_for(cfg, ps))[1]
    # the trainer's init_state over the known parameter shapes (no second
    # trace of the model's init)
    known = dataclasses.replace(rmodel, init=lambda _: jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, x.dtype), t["rparams"]))
    trainer = RefFederatedTrainer(known, RefFederatedConfig(
        n_clouds=2, local_steps=4, aggregation="fedavg", compression="none"),
        RefTrainConfig(seq_len=4096, global_batch=256))
    t["rfed"] = jax.eval_shape(trainer.init_state, key)
    return t


def _ref_fed_pspec(t, cfg, mesh) -> dict:
    """The reference's federated state specs, as its
    ``lower_federated_train`` lays them out."""
    p_pspec = rmesh.params_pspec_tree(t["rparams"], cfg, mesh)
    pod_p = rmesh.params_pspec_tree(t["rparams"], cfg, mesh, prefix=("pod",))
    return {
        "clouds": {"params": pod_p, "opt": {"m": pod_p, "v": pod_p, "count": P("pod")}},
        "global": {"params": p_pspec,
                   "outer": jax.tree_util.tree_map(lambda _: P(), t["rfed"]["global"]["outer"])},
        "sample_counts": P("pod"), "loss_accum": P("pod"), "step": P(), "rng": P(),
    }


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_and_param_specs_match_reference(trees, arch):
    t = trees(arch)
    _shapes_equal(t["rparams"], t["params"])
    _shapes_equal(t["ropt"], t["opt"])
    for mp in (False, True):
        rm, pm = _abstract(mp), _logical(mp)
        rp = rmesh.params_pspec_tree(t["rparams"], t["rcfg"], rm)
        pp = pmesh.params_pspec_tree(t["params"], t["cfg"], pm)
        _specs_equal(t["rparams"], rp, pp)
        _specs_equal(t["ropt"], rmesh.opt_pspec_tree(t["ropt"], rp, rm),
                     pmesh.opt_pspec_tree(t["opt"], pp, pm))
        if mp:
            fed, fed_specs = dryrun.federated_state_specs(
                t["cfg"], FederatedConfig(n_clouds=2, compression="none"), pm)
            _shapes_equal(t["rfed"], fed)
            _specs_equal(t["rfed"], _ref_fed_pspec(t, t["rcfg"], rm), fed_specs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(trees, arch):
    t = trees(arch)
    cfg, rcfg = t["cfg"], t["rcfg"]
    for mp in (False, True):
        rm, pm = _abstract(mp), _logical(mp)
        for name, shape in REF_SHAPES.items():
            for pods in (1, 2) if shape.kind == "training" else (1,):
                rb = rspecs.train_batch_specs(rcfg, shape, n_pods=pods)
                pb = pspecs.train_batch_specs(cfg, get_shape(name), n_pods=pods)
                _shapes_equal(rb, pb)
                _specs_equal(rb, rmesh.batch_pspec(rb, rm, pod_stacked=pods > 1,
                                                   pure_dp=rcfg.pure_dp),
                             pmesh.batch_pspec(pb, pm, pod_stacked=pods > 1,
                                               pure_dp=cfg.pure_dp))
        caches = [(t["rdecode"][n], t["decode"][n], REF_SHAPES[n].global_batch)
                  for n in t["decode"]]
        caches.append((t["rprefill"][1][0], t["prefill"][2][0],
                       REF_SHAPES["prefill_32k"].global_batch))
        for rc, pc, batch in caches:
            _shapes_equal(rc, pc, ref_only={"window"})
            _specs_equal(rc, rmesh.cache_pspec(rc, rcfg, rm, batch),
                         pmesh.cache_pspec(pc, cfg, pm, batch), ref_only={"window"})
    rlogits, plogits = t["rprefill"][1][1], t["prefill"][2][1]
    assert tuple(plogits.shape) == rlogits.shape and plogits.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_policies_match_reference(ref_dryrun, arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert pspecs.layers_for_memory(cfg) == rspecs.layers_for_memory(rcfg)
    ref = ref_dryrun()
    for name, shape in REF_SHAPES.items():
        ps = get_shape(name)
        assert ps == INPUT_SHAPES[name] and dataclasses.astuple(ps) == dataclasses.astuple(shape)
        assert pspecs.text_len(cfg, ps) == rspecs.text_len(rcfg, shape)
        assert psteps.decode_window_for(cfg, ps) == rsteps.decode_window_for(rcfg, shape)
        for mp in (False, True):
            n_pods = 2 if mp else 1
            assert (pspecs.microbatch_policy(cfg, ps, n_pods=n_pods, data_axis=16)
                    == rspecs.microbatch_policy(rcfg, shape, n_pods=n_pods, data_axis=16))
            flops, pure_dp = ref[f"{arch}|{name}|{int(mp)}"]
            assert dryrun.model_flops(cfg, ps) == flops
            eff = dryrun._effective_cfg(cfg, ps, _logical(mp),
                                        federated=mp and ps.kind == "training")
            assert eff.pure_dp == pure_dp


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_numpy_sum_over_reference_specs(trees, ref_dryrun, arch):
    t = trees(arch)
    ref = ref_dryrun()
    for name, shape in REF_SHAPES.items():
        for mp in (False, True):
            rm, pm = _abstract(mp), _logical(mp)
            sizes = dict(zip(MESHES[mp][1], MESHES[mp][0]))
            rcfg = dataclasses.replace(t["rcfg"], pure_dp=ref[f"{arch}|{name}|{int(mp)}"][1])
            fed = mp and shape.kind == "training"
            _, mem = dryrun.memory_plan(t["cfg"], get_shape(name), pm, federated=fed)
            p_ps = rmesh.params_pspec_tree(t["rparams"], rcfg, rm)
            out = None
            if fed:
                rb = rspecs.train_batch_specs(rcfg, shape, n_pods=2)
                arg = (_np_bytes(t["rfed"], _ref_fed_pspec(t, rcfg, rm), sizes)
                       + _np_bytes(rb, rmesh.batch_pspec(rb, rm, pod_stacked=True,
                                                         pure_dp=rcfg.pure_dp), sizes))
            elif shape.kind == "training":
                rb = rspecs.train_batch_specs(rcfg, shape)
                arg = (_np_bytes(t["rparams"], p_ps, sizes)
                       + _np_bytes(t["ropt"], rmesh.opt_pspec_tree(t["ropt"], p_ps, rm), sizes)
                       + _np_bytes(rb, rmesh.batch_pspec(rb, rm, pure_dp=rcfg.pure_dp), sizes))
            else:
                prefill = shape.kind == "prefill"
                rc = t["rprefill"][1][0] if prefill else t["rdecode"][name]
                rc = {k: v for k, v in rc.items() if k != "window"}  # no port counterpart
                c_ps = rmesh.cache_pspec(rc, rcfg, rm, shape.global_batch)
                rl = jax.ShapeDtypeStruct((shape.global_batch, t["rprefill"][1][1].shape[1]),
                                          np.float32)
                if prefill:
                    rb = t["rprefill"][0]
                    extra = _np_bytes(rb, rmesh.batch_pspec(rb, rm, pure_dp=rcfg.pure_dp), sizes)
                else:
                    tok = {"tokens": rspecs.decode_token_specs(shape)}
                    extra = (_np_bytes(rc, c_ps, sizes)
                             + _np_bytes(tok, rmesh.batch_pspec(tok, rm, pure_dp=rcfg.pure_dp),
                                         sizes))
                arg = _np_bytes(t["rparams"], p_ps, sizes) + extra
                out = _np_bytes(rc, c_ps, sizes) + _np_bytes(rl, P(None, "model"), sizes)
            assert mem["argument_bytes"] == arg, (name, mp)
            if out is not None:
                assert mem["output_bytes"] == out, (name, mp)


@pytest.mark.parametrize("arch", ("stablelm-1.6b", "xlstm-125m", "recurrentgemma-2b"))
def test_engine_cache_specs_match_reference(arch):
    """The engine's caches: per-slot rings (windowed), fp and int8 page
    pools, a speculative draft's state (a KV draft's rings, the xLSTM's
    recurrent state); an arch without one raises as the reference does."""
    model, rmodel = build_model(get_config(arch)), ref_build_model(ref_get_config(arch))
    cases = (("slot_cache_specs", (8, 4096, 1024), {}),
             ("paged_cache_specs", (8, 512, 16, 256), {}),
             ("paged_cache_specs", (8, 512, 16, 256), {"kv_dtype": "int8"}),
             ("draft_cache_specs", (8, 4096, 4), {}))
    for name, args, kw in cases:
        try:
            want = getattr(rspecs, name)(rmodel, *args, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                getattr(pspecs, name)(model, *args, **kw)
            continue
        _shapes_equal(want, getattr(pspecs, name)(model, *args, **kw), ref_only={"window"})


def test_cli_records_carry_the_reference_keys_and_the_memory_plan(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "stablelm-1.6b,xlstm-125m", "--shape", "all", "--multi-pod", "both",
                 "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 16 and "all dry-runs passed" in capsys.readouterr().out
    for r in recs:
        for k in ("arch", "shape", "mesh", "kind", "microbatches", "params", "active_params",
                  "model_flops_total", "model_flops_per_device", "devices"):
            assert k in r, k
        assert r["devices"] == (512 if r["mesh"] == "2x16x16" else 256)
        assert r["needs"] == "compiler" and r["memory"]["temp_bytes"] is None
        assert all(r[k] is None for k in dryrun.COMPILER_FIELDS)
        mp = r["mesh"] == "2x16x16"
        shape = get_shape(r["shape"])
        mesh = pmesh.make_production_mesh(multi_pod=mp)
        run_cfg, mem = dryrun.memory_plan(get_config(r["arch"]), shape, mesh,
                                          federated=mp and shape.kind == "training")
        assert {k: r["memory"][k] for k in mem} == mem
        assert r["rules"] == {k: list(v) if isinstance(v, tuple) else v
                              for k, v in dryrun._rules_for(mesh, r["kind"], run_cfg).map.items()}
    assert set(ARCH_IDS) == set(REF_ARCH_IDS)


def test_steps_match_reference():
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    rcfg = dataclasses.replace(ref_smoke_config("stablelm-1.6b"), dtype="float32")
    model, rmodel = build_model(cfg), ref_build_model(rcfg)
    tree = numpy_params(cfg, 0)
    params, rparams = params_from_numpy(tree, cfg, "cpu"), jax.tree_util.tree_map(jnp.asarray,
                                                                                  tree)
    toks = np.random.default_rng(3).integers(0, 512, (4, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    # eps 1e-3: AdamW's first step moves a parameter by lr * g / (|g| + eps),
    # so at the default 1e-8 a gradient near 1e-8, where the two packages'
    # sums differ in their last bits, moves it by anything up to lr
    tkw = dict(steps=10, lr=1e-2, warmup_steps=2, eps=1e-3)
    params, opt, metrics = psteps.make_train_step(model, TrainConfig(**tkw), 2)(
        params, adamw_init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    rparams2, ropt, rmetrics = jax.jit(rsteps.make_train_step(rmodel, RefTrainConfig(**tkw), 2))(
        rparams, ref_adamw_init(rparams), {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(metrics["loss"].item(), float(rmetrics["loss"]), rtol=1e-5)
    # v holds g**2, whose relative error is twice the gradient's
    for got, want, tol in ((params, rparams2, 1e-5), (opt["m"], ropt["m"], 1e-5),
                           (opt["v"], ropt["v"], 2e-5)):
        flat = _ref_leaves(want)
        for path, x in _port_leaves(numpy_from_params(got)).items():
            scale = max(float(np.abs(flat[path]).max()), 1e-30)
            np.testing.assert_allclose(x, np.asarray(flat[path]), rtol=0, atol=tol * scale,
                                       err_msg=path)
    assert opt["count"] == int(ropt["count"]) == 1
    shape = ShapeConfig("smoke", 12, 4, "prefill")
    cache, logits = psteps.make_prefill_step(model, shape)(
        params_from_numpy(tree, cfg, "cpu"), {"tokens": torch.from_numpy(batch["tokens"])})
    rcache, rlogits = jax.jit(rsteps.make_prefill_step(rmodel, shape))(
        rparams, {"tokens": jnp.asarray(batch["tokens"])})
    for got, want in ((logits, rlogits), (cache["k"], rcache["k"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    nxt = toks[:, -1:]
    _, dl = psteps.make_decode_step(model, 0)(params_from_numpy(tree, cfg, "cpu"), cache,
                                              torch.from_numpy(nxt))
    _, rdl = jax.jit(rsteps.make_decode_step(rmodel, 0))(rparams, rcache, jnp.asarray(nxt))
    rdl = np.asarray(rdl)
    np.testing.assert_allclose(dl.numpy(), rdl, rtol=0, atol=1e-5 * float(np.abs(rdl).max()))
