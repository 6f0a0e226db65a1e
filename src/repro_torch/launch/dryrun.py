"""Dry run: every (architecture × input shape × production mesh) laid out
without a device — its shapes, its partition specs and the bytes each
device holds (the reference's ``launch/dryrun.py``, its compiler-free half).

Nothing is allocated: the step's inputs and outputs are meta tensors
(``launch/specs.py``), the meshes logical (``launch/mesh.py``), and each
leaf's per-device bytes are its bytes over the product of the axis sizes
its spec names (``mesh.shard_bytes``). A record carries the reference's
keys, the memory plan's ``argument_bytes`` and ``output_bytes`` per
device, and the sharding rules the step runs under:

* training (16 × 16): params, AdamW state and batch in; params, AdamW state
  and the loss's metrics out;
* training (2 × 16 × 16): the federated step; its state laid out as the
  reference's (the clouds' params and AdamW state stacked on a leading
  ``pod`` axis, the global params, the sample counts, loss sums, step and
  PRNG key) and the cloud-stacked batch in; the state and the step's
  metrics out;
* prefill: params and prompts in; the decode cache and last-position
  logits out;
* decode: params, cache and tokens in; the cache and logits out.

What only a compiler can give (the program's FLOPs and bytes, its
temporaries and code, collectives, the roofline terms and the compile
time) is ``null`` beside ``"needs": "compiler"``.

Usage:
    python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod both \\
        --out build/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import traceback

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape
from repro_torch.configs.base import FederatedConfig, ModelConfig, ShapeConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs as speclib
from repro_torch.launch.steps import decode_window_for, make_prefill_step
from repro_torch.models.common import padded_vocab
from repro_torch.models.model import build_model
from repro_torch.models.sharding import DEFAULT_RULES, ShardingRules

# The fields only a compiled program gives.
COMPILER_FIELDS = ("hlo_flops_per_device", "hlo_bytes_per_device", "useful_flops_ratio",
                   "roofline", "dominant", "compile_seconds")


def _rules_for(mesh, kind: str = "training", cfg: ModelConfig | None = None) -> ShardingRules:
    """The logical axis rules a step runs under: the default ones; under
    ``pure_dp`` no tensor axis and the batch over both intra-pod axes (and
    the pod axis when serving); on a multi-pod mesh long caches over ("pod",
    "data") and, serving, the batch too (the pod axis is more data
    parallelism there)."""
    rules = dict(DEFAULT_RULES)
    if cfg is not None and cfg.pure_dp:
        rules = {k: None for k in rules}
        dp = ("data", "model")
        if "pod" in mesh.axis_names and kind in ("prefill", "decode"):
            dp = ("pod", "data", "model")
        rules["batch"] = dp
        return ShardingRules(mesh, rules)
    if "pod" in mesh.axis_names:
        rules["cache_seq"] = ("pod", "data")
        if kind in ("prefill", "decode"):
            rules["batch"] = ("pod", "data")
    return ShardingRules(mesh, rules)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (training) or 2·N·D (prefill; decode: one token a sequence),
    N the active parameters."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * speclib.text_len(cfg, shape)
    if shape.kind == "training":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch


def _effective_cfg(cfg: ModelConfig, shape: ShapeConfig, mesh, *, federated: bool = False):
    """``pure_dp`` needs the (per-pod) batch to cover both intra-pod axes;
    where it cannot (e.g. 128 a cloud over 16 × 16), the tensor-parallel
    rules instead, rather than an idle model axis."""
    if not cfg.pure_dp:
        return cfg
    n_pods = meshlib.axis_size(mesh, "pod") if federated else 1
    dp = meshlib.axis_size(mesh, "data") * meshlib.axis_size(mesh, "model")
    per_pod = shape.global_batch // (n_pods or 1)
    if shape.kind != "training" and "pod" in mesh.axis_names and not federated:
        dp *= meshlib.axis_size(mesh, "pod")
    if per_pod % dp == 0 or per_pod == 1:
        return cfg
    return dataclasses.replace(cfg, pure_dp=False)


# ------------------------------------------------------------- memory plans
def _pairs(tree, specs):
    """(leaf, spec) pairs of a tree of meta tensors and its spec tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, list):
        for v, sp in zip(tree, specs):
            yield from _pairs(v, sp)
    else:
        yield tree, specs


def _bytes(*trees_and_specs, mesh) -> int:
    return sum(meshlib.shard_bytes(x, spec, mesh)
               for tree, specs in trees_and_specs for x, spec in _pairs(tree, specs))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _replicated(tree):
    return _map(lambda x: (None,) * x.ndim, tree)


def _scalars(*names) -> dict:
    return {n: speclib.meta((), torch.float32) for n in names}


def _train_metrics(cfg: ModelConfig) -> dict:
    """The loss's metrics: loss and accuracy, and the transformer family's
    aux loss."""
    if cfg.arch_type in ("dense", "moe"):
        return _scalars("loss", "accuracy", "aux_loss")
    return _scalars("loss", "accuracy")


def _logits(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return speclib.meta((batch, padded_vocab(cfg.vocab_size)), torch.float32)


@functools.lru_cache(maxsize=None)
def _prefill_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(params, prompts, (cache, logits)): the prefill step's inputs and
    what it returns, from the step itself on the meta device. The xLSTM's
    sLSTM runs a prompt token by token (a Python loop ``seq_len`` long), and
    its state does not grow with the prompt, so its cache is
    ``init_cache``'s."""
    model = build_model(cfg)
    params = speclib.meta_params(model)
    batch = speclib.train_batch_specs(cfg, shape)
    batch.pop("labels")
    if cfg.arch_type == "ssm":
        out = (model.init_cache(params, batch, shape.seq_len),
               _logits(cfg, shape.global_batch))
    else:
        with torch.no_grad():
            out = make_prefill_step(model, shape)(params, batch)
    return params, batch, out


@functools.lru_cache(maxsize=None)
def _decode_specs(cfg: ModelConfig, shape: ShapeConfig, window: int):
    model = build_model(cfg)
    return speclib.meta_params(model), speclib.cache_specs(model, cfg, shape, window)


def _plan_train(cfg, shape, mesh) -> tuple[int, int]:
    params, opt = speclib.state_specs(build_model(cfg))
    batch = speclib.train_batch_specs(cfg, shape)
    p_ps = meshlib.params_pspec_tree(params, cfg, mesh)
    o_ps = meshlib.opt_pspec_tree(opt, p_ps, mesh)
    b_ps = meshlib.batch_pspec(batch, mesh, pure_dp=cfg.pure_dp)
    metrics = _train_metrics(cfg)
    return (_bytes((params, p_ps), (opt, o_ps), (batch, b_ps), mesh=mesh),
            _bytes((params, p_ps), (opt, o_ps), (metrics, _replicated(metrics)), mesh=mesh))


def federated_state_specs(cfg: ModelConfig, fed: FederatedConfig, mesh) -> tuple[dict, dict]:
    """(state, specs) of the federated step, in the reference's layout:
    every cloud's params and AdamW state stacked on a leading ``pod`` axis
    (specs the parameters' behind "pod"), the global params and the outer
    optimizer's state, the per-cloud sample counts and loss sums, the step
    and the PRNG key (two uint32), and with compression and error feedback
    the per-cloud residuals. The port's ``FederatedTrainer`` keeps a list
    of per-cloud trees instead; the bytes are the same."""
    n = fed.n_clouds
    params = speclib.meta_params(build_model(cfg))

    def stacked(dtype=None):
        return _map(lambda x: speclib.meta((n, *x.shape), dtype or x.dtype), params)

    p_ps = meshlib.params_pspec_tree(params, cfg, mesh)
    pod_p = meshlib.params_pspec_tree(params, cfg, mesh, prefix=("pod",))
    outer = ({"momentum": _map(lambda x: speclib.meta(x.shape, torch.float32), params)}
             if fed.outer_optimizer == "nesterov" else {})
    state = {
        "clouds": {"params": stacked(),
                   "opt": {"m": stacked(torch.float32), "v": stacked(torch.float32),
                           "count": speclib.meta((n,), torch.int32)}},
        "global": {"params": params, "outer": outer},
        "sample_counts": speclib.meta((n,), torch.float32),
        "loss_accum": speclib.meta((n,), torch.float32),
        "step": speclib.meta((), torch.int32),
        "rng": speclib.meta((2,), torch.uint32),
    }
    specs = {
        "clouds": {"params": pod_p, "opt": {"m": pod_p, "v": pod_p, "count": ("pod",)}},
        "global": {"params": p_ps, "outer": _replicated(outer)},
        "sample_counts": ("pod",),
        "loss_accum": ("pod",),
        "step": (),
        "rng": (None,),
    }
    if fed.compression != "none" and fed.error_feedback:
        state["ef"] = stacked(torch.float32)
        specs["ef"] = pod_p
    return state, specs


def _plan_federated(cfg, shape, mesh) -> tuple[int, int]:
    n = meshlib.axis_size(mesh, "pod")
    fed = FederatedConfig(n_clouds=n, local_steps=4, aggregation="fedavg", compression="none")
    state, s_ps = federated_state_specs(cfg, fed, mesh)
    batch = speclib.train_batch_specs(cfg, shape, n_pods=n)
    b_ps = meshlib.batch_pspec(batch, mesh, pod_stacked=True, pure_dp=cfg.pure_dp)
    metrics = {**_scalars("loss", "accuracy", "synced"),
               "per_cloud_loss": speclib.meta((n,), torch.float32)}
    return (_bytes((state, s_ps), (batch, b_ps), mesh=mesh),
            _bytes((state, s_ps), (metrics, _replicated(metrics)), mesh=mesh))


def _plan_prefill(cfg, shape, mesh) -> tuple[int, int]:
    params, batch, (cache, logits) = _prefill_specs(cfg, shape)
    p_ps = meshlib.params_pspec_tree(params, cfg, mesh)
    b_ps = meshlib.batch_pspec(batch, mesh, pure_dp=cfg.pure_dp)
    c_ps = meshlib.cache_pspec(cache, cfg, mesh, shape.global_batch)
    return (_bytes((params, p_ps), (batch, b_ps), mesh=mesh),
            _bytes((cache, c_ps), (logits, (None, "model")), mesh=mesh))


def _plan_decode(cfg, shape, mesh) -> tuple[int, int]:
    params, cache = _decode_specs(cfg, shape, decode_window_for(cfg, shape))
    tokens = speclib.decode_token_specs(shape)
    logits = _logits(cfg, shape.global_batch)
    p_ps = meshlib.params_pspec_tree(params, cfg, mesh)
    c_ps = meshlib.cache_pspec(cache, cfg, mesh, shape.global_batch)
    t_ps = meshlib.batch_pspec({"tokens": tokens}, mesh, pure_dp=cfg.pure_dp)["tokens"]
    return (_bytes((params, p_ps), (cache, c_ps), (tokens, t_ps), mesh=mesh),
            _bytes((cache, c_ps), (logits, (None, "model")), mesh=mesh))


def memory_plan(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                federated: bool = False) -> tuple[ModelConfig, dict]:
    """(the config the step runs, ``_effective_cfg``; {"argument_bytes",
    "output_bytes"} per device) of ``shape``'s step over ``mesh``: the
    federated step with ``federated`` (training shapes), else the
    single-pod train, prefill or decode step."""
    cfg = _effective_cfg(cfg, shape, mesh, federated=federated)
    if shape.kind == "training":
        arg, out = (_plan_federated if federated else _plan_train)(cfg, shape, mesh)
    elif shape.kind == "prefill":
        arg, out = _plan_prefill(cfg, shape, mesh)
    else:
        arg, out = _plan_decode(cfg, shape, mesh)
    return cfg, {"argument_bytes": arg, "output_bytes": out}


def dryrun_pair(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    """One record: ``arch`` at input shape ``shape_name`` over the
    production mesh (multi-pod: the federated step for training)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    n_pods = meshlib.axis_size(mesh, "pod")
    mb = speclib.microbatch_policy(cfg, shape, n_pods=n_pods,
                                   data_axis=meshlib.axis_size(mesh, "data"))
    run_cfg, mem = memory_plan(cfg, shape, mesh,
                               federated=multi_pod and shape.kind == "training")
    mf = model_flops(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
        "microbatches": mb,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops_total": mf,
        "model_flops_per_device": mf / mesh.size,
        "devices": mesh.size,
        "memory": {**mem, "temp_bytes": None, "code_bytes": None},
        "rules": _rules_for(mesh, shape.kind, cfg=run_cfg).map,
        **{k: None for k in COMPILER_FIELDS},
        "needs": "compiler",
    }
    print(f"[{arch} × {shape_name} × {rec['mesh']}] mb={mb} "
          f"arguments {mem['argument_bytes'] / 2**30:.3f} GiB "
          f"outputs {mem['output_bytes'] / 2**30:.3f} GiB per device", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="off")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]

    records, failures = [], []
    for arch in archs:
        for shape_name in shapes:
            for mp in pods:
                mesh_name = "2x16x16" if mp else "16x16"
                try:
                    rec = dryrun_pair(arch, shape_name, multi_pod=mp)
                except Exception as e:  # noqa: BLE001 -- recorded, and the run fails at the end
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(rec)
                records.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in records)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print(f"  {f_['arch']} × {f_['shape']} × {f_['mesh']}: {f_['error'][:120]}")
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
