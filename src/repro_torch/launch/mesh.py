"""Meshes of the port: the sharding of a served model over one, the pod
helpers, and the production meshes' partition rules the dry run sizes
against (the reference's ``launch/mesh.py``).

A mesh is an ordered list of torch devices with one named axis: ``pod`` (the
cross-cloud boundary: cloud i's training state lives on device i) or
``model`` (tensor-parallel serving: shard s's head slice lives on device
s). One process drives every shard or pod. A device may appear several
times: on the CPU and on a one-card machine every shard sits on the same
device, the port's counterpart of the reference's virtual host devices
(``--xla_force_host_platform_device_count``).

Tensor-parallel serving (``ServeEngine(mesh=)``): attention heads split over
``model``. ``serve_param_specs``/``serve_cache_specs`` give, per leaf, the
dim that splits (None: replicated), and ``shard_params``/``shard_cache`` cut
a param tree or a cache into a ``models/sharding.Sharded`` tree: the
replicated leaves once, on the first device, and per shard its slices of
the split leaves, on its device:

* ``wq``/``wk``/``wv`` split their output-feature (head) dim, the last;
  every other leaf, ``wo`` included, is replicated. The shards' head
  slices of the pre-``wo`` activation are gathered back to the full
  activation (``models/sharding.gather_heads``) and the full ``wo`` runs
  once, which keeps the combine exact (a row-parallel ``wo`` with a sum of
  partial products would round differently);
* the pool's and rings' ``k``/``v`` split their kv-head dim, -2 (pool (L, P,
  page, Hkv, hd), rings (L, B, C, Hkv, hd)); an int8 pool's ``ks``/``vs``
  ((L, P, page, Hkv)) split their last dim; positions and page tables are
  replicated: one host-side page table serves every shard's pool (each shard
  holds its kv-head slice of the same physical pages).

A replicated leaf exists once, never copied per shard; a split leaf's
slice is a contiguous copy on its shard's device.

The production meshes (``make_production_mesh``) are logical: axis names
and sizes, ``data`` × ``model`` (16 × 16) or ``pod`` × ``data`` × ``model``
(2 × 16 × 16), with no devices behind them; the dry run
(``launch/dryrun.py``) lays the full configs' state out over them by the
reference's rules. A partition spec is a tuple with one entry per dimension
of its leaf: a mesh axis name, a tuple of names (the dimension splits over
their product), or None (replicated), the port's counterpart of
``PartitionSpec``. The rules assign an axis only where it divides the
dimension (``_fits``); parameters follow the leaf-path rules of
``_PARAM_RULES`` (column- and row-parallel attention and MLPs over
``model``, vocab-parallel embeddings, FSDP over ``data`` for configs with
``fsdp``, experts over ``model``; everything replicated under ``pure_dp``),
AdamW's moments their parameters, batches their batch dimension, decode
caches their batch or, at batch 1, their length (``cache_pspec``)."""
from __future__ import annotations

import dataclasses
import math
import re

import torch

from repro_torch.core.protocols import Link
from repro_torch.models.sharding import Sharded

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"

_SERVE_COL = re.compile(r"(attn|xattn)/(wq|wk|wv)$")   # column-parallel


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: ``devices[i]`` holds the axis's i-th shard."""
    devices: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"the port's meshes have one axis, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in first-use order."""
        return list(dict.fromkeys(self.devices))


def visible_devices(kind: str = "cuda") -> list:
    """The devices of ``kind`` this process sees: every CUDA device, or the
    one CPU device."""
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device(kind, i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    """``d`` as a torch device with its index ("cuda" is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _mesh_devices(n: int, devices, kind: str, what: str) -> tuple:
    devs = visible_devices(kind) if devices is None else [_device(d) for d in devices]
    if n < 1 or n > len(devs):
        raise ValueError(
            f"{what} wants {n} device(s), have {len(devs)}; pass devices= (a list may name "
            "one device several times: the shards then share it)")
    return tuple(devs[:n])


def make_sim_mesh(n_clouds: int = 1, devices=None, kind: str = "cuda") -> Mesh:
    """Pod axis only: cloud i on the i-th of ``devices`` (default: the
    visible devices of ``kind``)."""
    return Mesh(_mesh_devices(n_clouds, devices, kind, "pod mesh"), (POD_AXIS,))


def make_serve_mesh(num_shards: int, devices=None, kind: str = "cuda") -> Mesh:
    """1-D tensor-parallel serving mesh over the ``model`` axis: shard s on
    the s-th of ``devices`` (default: the visible devices of ``kind``)."""
    return Mesh(_mesh_devices(num_shards, devices, kind, "serve mesh"), (MODEL_AXIS,))


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` (1 when the mesh has none), on a device
    mesh or a logical one."""
    return int(dict(mesh.shape).get(name, 1))


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Named axes and their sizes, with no devices: what the dry run lays
    state out over."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16 × 16 over ("data", "model"), or 2 × 16 × 16 over ("pod", "data",
    "model") with ``multi_pod``."""
    if multi_pod:
        return LogicalMesh((POD_AXIS, DATA_AXIS, MODEL_AXIS), (2, 16, 16))
    return LogicalMesh((DATA_AXIS, MODEL_AXIS), (16, 16))


def _fits(dim: int, mesh, axis) -> bool:
    """Whether ``axis`` (a name, a tuple of names, or None) can split a
    dimension of size ``dim``: more than one shard, dividing it."""
    if axis is None:
        return True
    size = math.prod(axis_size(mesh, a) for a in (axis if isinstance(axis, tuple) else (axis,)))
    return size > 1 and dim % size == 0


# (regex on the leaf path, {dim from the end: axis role}); the first match
# wins. "fsdp" is the data axis for configs with ``fsdp``, else nothing;
# counting dims from the end keeps stacked layer, period and cloud axes out
# of the rule.
_PARAM_RULES: list[tuple[str, dict[int, str | None]]] = [
    (r"embed/tok$", {-2: "model", -1: "fsdp"}),            # vocab-parallel
    (r"embed/unembed$", {-1: "model", -2: "fsdp"}),
    (r"router$", {-1: None}),
    (r"(attn|xattn)/(wq|wk|wv)$", {-1: "model", -2: "fsdp"}),  # column-parallel
    (r"(attn|xattn)/wo$", {-2: "model", -1: "fsdp"}),          # row-parallel
    (r"(ffn|mlp)/(w_gate|w_up)$", {-1: "model", -2: "fsdp"}),
    (r"(ffn|mlp)/w_down$", {-2: "model", -1: "fsdp"}),
    (r"mix/(wq|wk|wv)$", {-1: "model", -2: "fsdp"}),       # griffin local attention
    (r"mix/wo$", {-2: "model", -1: "fsdp"}),
    (r"mix/(w_x|w_y)$", {-1: "model", -2: "fsdp"}),        # griffin recurrent block
    (r"mix/w_out$", {-2: "model", -1: "fsdp"}),
    (r"mix/conv_w$", {-1: "model"}),
    (r"mix/(gate_r|gate_i)$", {}),                         # block-diagonal per head
    (r"blk/w_up$", {-1: "model", -2: "fsdp"}),             # xLSTM blocks
    (r"blk/(wq|wk|wv)$", {-1: "model", -2: "fsdp"}),
    (r"blk/(w_i|w_f)$", {-2: "fsdp"}),
    (r"blk/w_down$", {-2: "model", -1: "fsdp"}),
    (r"blk/ff_up$", {-1: "model", -2: "fsdp"}),
    (r"blk/ff_down$", {-2: "model", -1: "fsdp"}),
    (r"blk/conv_w$", {-1: "model"}),
    (r"projector/w$", {-1: "model"}),                      # vlm projector
]


def _apply_rule(rule: dict, shape: tuple, fsdp_axis, mesh) -> tuple:
    axes: list = [None] * len(shape)
    for rel_dim, role in rule.items():
        dim = len(shape) + rel_dim if rel_dim < 0 else rel_dim
        if not 0 <= dim < len(shape):
            continue
        axis = fsdp_axis if role == "fsdp" else role
        if axis is not None and _fits(shape[dim], mesh, axis):
            axes[dim] = axis
    return tuple(axes)


def param_spec(path: str, shape: tuple, cfg, mesh) -> tuple:
    """The spec of one parameter leaf (no pod dim: the caller prepends
    it)."""
    if cfg.pure_dp:
        return (None,) * len(shape)
    fsdp_axis = DATA_AXIS if cfg.fsdp else None
    if cfg.arch_type == "moe":
        # expert-parallel weights (L, E, D, F) / (L, E, F, D)
        if re.search(r"ffn/(w_gate|w_up)$", path):
            return _apply_rule({-3: "model", -1: "fsdp"}, shape, fsdp_axis, mesh)
        if re.search(r"ffn/w_down$", path):
            return _apply_rule({-3: "model", -2: "fsdp"}, shape, fsdp_axis, mesh)
    for pat, rule in _PARAM_RULES:
        if re.search(pat, path):
            return _apply_rule(rule, shape, fsdp_axis, mesh)
    return (None,) * len(shape)  # norms, biases, scalars


def params_pspec_tree(params: dict, cfg, mesh, prefix: tuple = ()) -> dict:
    """The specs of a parameter tree (shapes from its leaves), each behind
    ``prefix`` (the federated state's ("pod",) over stacked clouds)."""
    return _map_paths(lambda p, x: (*prefix, *param_spec(p, tuple(x.shape), cfg, mesh)),
                      params)


def opt_pspec_tree(opt: dict, param_pspecs: dict, mesh) -> dict:
    """AdamW's moments take their parameters' specs (FSDP covers them, as
    ZeRO does); the count is replicated."""
    return {"m": param_pspecs, "v": param_pspecs, "count": (None,) * opt["count"].ndim}


def batch_pspec(batch: dict, mesh, *, pod_stacked: bool = False,
                pure_dp: bool = False) -> dict:
    """A batch's leaves split their batch dimension over the data axes
    (("pod", "data") on a multi-pod mesh; ("data", "model") under
    ``pure_dp``), or, ``pod_stacked``, their cloud dimension over "pod" and
    the per-cloud batch over the intra-pod data axes."""
    dp = (DATA_AXIS, MODEL_AXIS) if pure_dp else (DATA_AXIS,)
    b_axes = ((POD_AXIS,) + dp if POD_AXIS in mesh.axis_names and not pod_stacked else dp)
    b_axes = b_axes if len(b_axes) > 1 else b_axes[0]
    dp_axis = dp if len(dp) > 1 else dp[0]

    def spec(path, x):
        dims: list = [None] * x.ndim
        if pod_stacked:
            dims[0] = POD_AXIS
            if x.ndim > 1:
                if _fits(x.shape[1], mesh, dp):
                    dims[1] = dp_axis
                elif _fits(x.shape[1], mesh, DATA_AXIS):
                    dims[1] = DATA_AXIS
        elif _fits(x.shape[0], mesh, b_axes):
            dims[0] = b_axes
        elif _fits(x.shape[0], mesh, dp):
            dims[0] = dp_axis
        elif _fits(x.shape[0], mesh, DATA_AXIS):
            dims[0] = DATA_AXIS
        return tuple(dims)

    return _map_paths(spec, batch)


def cache_pspec(cache: dict, cfg, mesh, batch: int) -> dict:
    """A decode cache's specs: a large batch splits its batch dimension over
    the data axes, and k/v their kv heads over "model" where they divide;
    at a batch the data axes cannot split (batch 1, long context) k/v split
    their length instead (context parallelism, what lets a 500k-token cache
    fit). Recurrent states split their batch dimension and, when it is at
    least 128 wide and divides, their last over "model"; positions are
    replicated."""
    dp = (DATA_AXIS, MODEL_AXIS) if cfg.pure_dp else (DATA_AXIS,)
    b_axes = (POD_AXIS,) + dp if POD_AXIS in mesh.axis_names else dp
    b_axes = b_axes if len(b_axes) > 1 else b_axes[0]
    batch_shardable = _fits(batch, mesh, b_axes) or _fits(batch, mesh, DATA_AXIS)
    b_axis = b_axes if _fits(batch, mesh, b_axes) else (
        DATA_AXIS if _fits(batch, mesh, DATA_AXIS) else None)

    def spec(path, x):
        shape = tuple(x.shape)
        dims: list = [None] * len(shape)
        if re.search(r"(^|/)(k|v|xk|xv)$", path) and len(shape) >= 4:
            # (L, B, C, Hkv, hd), or stacked periods (P, B, C, Hkv, hd)
            bdim, cdim, hdim = len(shape) - 4, len(shape) - 3, len(shape) - 2
            if batch_shardable:
                dims[bdim] = b_axis
            elif _fits(shape[cdim], mesh, b_axes):
                dims[cdim] = b_axes
            if _fits(shape[hdim], mesh, MODEL_AXIS):
                dims[hdim] = MODEL_AXIS
            return tuple(dims)
        if len(shape) >= 2 and not re.search(r"(pos|window)$", path):
            bdim = next((d for d in range(len(shape)) if shape[d] == batch), None)
            if bdim is not None and batch_shardable:
                dims[bdim] = b_axis
            if _fits(shape[-1], mesh, MODEL_AXIS) and shape[-1] >= 128:
                dims[-1] = MODEL_AXIS
        return tuple(dims)

    return _map_paths(spec, cache)


def shard_bytes(x: torch.Tensor, spec: tuple, mesh) -> int:
    """Bytes of one device's block of leaf ``x`` under ``spec``: each
    dimension divided by the product of the axis sizes its entry names
    (rounded up, as a padded block would be)."""
    n = x.element_size()
    for dim, axis in zip(x.shape, spec):
        if axis is None:
            n *= dim
            continue
        size = math.prod(axis_size(mesh, a) for a in (axis if isinstance(axis, tuple) else (axis,)))
        n *= -(-dim // size)
    return n


def _children(tree):
    """(key, child) pairs of a dict or list node, None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, list):
        return list(enumerate(tree))
    return None


def _leaf_items(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict (lists index by position), paths
    joined by "/"."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _leaf_items(v, f"{prefix}/{k}" if prefix else str(k))


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict's leaves, in its structure."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [(k, _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))) for k, v in kids]
    return dict(out) if isinstance(tree, dict) else [v for _, v in out]


def serve_param_specs(params: dict) -> dict:
    """Per leaf, the dim that splits over ``model`` (negative; None:
    replicated): the last dim of ``wq``/``wk``/``wv``, nothing else."""
    return _map_paths(lambda p, x: -1 if _SERVE_COL.search(p) and x.ndim >= 1 else None,
                      params)


def serve_cache_specs(cache: dict) -> dict:
    """Per leaf, the dim that splits over ``model``: the kv-head dim, -2 of
    ``k``/``v`` and -1 of an int8 pool's ``ks``/``vs``; positions and page
    tables replicated (None)."""
    def spec(path, x):
        if re.search(r"(^|/)(k|v)$", path) and x.ndim >= 4:
            return -2
        if re.search(r"(^|/)(ks|vs)$", path) and x.ndim >= 4:
            return -1
        return None

    return _map_paths(spec, cache)


def _select(tree: dict, keep, prefix: str = "") -> dict:
    """The sub-tree of the leaves whose path ``keep`` accepts, each through
    ``keep``'s result; sub-trees left empty are dropped."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            sub = _select(v, keep, path)
            if sub:
                out[k] = sub
        else:
            x = keep(path, v)
            if x is not None:
                out[k] = x
    return out


def shard_tree(tree: dict, specs: dict, mesh: Mesh, axis: str = MODEL_AXIS) -> Sharded:
    """``tree`` split over ``axis``: the replicated leaves once, on the
    mesh's first device (the tensors themselves where they already live
    there), and per shard only its slice of each split leaf, the s-th of
    ``axis_size`` equal slices as a contiguous copy on shard s's device."""
    n = axis_size(mesh, axis)
    dims = dict(_leaf_items(specs))
    for path, x in _leaf_items(tree):
        d = dims[path]
        if d is not None and x.shape[d] % n:
            raise ValueError(f"{path}: dim {d} of {tuple(x.shape)} does not split "
                             f"into {n} shards")
    dev0 = mesh.devices[0]
    full = _select(tree, lambda p, x: (x if x.device == dev0 else x.to(dev0))
                   if dims[p] is None else None)

    def piece(s, dev):
        def cut(path, x):
            d = dims[path]
            if d is None:
                return None
            w = x.shape[d] // n
            return x.narrow(d, s * w, w).to(dev).contiguous()
        return _select(tree, cut)

    return Sharded(full, [piece(s, dev) for s, dev in enumerate(mesh.devices)])


def shard_params(params: dict, mesh: Mesh) -> Sharded:
    """The serving param tree as per-shard trees (``serve_param_specs``)."""
    return shard_tree(params, serve_param_specs(params), mesh)


def shard_cache(cache: dict, mesh: Mesh) -> Sharded:
    """A serving cache (paged pool or rings) as per-shard caches
    (``serve_cache_specs``)."""
    return shard_tree(cache, serve_cache_specs(cache), mesh)


# ---------------------------------------------------------------- constants
# The dry run's roofline terms (``launch/dryrun.roofline``) per H100, from
# data sheets, not measured:
PEAK_FLOPS = 989e12    # dense bf16 tensor-core FLOP/s, H100 SXM5 (NVIDIA H100 data sheet)
HBM_BW = 3.35e12       # HBM3 bytes/s, H100 SXM5 (NVIDIA H100 data sheet)
ICI_BW = 50e9          # intra-pod bytes/s per GPU: NDR InfiniBand, 400 Gb/s per GPU
#                        (one ConnectX-7 port per GPU, NVIDIA DGX H100 data sheet)
DCN_BW = Link.bandwidth  # cross-pod bytes/s: the cross-cloud WAN of core/protocols.Link
#                          (1.25e9: a 10 Gbit/s leased line)
