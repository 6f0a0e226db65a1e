"""Meshes of the port, and the sharding of a served model over one (the
reference's ``launch/mesh.py``: its serving half and its pod helpers).

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
slice is a contiguous copy on its shard's device."""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.models.sharding import Sharded

POD_AXIS = "pod"
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
    return int(dict(mesh.shape).get(name, 1))


def _leaf_items(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, paths joined by "/"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    return fn(prefix, tree)


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
