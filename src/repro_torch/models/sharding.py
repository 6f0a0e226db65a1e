"""Tensor-parallel attention for serving: the active tensor axis and the
head gather (the reference's ``models/sharding.py``, its serving half).

The reference traces the model inside ``shard_map`` with the attention heads
split over the mesh's ``model`` axis, and ``gather_heads`` all-gathers each
shard's head slice of the pre-``wo`` activation. The port drives every shard
from one process: under an active axis (``use_tensor_axis``) the serving
forwards receive ``params`` and ``cache`` as ``Sharded`` trees
(``launch/mesh.shard_params``, ``shard_cache``): one tree of the replicated
leaves on the first shard's device, beside per-shard trees that hold only
the split leaves (the ``wq``/``wk``/``wv`` head slices, the cache's kv-head
slices). Each attention path runs its per-head work once per shard, on that
shard's slices and device (``map_shards``), and ``gather_heads`` joins the
slices in shard order along the feature dim on the first shard's device,
where the replicated ``wo`` and the rest of the model (embeddings, norms,
FFN, logits) run once on the replicated tree (``replica``). Per-head math
is independent of the other heads, so each slice is what the unsharded
forward computes for those heads wherever the projections' column slices
round as the full product's columns do. With no active axis every helper
is the identity on its single tree, so ``mesh=None`` forwards are
unchanged.

``ShardingRules`` and ``DEFAULT_RULES`` map the model's logical axis names
to the production meshes' axes; the dry run (``launch/dryrun.py``) picks and
reports them. The reference's ``constrain``, which pins an activation to
its rule, has no counterpart: it is a hint to XLA's partitioner, and the
port has none."""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class TensorAxis:
    """The axis attention heads split over: its name and each shard's
    device, in shard order."""
    name: str
    devices: tuple


@dataclasses.dataclass
class Sharded:
    """A tree split over a tensor axis: ``full`` holds every replicated leaf
    once, on the first shard's device; ``shards[s]`` holds only shard s's
    slices of the split leaves, on its device."""
    full: dict
    shards: list

    def map(self, fn, *args) -> "Sharded":
        """``fn(tree, *args)`` on the replicated tree and on every shard's."""
        return Sharded(fn(self.full, *args), [fn(t, *args) for t in self.shards])


def tensor_axis() -> TensorAxis | None:
    return getattr(_state, "tensor_axis", None)


@contextlib.contextmanager
def use_tensor_axis(axis: TensorAxis | None):
    """Activate ``axis`` for the serving forwards run inside the block
    (None: unsharded)."""
    prev = getattr(_state, "tensor_axis", None)
    _state.tensor_axis = axis
    try:
        yield
    finally:
        _state.tensor_axis = prev


def replica(tree):
    """The tree the replicated math reads and writes: the replicated leaves
    under an active axis, else ``tree`` itself."""
    return tree if tensor_axis() is None else tree.full


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def map_shards(fn, params, cache, *args, **kwargs):
    """``fn(params, cache, *args, **kwargs)``: once on the single trees with
    no active axis, else once per shard, with every tensor argument on that
    shard's device; returns the list of the shards' results. A shard's
    ``params`` are its split leaves (the per-head work reads only the
    projections' slices); its ``cache`` is its planes beside the replicated
    leaves (positions, the page table; copied only to a shard on another
    device)."""
    ax = tensor_axis()
    if ax is None:
        return fn(params, cache, *args, **kwargs)
    out = []
    for p, c, dev in zip(params.shards, cache.shards, ax.devices):
        view = {**{k: _to(v, dev) for k, v in cache.full.items()}, **c}
        out.append(fn(p, view, *(_to(a, dev) for a in args),
                      **{k: _to(v, dev) for k, v in kwargs.items()}))
    return out


def gather_heads(x):
    """The per-shard head slices (..., H_local·hd), joined into the full
    (..., H·hd) in shard order along the feature dim on the first shard's
    device; the identity with no active axis."""
    ax = tensor_axis()
    if ax is None:
        return x
    dev = ax.devices[0]
    return torch.cat([t.to(dev) for t in x], dim=-1)


class ShardingRules:
    """A logical → physical axis map over a mesh: ``spec(*logical)`` is the
    partition spec (one mesh axis, tuple of axes or None per name)."""

    def __init__(self, mesh, logical_to_physical: dict):
        self.mesh = mesh
        self.map = dict(logical_to_physical)

    def spec(self, *logical_axes: str | None) -> tuple:
        return tuple(None if ax is None else self.map.get(ax) for ax in logical_axes)


# The production meshes' default mapping; "batch" is the data axis only (the
# pod axis is the federated step's own, outside the per-cloud step).
DEFAULT_RULES = {
    "batch": "data",
    "seq": None,
    "cache_seq": "data",     # decode: long caches split over the data axis
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "lru": "model",
    "inner": "model",
}
