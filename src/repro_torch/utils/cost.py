"""Counted cost of one step of the port: FLOPs, HBM bytes, temporaries and
collectives per device (the counterpart of the reference's
``utils/hlo.py``, which reads them from a compiled module's text).

The port compiles nothing, so ``count_step`` runs the step itself under a
counting ``TorchDispatchMode`` (on meta tensors for the dry run, or on real
tensors) and reads every dispatched op:

* **FLOPs**: ``torch.utils.flop_counter``'s formulas (mm, addmm, bmm,
  baddbmm, convolution, SDPA): 2·out·K for every dot the plain formulation
  computes, causal scores included in full, the reference's convention.
* **HBM bytes**: the eager port fuses nothing, so every dispatched op reads
  its operands and writes its outputs: Σ (operand + output bytes). Ops that
  only alias storage (views, ``expand``, ``permute``, ``select``, ...; the
  reference's ``NO_COPY_OPS``) count 0; an in-place scatter or a copy into a
  view counts the region written, read and written (the reference's
  dynamic-update-slice rule); dtype casts count, since the port launches
  them.
* **The hand-written kernels** (``kernels/ops.py``'s entry points, marked
  with ``kernel_unit``) are invisible to the dispatcher on the card, so each
  call counts as one unit: the FLOPs of its plain version's dots, and its
  own bytes, each input read once and each output written once. The aten
  ops a plain version dispatches inside the unit are not counted again:
  the counterpart of a fusion boundary.
* **temp_bytes**: the peak of live bytes in tensors made inside the step, on
  top of its arguments (a finalizer on each new storage).
* **Per device**: the arguments' partition specs (``launch/mesh.py``'s)
  seed a placement per tensor (the mesh axes each dimension splits over;
  the slice of an axis a per-cloud tensor lives on; a partial sum pending
  over an axis), which every op propagates: elementwise ops keep it, a
  matmul's output takes its operands' free dimensions, reshapes carry the
  split with the dimension it was on. A contraction or reduction over a
  split dimension, and a lookup into a split table, leave partial sums: an
  all-reduce of the output's local bytes over those axes. Adding per-cloud
  tensors of different clouds is the cross-pod sum (one all-reduce when
  the sum is read). Outputs that leave the step split where their
  ``out_specs`` replicate them are all-gathered. Each op's FLOPs and bytes
  are divided by the product of the axis sizes that split it.
* **Loops** (``scan_range``): over meta tensors, a loop whose steps from
  the second on do the same work (a sequence walked token by token,
  clouds, query chunks, microbatches) runs its first two steps, the
  second counted n - 1 times, as ``hlo.py`` multiplies a while body by its
  trip count; the second sees what a step like it leaves bound, as every
  later step does. What a walked step leaves alive for the loop's end
  (``fill_steps``: the per-step results a stack or a concatenation reads)
  stands for the steps not walked: their bytes are live until that list
  is dropped, and on top of the last walked step's peak, as the last real
  step runs beside its predecessors' results. A loop whose backward
  autograd runs later is walked whole.
* **Coverage**: an op with no placement rule of its own is placed as an
  elementwise op only where it is one (``torch.Tag.pointwise``, or its
  output broadcasts from its inputs); one that is neither, with a split
  input, is recorded in ``StepCost.unruled`` (the dry run fails on it)
  rather than quietly left unsplit.

Collectives keep the reference's fields, its ring link bytes per kind and
its cross-pod rule (a replica group that spans a pod boundary)."""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# ------------------------------------------------------------- collectives
@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective (the reference's ``hlo.CollectiveOp``): its operand
    and output bytes per device, its replica groups' size and number,
    whether a group spans pods, and how many times the step runs it."""
    kind: str
    operand_bytes: int
    output_bytes: int
    group_size: int
    num_groups: int
    cross_pod: bool
    count: float = 1.0

    @property
    def link_bytes_per_device(self) -> float:
        """Ring algorithm: (g-1)/g of the output (all-gather), twice that of
        the operand (all-reduce), (g-1)/g of the operand (reduce-scatter,
        all-to-all), the operand (collective-permute); × count."""
        g = max(self.group_size, 1)
        frac = (g - 1) / g
        if self.kind == "all-gather":
            per = frac * self.output_bytes
        elif self.kind == "all-reduce":
            per = 2.0 * frac * self.operand_bytes
        elif self.kind in ("reduce-scatter", "all-to-all"):
            per = frac * self.operand_bytes
        else:  # collective-permute
            per = float(self.operand_bytes)
        return per * self.count


def groups_cross_pod(groups, pod_size: int) -> bool:
    """Whether any replica group holds devices of two pods (device id //
    ``pod_size`` differs); False without pods."""
    if not groups or pod_size <= 0:
        return False
    return any(len({d // pod_size for d in grp}) > 1 for grp in groups)


def replica_groups(mesh_shape: dict, axes) -> list:
    """The replica groups of a collective over ``axes`` of a mesh whose
    devices are numbered row-major over ``mesh_shape`` (name → size): the
    devices that differ only in those axes' coordinates."""
    names = list(mesh_shape)
    sizes = [int(mesh_shape[n]) for n in names]
    ids = np.arange(math.prod(sizes)).reshape(sizes)
    over = [names.index(a) for a in axes]
    keep = [i for i in range(len(names)) if i not in over]
    g = math.prod(sizes[i] for i in over)
    return ids.transpose(keep + over).reshape(-1, g).tolist()


@dataclasses.dataclass
class StepCost:
    """What one step costs a device: FLOPs, HBM bytes, the peak of its
    temporaries and its collectives (the reference's ``HloCost``)."""
    flops: float = 0
    hbm_bytes: float = 0
    temp_bytes: float = 0
    coll: dict = dataclasses.field(default_factory=dict)   # CollectiveOp(count=1) → count
    unruled: dict = dataclasses.field(default_factory=dict)   # op name → calls with no rule

    @property
    def collectives(self) -> list:
        return [dataclasses.replace(op, count=n) for op, n in self.coll.items() if n]

    def link_bytes(self, cross_pod: bool | None = None) -> float:
        return sum(c.link_bytes_per_device for c in self.collectives
                   if cross_pod is None or c.cross_pod == cross_pod)

    def by_kind(self) -> dict:
        out: dict = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0.0) + c.link_bytes_per_device
        return out

    def n_collectives(self) -> float:
        return sum(c.count for c in self.collectives)


# --------------------------------------------------------------- placements
# A placement: per dimension a tuple of factors (size, axes) from outermost
# to innermost ("()" for a dimension no axis splits), the (axis, index)
# slices a per-cloud tensor lives on, and the axes a partial sum is
# pending over.
@dataclasses.dataclass(frozen=True)
class Placement:
    dims: tuple
    owner: tuple = ()
    partial: tuple = ()

    @functools.cached_property
    def axes(self) -> tuple:
        """The axes that split the tensor, each once: its dims' and the
        axes of its cloud slices."""
        return tuple(dict.fromkeys([a for d in self.dims for _, ax in d for a in ax]
                                   + [a for a, _ in self.owner]))

    @functools.cached_property
    def dim_axes(self) -> tuple:
        """The axes of its dims, in dim order."""
        return tuple(a for d in self.dims for _, ax in d for a in ax)


@functools.lru_cache(maxsize=None)
def _replicated(ndim: int) -> Placement:
    return Placement(((),) * ndim)


def _dim_axes(d) -> tuple:
    return tuple(a for _, axes in d for a in axes)


@dataclasses.dataclass(frozen=True)
class Owned:
    """A spec leaf of a per-cloud tensor: it lives on slice ``index`` of mesh
    axis ``axis`` (cloud ``index``'s pod) and splits as ``spec`` there."""
    axis: str
    index: int
    spec: tuple


def owned_tree(specs, axis: str, index: int):
    """``specs`` (a tree of partition specs) with every leaf ``Owned``."""
    if isinstance(specs, dict):
        return {k: owned_tree(v, axis, index) for k, v in specs.items()}
    if isinstance(specs, list):
        return [owned_tree(v, axis, index) for v in specs]
    return Owned(axis, index, specs)


# ------------------------------------------------------------ active counter
_ACTIVE: list = []     # the counters of the steps being counted, innermost last


def _active():
    return _ACTIVE[-1] if _ACTIVE else None


def kernel_unit(fn=None, *, inplace_bytes=None):
    """Mark a kernel entry point: under an active counter the call counts as
    one unit (its plain version's dot FLOPs, its own bytes), and the ops it
    dispatches inside are not counted again. ``inplace_bytes(*args,
    **kwargs)``: the bytes it writes in place into arguments it does not
    return (a pool write), counted beside its inputs and outputs."""
    if fn is None:
        return functools.partial(kernel_unit, inplace_bytes=inplace_bytes)

    @functools.wraps(fn)
    def unit(*args, **kwargs):
        c = _active()
        if c is None or c.inside:
            return fn(*args, **kwargs)
        return c.unit(fn, args, kwargs, inplace_bytes)
    return unit


def scan_range(n: int, like: torch.Tensor | None = None, reverse: bool = False):
    """The steps of a loop whose steps from the second on do the same work
    (a sequence's tokens, clouds, query chunks, microbatches that add into
    the first one's sum): ``range(n)`` (reversed with ``reverse``), or,
    under a counter over meta tensors (``like`` on the meta device), the
    first two steps, the second counted n - 1 times. The first starts the
    carries and sums that the second replaces, and the second runs beside
    what the first left bound, as each later real step runs beside what its
    predecessor left: the loop's body must hold nothing of a step into the
    next but its carries. A loop autograd records (``like`` requires grad
    under grad mode) is walked whole: its backward runs after it, beyond
    the multiplier. ``fill_steps`` then stands the last walked step's
    results in for the steps not walked."""
    c = _active()
    recorded = like is not None and like.requires_grad and torch.is_grad_enabled()
    if c is None or like is None or not like.is_meta or n <= 2 or recorded:
        yield from (range(n - 1, -1, -1) if reverse else range(n))
        return
    for j, times in enumerate((1, n - 1)):
        c.mult *= times
        outer_peak, c.cost.temp_bytes = c.cost.temp_bytes, c.live
        try:
            yield n - 1 - j if reverse else j
        finally:
            c.mult //= times
            c.pass_peak = c.cost.temp_bytes
            c.cost.temp_bytes = max(outer_peak, c.pass_peak)


class _Steps(list):
    """A loop's per-step results with the steps ``scan_range`` did not walk
    filled in (a list that can carry a finalizer)."""


def fill_steps(items: list, n: int) -> list:
    """A loop's per-step results, n of them: as they are, or, where
    ``scan_range`` walked fewer steps, the last walked step's results in
    place of the others. Their bytes count as live, once for each step not
    walked, until the returned list is dropped, and on top of the peak of
    the last walked step, which the last real step reaches beside its
    predecessors' results."""
    missing = n - len(items)
    c = _active()
    if missing <= 0 or c is None:
        return items
    out = _Steps(items[:-1] + [items[-1]] * (missing + 1))
    seen, extra = set(), 0.0
    for t in _tensors(tree_items(items[-1])):
        c.filled[id(t)] = weakref.ref(t)
        try:
            s = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            continue
        if s not in seen and c.tracked.get(s):
            seen.add(s)
            extra += missing * c.local(t)
    if extra:
        c.cost.temp_bytes = max(c.cost.temp_bytes, c.pass_peak + extra)
        c.live += extra
        c.cost.temp_bytes = max(c.cost.temp_bytes, c.live)
        weakref.finalize(out, c.release, extra)
    return out


def tree_items(x) -> list:
    """The leaves of a step's result (a tensor, or dicts, lists and tuples
    of them)."""
    if isinstance(x, dict):
        return [y for v in x.values() for y in tree_items(v)]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in tree_items(v)]
    return [x]


# ------------------------------------------------------------------ op rules
_VIEW = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "expand_as", "permute",
    "transpose", "t", "slice", "select", "unsqueeze", "squeeze", "detach", "alias",
    "as_strided", "split", "split_with_sizes", "chunk", "unbind", "narrow", "view_as",
    "lift_fresh", "diagonal", "movedim", "numpy_T", "real", "view_as_real", "view_as_complex",
    "_neg_view", "_conj", "resolve_conj", "resolve_neg", "unfold", "unsqueeze_", "squeeze_",
    "transpose_", "t_", "as_strided_", "_local_scalar_dense",
}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "logsumexp",
           "prod", "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm", "any",
           "all", "count_nonzero", "aminmax", "nansum"}
_ALONG = {"_softmax", "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
          "cumsum", "cumprod", "logcumsumexp", "sort", "topk", "argsort", "cummax", "cummin",
          "kthvalue"}
_GATHER = {"index", "gather", "index_select", "embedding", "_unsafe_index", "take_along_dim"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "_unsafe_index_put", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "index_add", "index_add_",
            "index_copy", "index_copy_", "masked_scatter", "masked_scatter_",
            "scatter_reduce", "scatter_reduce_", "index_fill", "index_fill_",
            "embedding_dense_backward"}
_ACCUMULATE = {"scatter_add", "scatter_add_", "index_add", "index_add_", "scatter_reduce",
               "scatter_reduce_", "embedding_dense_backward"}
_EMPTY = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
          "empty_permuted"}
_FACTORY = {"zeros", "ones", "full", "arange", "scalar_tensor", "rand", "randn", "randint",
            "normal", "eye", "linspace", "logspace", "_efficientzerotensor", "tensor",
            "randperm", "bernoulli"}
_LIKE = {"zeros_like", "ones_like", "full_like", "rand_like", "randn_like", "randint_like",
         "new_zeros", "new_ones", "new_full"}
_LINEAR = {"add", "add_", "sub", "sub_"}
# ops whose rule reads or writes the counter's state beyond their inputs'
# placements (a gather's source, a loop's filled results)
_STATEFUL = _GATHER | _EMPTY | _FACTORY | _LIKE | {"cat", "stack"}
# elementwise ops without the pointwise tag
_ELEMENTWISE = {"masked_fill", "masked_fill_", "log_sigmoid_forward", "log_sigmoid_backward",
                "softplus_backward"}


def _tensors(args) -> list:
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _share(n, split: int):
    """One device's share of a count split ``split`` ways (an int where it
    divides, so that counts stay exact)."""
    return n // split if n % split == 0 else n / split


def _norm_dims(dims, ndim: int) -> list:
    if dims is None:
        return list(range(ndim))
    if isinstance(dims, int):
        dims = [dims]
    return sorted({d % ndim for d in dims}) if ndim else []


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def _signature(func, args, kwargs):
    """A hashable key of an op over meta tensors (None where an argument is
    not a meta tensor or a plain value)."""
    def sig(x):
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                raise TypeError
            return ("T", tuple(x.shape), x.stride(), x.dtype)
        if isinstance(x, (list, tuple)):
            return tuple(sig(v) for v in x)
        if isinstance(x, _SCALARS):
            return x
        raise TypeError

    try:
        return func, sig(args), tuple((k, sig(v)) for k, v in sorted(kwargs.items()))
    except TypeError:
        return None


def _describe(out, in_storages: set):
    """What ``_fresh`` rebuilds ``out`` from: each tensor's shape, stride
    and dtype, plain values as they are; None where an output is not a
    meta tensor, aliases an input or does not own its whole storage."""
    if isinstance(out, torch.Tensor):
        if not out.is_meta:
            return None
        s = out.untyped_storage()
        if s._cdata in in_storages or out.storage_offset() or \
                s.nbytes() != _span(out) * out.element_size():
            return None
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        parts = [_describe(v, in_storages) for v in out]
        if any(p is None for p in parts):
            return None
        return (type(out), tuple(parts))
    if isinstance(out, (int, float, bool, type(None))):
        return ("V", out)
    return None


def _span(t: torch.Tensor) -> int:
    if t.numel() == 0:
        return 0
    return 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))


def _fresh(desc):
    if desc[0] == "T":
        return torch.empty_strided(desc[1], desc[2], dtype=desc[3], device="meta")
    if desc[0] == "V":
        return desc[1]
    return desc[0](_fresh(d) for d in desc[1])


class _Counter(TorchDispatchMode):
    """The dispatch mode ``count_step`` runs a step under."""

    def __init__(self, mesh_shape: dict):
        super().__init__()
        self.sizes = {k: int(v) for k, v in mesh_shape.items()}
        self.n_dev = math.prod(self.sizes.values()) if self.sizes else 1
        pods = self.sizes.get("pod", 0)
        self.pod_size = self.n_dev // pods if pods else 0
        self.cost = StepCost()
        self.mult = 1          # token-loop multiplier (scan_range)
        self.inside = False    # inside a kernel unit: count allocations only
        self.unit_flops = 0
        self.shadow = False    # running a plain version on meta for a unit's FLOPs
        self.place: dict = {}
        self.keys: dict = {}   # storage → its placement keys
        self.tracked: dict = {}   # storage of a temporary → its bytes a device
        self.live = 0
        self.pass_peak = 0     # the peak of the last loop step walked (scan_range)
        self.filled: dict = {}   # id → weak reference of a result standing for steps not walked
        self._unit_cache: dict = {}
        self._groups: dict = {}
        self._splits: dict = {}
        self._gathered: dict = {}   # (shape, dtype) of a split gather source → its dims
        self._memo: dict = {}       # an op's signature → its outputs' (shape, stride, dtype)
        self._no_memo: set = set()  # views and in-place ops: always run
        self._rules: dict = {}      # (signature, input placements) → what the op counts
        self._record = None         # the collectives of the op being counted
        self._alive = True

    # ------------------------------------------------------------ placements
    @staticmethod
    def _key(t: torch.Tensor):
        s = t.untyped_storage()
        return s._cdata, t.storage_offset(), tuple(t.shape), tuple(t.stride())

    def get(self, t: torch.Tensor) -> Placement:
        try:
            return self.place.get(self._key(t)) or _replicated(t.ndim)
        except (RuntimeError, NotImplementedError):
            return _replicated(t.ndim)

    def _split(self, pl: Placement) -> int:
        n = self._splits.get(pl.axes)
        if n is None:
            n = self._splits[pl.axes] = math.prod(self.sizes.get(a, 1) for a in pl.axes)
        return n

    def local(self, t: torch.Tensor, pl: Placement | None = None) -> float:
        pl = pl or self.get(t)
        return t.numel() * t.element_size() / self._split(pl)

    def set(self, t: torch.Tensor, pl: Placement, *, track: bool = True):
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = (s._cdata, t.storage_offset(), tuple(t.shape), tuple(t.stride()))
        self.place[key] = pl
        if s._cdata not in self.keys:
            self.keys[s._cdata] = {key}
            if track:
                nbytes = s.nbytes() / self._split(pl)
                self.tracked[s._cdata] = nbytes
                self.live += nbytes
                self.cost.temp_bytes = max(self.cost.temp_bytes, self.live)
            else:
                nbytes = 0
            weakref.finalize(s, self._free, s._cdata, nbytes)
        else:
            self.keys[s._cdata].add(key)

    def _free(self, cdata, nbytes):
        for k in self.keys.pop(cdata, ()):
            self.place.pop(k, None)
        self.tracked.pop(cdata, None)
        self.live -= nbytes

    def release(self, nbytes):
        self.live -= nbytes

    def seed(self, t: torch.Tensor, spec):
        """Place an argument by its partition spec (not a temporary)."""
        owner = ()
        if isinstance(spec, Owned):
            owner, spec = ((spec.axis, spec.index),), spec.spec
        dims = []
        for i, n in enumerate(t.shape):
            ax = spec[i] if spec is not None and i < len(spec) else None
            ax = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
            ax = tuple(a for a in ax if self.sizes.get(a, 1) > 1)
            dims.append(((int(n), ax),) if ax else ())
        self.set(t, Placement(tuple(dims), owner), track=False)

    # ----------------------------------------------------------- collectives
    def collective(self, kind: str, axes, nbytes: float, out_bytes: float | None = None):
        axes = tuple(dict.fromkeys(a for a in axes if self.sizes.get(a, 1) > 1))
        if not axes or nbytes <= 0:
            return
        if axes not in self._groups:
            groups = replica_groups(self.sizes, axes)
            self._groups[axes] = (len(groups[0]), len(groups),
                                  groups_cross_pod(groups, self.pod_size))
        op = CollectiveOp(kind, int(round(nbytes)), int(round(out_bytes or nbytes)),
                          *self._groups[axes], 1.0)
        self.cost.coll[op] = self.cost.coll.get(op, 0) + self.mult
        if self._record is not None:
            self._record.append(op)

    def settle(self, t: torch.Tensor, pl: Placement) -> Placement:
        """A pending partial sum read by an op that is not a sum: its
        all-reduce, once."""
        if not pl.partial:
            return pl
        done = Placement(pl.dims, pl.owner)
        self.collective("all-reduce", pl.partial, self.local(t, done))
        self.set(t, done, track=False)
        return done

    # ---------------------------------------------------------------- units
    def unit(self, fn, args, kwargs, inplace_bytes=None):
        tensors = _tensors(list(args) + list(kwargs.values()))
        pls = [self.settle(t, self.get(t)) for t in tensors]
        lead = pls[0] if pls else Placement(())
        split = self._split(lead)
        on_card = any(t.is_cuda for t in tensors)
        self.inside, self.unit_flops = True, 0
        try:
            out = fn(*args, **kwargs)
        finally:
            self.inside = False
        flops = self._shadow_flops(fn, args, kwargs) if on_card else self.unit_flops
        outs = _tensors(out if isinstance(out, (list, tuple)) else [out])
        nbytes = sum(self.local(t, p) for t, p in zip(tensors, pls))
        for t in outs:
            if pls and t.shape == tensors[0].shape:
                pl = lead
            elif t.ndim == 0:
                pl = Placement((), lead.owner)
                self.collective("all-reduce", lead.dim_axes,
                                t.element_size())
            else:
                ax = lead.dim_axes
                first = ((int(t.shape[0]), ax),) if ax and t.shape[0] % split == 0 else ()
                pl = Placement((first,) + ((),) * (t.ndim - 1), lead.owner)
            self.set(t, pl)
            nbytes += self.local(t, pl)
        if inplace_bytes is not None:
            nbytes += inplace_bytes(*args, **kwargs) / split
        self.cost.flops += self.mult * _share(flops, split)
        self.cost.hbm_bytes += self.mult * nbytes
        return out

    def _shadow_flops(self, fn, args, kwargs) -> float:
        """The FLOPs of ``fn``'s plain version at these arguments' shapes
        (run on meta copies), cached by shapes."""
        def meta(x):
            if isinstance(x, torch.Tensor):
                return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
            if isinstance(x, dict):
                return {k: meta(v) for k, v in x.items()}
            return x

        def sig(x):
            if isinstance(x, torch.Tensor):
                return ("T", tuple(x.shape), x.dtype)
            if isinstance(x, dict):
                return tuple((k, sig(v)) for k, v in sorted(x.items()))
            return repr(x)

        key = (fn.__name__, tuple(sig(a) for a in args),
               tuple((k, sig(v)) for k, v in sorted(kwargs.items())))
        if key not in self._unit_cache:
            self.inside, self.shadow, self.unit_flops = True, True, 0
            try:
                fn(*[meta(a) for a in args], **{k: meta(v) for k, v in kwargs.items()})
            finally:
                self.inside = self.shadow = False
            self._unit_cache[key] = self.unit_flops
        return self._unit_cache[key]

    # ------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _signature(func, args, kwargs)
        out = self._call(func, args, kwargs, key)
        if not self._alive:
            return out
        packet = func.overloadpacket
        if self.inside:   # a kernel's plain version: its dots' FLOPs only
            if packet in flop_registry:
                self.unit_flops += flop_registry[packet](*args, **kwargs, out_val=out)
            return out
        name = packet.__name__
        ins = _tensors(list(args) + list(kwargs.values()))
        pls = [self.get(t) for t in ins]
        if name not in _VIEW and (name not in _LINEAR or not self._sums(pls)):
            pls = [self.settle(t, p) for t, p in zip(ins, pls)]
        outs = _tensors(out if isinstance(out, (list, tuple)) else [out])
        # an op's count is a function of its signature and its inputs'
        # placements, but for the rules that read or write the counter's
        # memory of gathers and filled loop results
        rkey = None if key is None or name in _STATEFUL else (key, tuple(pls))
        got = self._rules.get(rkey) if rkey is not None else None
        if got is None:
            self._record = []
            out_pls, split = self.rule(func, name, args, kwargs, ins, pls, outs)
            flops = (_share(flop_registry[packet](*args, **kwargs, out_val=out), split)
                     if packet in flop_registry else 0)
            got = (out_pls, flops, self.bytes(name, ins, pls, outs, out_pls), self._record)
            self._record = None
            if rkey is not None:
                self._rules[rkey] = got
        else:
            for op in got[3]:   # its collectives and unruled calls, as the rule made them
                if isinstance(op, str):
                    self.cost.unruled[op] = self.cost.unruled.get(op, 0) + 1
                else:
                    self.cost.coll[op] = self.cost.coll.get(op, 0) + self.mult
        out_pls, flops, nbytes, _ = got
        self.cost.flops += self.mult * flops
        self.cost.hbm_bytes += self.mult * nbytes
        inplace = bool(outs) and bool(ins) and outs[0] is ins[0]
        for t, pl in zip(outs, out_pls):
            self.set(t, pl, track=not inplace)
        return out

    def _call(self, func, args, kwargs, key):
        """``func(*args, **kwargs)``; over meta tensors (``key``, the op's
        signature: its inputs' shapes, strides and dtypes and its other
        arguments), an op that makes fresh outputs is run once per signature
        and answered after that with fresh outputs of the shapes it gave: a
        deep stack repeats the same ops, and torch's meta functions cost far
        more than the count."""
        if key is None or func in self._no_memo:
            return func(*args, **kwargs)
        got = self._memo.get(key)
        if got is not None:
            return _fresh(got)
        out = func(*args, **kwargs)
        if getattr(func, "is_view", False) or func._schema.is_mutable:
            self._no_memo.add(func)
            return out
        desc = _describe(out, {t.untyped_storage()._cdata for t in _tensors(args)})
        if desc is not None:
            self._memo[key] = desc
        return out

    def bytes(self, name, ins, pls, outs, out_pls) -> float:
        if name in _VIEW or name in _EMPTY:
            return 0.0
        out_b = sum(self.local(t, p) for t, p in zip(outs, out_pls))
        if name in _FACTORY or name in _LIKE or name in ("fill_", "zero_"):
            return out_b
        if name == "copy_":
            return 2.0 * self.local(ins[0], pls[0])
        if name in _SCATTER and name.endswith("_"):
            region = sum(self.local(t, p) for t, p in zip(ins[1:], pls[1:])
                         if t.dtype.is_floating_point or t.dtype == ins[0].dtype)
            idx = sum(self.local(t, p) for t, p in zip(ins[1:], pls[1:])) - region
            return 2.0 * region + idx
        return sum(self.local(t, p) for t, p in zip(ins, pls)) + out_b

    # --------------------------------------------------------------- rules
    def _axes_size(self, axes) -> int:
        return math.prod(self.sizes.get(a, 1) for a in set(axes))

    def rule(self, func, name, args, kwargs, ins, pls, outs):
        """(each output's placement, the divisor of the op's FLOPs)."""
        owner, pending = self._owner(name, ins, pls, transfer=name not in ("cat", "stack"))
        if name in _MATMUL:
            return self._matmul(name, ins, pls, outs, owner)
        if name in _VIEW:
            return [self._view_out(name, args, ins[0], pls[0], t, i)
                    for i, t in enumerate(outs)], 1
        if name in _REDUCE:
            return self._reduce(name, args, kwargs, ins, pls, outs, owner), 1
        if name in _ALONG:
            return self._along(name, args, kwargs, ins, pls, outs, owner), 1
        if name in _GATHER:
            return self._gather(name, args, ins, pls, outs, owner), 1
        if name in _SCATTER:
            pl = Placement(pls[0].dims, owner)
            if name in _ACCUMULATE or (name in ("index_put", "index_put_", "_index_put_impl_")
                                       and len(args) > 3 and args[3]):
                other = [a for p in pls[1:] for a in p.dim_axes if a not in pl.dim_axes]
                self.collective("all-reduce", other, self.local(outs[0], pl))
            return [pl] * len(outs), 1
        if name in ("cat", "stack"):
            return [self._cat(name, args, ins, pls, outs[0], owner)], 1
        if name == "flip":   # a split dim reversed: each device's block to its mirror
            axes = [a for d in args[1] for a in _dim_axes(pls[0].dims[d % ins[0].ndim])]
            self.collective("collective-permute", axes, self.local(ins[0], pls[0]))
            return [Placement(pls[0].dims, owner)], 1
        if name in ("select_backward", "slice_backward"):   # the grad into its input's shape
            dims = list(pls[0].dims)
            if name == "select_backward":
                dims.insert(args[2] % len(args[1]), ())
            return [Placement(tuple(dims), owner)], 1
        if name in _LIKE or name in _EMPTY or name in _FACTORY or name in (
                "clone", "_to_copy", "copy_"):
            if ins and outs and outs[0].shape == ins[0].shape:
                return [Placement(pls[0].dims, owner)] * len(outs), 1
            if name not in ("clone", "_to_copy", "copy_"):   # the dims of self's sizes
                back = self._gathered.get((tuple(outs[0].shape), outs[0].dtype))
                if back is not None:   # a gather's backward: zeros shaped like its source
                    return [Placement(back, owner)], 1
                return [Placement(tuple(
                    pls[0].dims[j] if ins and t.ndim == ins[0].ndim
                    and t.shape[j] == ins[0].shape[j] else () for j in range(t.ndim)), owner)
                    for t in outs], 1
        pointwise = torch.Tag.pointwise in func.tags or name in _ELEMENTWISE
        split_in = any(p.dim_axes for p in pls)
        pls_out = []
        for t in outs:
            pl = self._broadcast(ins, pls, t.shape, owner, pending)
            if (pl is None or not pointwise) and split_in and t.numel():
                self.cost.unruled[name] = self.cost.unruled.get(name, 0) + 1
                self._record.append(name)
            pls_out.append(pl or Placement(((),) * t.ndim, owner))
        if name in ("_scaled_dot_product_flash_attention",
                    "_scaled_dot_product_efficient_attention", "convolution"):
            return pls_out, self._split(pls_out[0]) if pls_out else 1
        return pls_out, 1

    @staticmethod
    def _mixed(pls) -> set:
        owners: dict = {}
        mixed = set()
        for p in pls:
            for a, i in p.owner:
                if owners.setdefault(a, i) != i:
                    mixed.add(a)
        return mixed

    def _sums(self, pls) -> bool:
        """Whether a sum of these inputs stays a partial sum: every input
        holds a share (a partial sum, or one cloud's slice) of each axis
        pending."""
        pend = self._mixed(pls) | {a for p in pls for a in p.partial}
        return bool(pend) and all(a in p.partial or a in dict(p.owner)
                                  for p in pls for a in pend)

    def _owner(self, name, ins, pls, transfer: bool = True) -> tuple:
        """(the output's cloud slices, the axes its partial sum is pending
        over): different slices of one axis under a sum make a partial sum
        over it, under any other op but a concatenation a transfer of one
        operand."""
        owners = dict(a for p in pls for a in reversed(p.owner))
        mixed = self._mixed(pls)
        if name in _LINEAR and self._sums(pls):
            pend = tuple(sorted(mixed | {a for p in pls for a in p.partial}))
            return tuple((a, i) for a, i in sorted(owners.items()) if a not in pend), pend
        for a in mixed if transfer else ():
            t = next(t for t, p in zip(ins, pls) if a in dict(p.owner))
            self.collective("collective-permute", [a], self.local(t))
        return tuple(sorted(owners.items())), ()

    def _broadcast(self, ins, pls, shape, owner, pending=()) -> Placement | None:
        nd = len(shape)
        for t in ins:
            if t.ndim > nd or any(s not in (1, o) for s, o in zip(t.shape, shape[nd - t.ndim:])):
                return None
        dims = []
        for j in range(nd):
            choice = ()
            for t, p in zip(ins, pls):
                k = j - (nd - t.ndim)
                if k >= 0 and t.shape[k] == shape[j] and p.dims[k]:
                    choice = p.dims[k]
                    break
            dims.append(choice)
        return Placement(tuple(dims), owner, pending)

    def _matmul(self, name, ins, pls, outs, owner):
        if name in ("addmm", "baddbmm"):
            ins, pls = ins[1:], pls[1:]
        a, b = pls[0].dims, pls[1].dims
        if name in ("mm", "addmm"):
            dims = (a[0], b[1])
            contract = _dim_axes(a[1]) + _dim_axes(b[0])
        else:
            dims = (a[0] or b[0], a[1], b[2])
            contract = _dim_axes(a[2]) + _dim_axes(b[1])
        used = {x for d in dims for x in _dim_axes(d)}
        contract = [x for x in dict.fromkeys(contract) if x not in used]
        pl = Placement(dims, owner)
        # the partial products in the accumulator's fp32, rounded once after
        # the sum, as the unsplit product rounds
        self.collective("all-reduce", contract,
                        self.local(outs[0], pl) * max(1, 4 // outs[0].element_size()))
        axes = used | set(contract) | {x for x, _ in owner}
        return [pl], self._axes_size(axes)

    def _view_out(self, name, args, x, pl, t, i) -> Placement:
        dims = list(pl.dims)
        owner = pl.owner
        if name in ("permute", "movedim", "numpy_T"):
            if name == "permute":
                order = [d % x.ndim for d in args[1]]
            elif name == "numpy_T":
                order = list(range(x.ndim))[::-1]
            else:
                src = [args[1]] if isinstance(args[1], int) else list(args[1])
                dst = [args[2]] if isinstance(args[2], int) else list(args[2])
                src, dst = [s % x.ndim for s in src], [d % x.ndim for d in dst]
                rest = [d for d in range(x.ndim) if d not in src]
                order = [None] * x.ndim
                for s, d in zip(src, dst):
                    order[d] = s
                it = iter(rest)
                order = [o if o is not None else next(it) for o in order]
            return Placement(tuple(dims[o] for o in order), owner, pl.partial)
        if name in ("transpose", "transpose_", "t", "t_"):
            if x.ndim < 2:
                return pl
            d0, d1 = (0, 1) if name in ("t", "t_") else (args[1] % x.ndim, args[2] % x.ndim)
            dims[d0], dims[d1] = dims[d1], dims[d0]
            return Placement(tuple(dims), owner, pl.partial)
        if name in ("select", "unbind"):
            d = (args[1] if len(args) > 1 else 0) % x.ndim
            idx = args[2] if name == "select" else i
            axes = _dim_axes(dims[d])
            if axes:
                per = x.shape[d] // max(self._axes_size(axes), 1)
                owner = tuple(sorted(set(owner) | {(axes[0], int(idx) // max(per, 1))}))
            del dims[d]
            return Placement(tuple(dims), owner, pl.partial)
        if name in ("slice", "narrow", "split", "split_with_sizes", "chunk", "detach", "alias",
                    "lift_fresh", "_neg_view", "_conj", "resolve_conj", "resolve_neg",
                    "as_strided", "as_strided_") and t.ndim == x.ndim:
            return pl if t.shape == x.shape else Placement(
                tuple(d if t.shape[j] == x.shape[j] else (d if _dim_axes(d) else ())
                      for j, d in enumerate(dims)), owner, pl.partial)
        if name in ("expand", "expand_as"):
            lead = t.ndim - x.ndim
            return Placement(((),) * lead + tuple(
                d if x.shape[j] == t.shape[lead + j] else () for j, d in enumerate(dims)),
                owner, pl.partial)
        if name == "_local_scalar_dense":
            return pl
        carved = self._carve(pl, tuple(x.shape), tuple(t.shape))
        if carved is None:   # a reshape that moves a split: the output unsplit
            return Placement(((),) * t.ndim, owner)
        return Placement(carved, owner, pl.partial)

    def _carve(self, pl, in_shape, out_shape):
        """A reshape's output dims: the input's factors, in order, cut to
        the output's sizes (a factor split in two keeps its axes on the
        outer piece where they divide it)."""
        flat = []
        for d, n in zip(pl.dims, in_shape):
            flat += [f for f in (d or ((n, ()),)) if f[0] != 1]
        out, i, cur = [], 0, None
        for n in out_shape:
            if n == 1:
                out.append(())
                continue
            got, acc = [], 1
            while acc < n:
                if cur is None:
                    if i >= len(flat):
                        return None
                    cur, i = flat[i], i + 1
                size, axes = cur
                need = n // acc
                if n % acc:
                    return None
                if size <= need:
                    if need % size:
                        return None
                    got.append(cur)
                    acc *= size
                    cur = None
                else:
                    if size % need:
                        return None
                    k = self._axes_size(axes)
                    if axes and need % k and (size // need) % k == 0:
                        got.append((need, ()))
                        cur = (size // need, axes)
                    else:
                        got.append((need, axes))
                        cur = (size // need, ())
                    acc *= need
            out.append(tuple(got) if any(ax for _, ax in got) else ())
        if cur is not None and cur[1] or any(f[1] for f in flat[i:]):
            return None
        return tuple(out)

    def _reduce(self, name, args, kwargs, ins, pls, outs, owner):
        x, pl = ins[0], pls[0]
        at = 2 if name in ("norm", "linalg_vector_norm") else 1
        dims = args[at] if len(args) > at else kwargs.get("dim")
        if isinstance(dims, torch.Tensor) or (dims is not None and not isinstance(
                dims, (int, list, tuple))):
            dims = None
        red = _norm_dims(dims, x.ndim)
        keep = [d for d in range(x.ndim) if d not in red]
        axes = [a for d in red for a in _dim_axes(pl.dims[d])]
        res = []
        for t in outs:
            if t.ndim == len(keep):
                pl_t = Placement(tuple(pl.dims[d] for d in keep), owner)
            elif t.ndim == x.ndim:
                pl_t = Placement(tuple(() if d in red else pl.dims[d] for d in range(x.ndim)),
                                 owner)
            else:
                pl_t = Placement(((),) * t.ndim, owner)
            res.append(pl_t)
        if outs:
            self.collective("all-reduce", axes, self.local(outs[0], res[0]))
        return res

    def _along(self, name, args, kwargs, ins, pls, outs, owner):
        x, pl = ins[0], pls[0]
        d = args[1] if len(args) > 1 and isinstance(args[1], int) else kwargs.get("dim", -1)
        if name in ("topk", "kthvalue"):
            d = args[2] if len(args) > 2 else kwargs.get("dim", -1)
        d = d % max(x.ndim, 1) if x.ndim else 0
        res = []
        for t in outs:
            if t.ndim == x.ndim:
                dims = tuple(pl.dims[j] if t.shape[j] == x.shape[j] else ()
                             for j in range(x.ndim))
            else:
                dims = ((),) * t.ndim
            res.append(Placement(dims, owner))
        if x.ndim and _dim_axes(pl.dims[d]) and outs:
            self.collective("all-reduce", _dim_axes(pl.dims[d]),
                            self.local(outs[0], res[0]) / max(x.shape[d], 1)
                            * self._axes_size(_dim_axes(pl.dims[d])))
        return res

    def _gather(self, name, args, ins, pls, outs, owner):
        x, pl, t = ins[0], pls[0], outs[0]
        if name in ("index", "_unsafe_index"):
            idx = list(args[1])
            pos = [j for j, v in enumerate(idx) if v is not None]
            ip = [self.get(v) for v in idx if v is not None]
            ishape = torch.broadcast_shapes(*[tuple(v.shape) for v in idx if v is not None])
            it = [v for v in idx if v is not None]
            bp = self._broadcast(it, ip, ishape, ()) or _replicated(len(ishape))
            rest_before = list(pl.dims[:pos[0]])
            rest_after = list(pl.dims[pos[-1] + 1:])
            if pos == list(range(pos[0], pos[-1] + 1)):
                dims = rest_before + list(bp.dims) + rest_after
            else:
                dims = list(bp.dims) + [pl.dims[j] for j in range(x.ndim) if j not in pos]
            looked = [a for j in pos for a in _dim_axes(pl.dims[j])]
        elif name == "embedding":
            dims = list(pls[1].dims) + [pl.dims[1]]
            looked = _dim_axes(pl.dims[0])
        else:
            d = args[1] % x.ndim
            ipl = pls[1]
            if name == "index_select":
                dims = list(pl.dims)
                dims[d] = ipl.dims[0] if ipl.dims else ()
            else:
                dims = [ipl.dims[j] or (pl.dims[j] if x.shape[j] == t.shape[j] else ())
                        for j in range(t.ndim)]
            looked = _dim_axes(pl.dims[d])
        if len(dims) != t.ndim:
            dims = [()] * t.ndim
        if looked:
            self._gathered[(tuple(x.shape), x.dtype)] = pl.dims
        own = tuple(sorted(set(owner)))
        out = Placement(tuple(dims), own)
        self.collective("all-reduce", looked, self.local(t, out))
        return [out] + [Placement(((),) * o.ndim, own) for o in outs[1:]]

    def _cat(self, name, args, ins, pls, t, owner):
        d = args[1] if len(args) > 1 else 0
        if name == "stack":
            d = d % t.ndim
            new = ()
            own = dict(owner)
            # a walked step's result standing for the steps of a loop over an
            # axis's slices that were not walked: one slice each, as theirs
            ref = self.filled.get(id(ins[-1]))
            walked = len(ins)
            if ref is not None and ref() is ins[-1]:
                walked = next(j for j, x in enumerate(ins) if x is ins[-1]) + 1
            for a in {x for p in pls for x, _ in p.owner}:
                idx = [dict(p.owner).get(a) for p in pls]
                if None not in idx and len(set(idx[:walked])) == walked \
                        and len(idx) == self.sizes.get(a, 1):
                    new = ((len(idx), (a,)),)
                    own.pop(a, None)
            base = self._broadcast(ins, pls, tuple(ins[0].shape), ()) or \
                _replicated(ins[0].ndim)
            dims = list(base.dims)
            dims.insert(d, new)
            return Placement(tuple(dims), tuple(sorted(own.items())))
        d = d % t.ndim
        dims = []
        for j in range(t.ndim):
            if j == d:
                cands = {p.dims[j] for p in pls}
                dims.append(pls[0].dims[j] if len(cands) == 1 else ())
            else:
                dims.append(next((p.dims[j] for p in pls if p.dims[j]), ()))
        return Placement(tuple(dims), owner)


# ------------------------------------------------------------------ entry
def _seed_tree(c: _Counter, tree, specs):
    if isinstance(tree, torch.Tensor):
        c.seed(tree, specs)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _seed_tree(c, v, specs.get(k) if isinstance(specs, dict) else None)
    elif isinstance(tree, (list, tuple)):
        for j, v in enumerate(tree):
            _seed_tree(c, v, specs[j] if isinstance(specs, (list, tuple))
                       and not _is_spec(specs) else None)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, (str, tuple)) for a in x)


def _gather_outputs(c: _Counter, tree, specs):
    """All-gather each output leaf over the axes it is split over where its
    out spec replicates it."""
    if isinstance(tree, torch.Tensor):
        if specs is None:
            return
        pl = c.settle(tree, c.get(tree))
        want = set()
        for ax in (specs.spec if isinstance(specs, Owned) else specs):
            want |= set(() if ax is None else (ax if isinstance(ax, tuple) else (ax,)))
        have = pl.dim_axes
        extra = [a for a in have if a not in want]
        if extra:
            local = c.local(tree, pl)
            c.collective("all-gather", extra, local, local * c._axes_size(extra))
    elif isinstance(tree, dict) and isinstance(specs, dict):
        for k, v in tree.items():
            _gather_outputs(c, v, specs.get(k))
    elif isinstance(tree, (list, tuple)) and isinstance(specs, (list, tuple)) \
            and not _is_spec(specs):
        for v, s in zip(tree, specs):
            _gather_outputs(c, v, s)


def count_step(fn, *args, mesh=None, specs=None, out_specs=None) -> StepCost:
    """Run ``fn(*args)`` once under the counter and return what it cost one
    device of ``mesh`` (a logical or device mesh; None: one device).
    ``specs`` holds one partition-spec tree per argument (None: replicated;
    ``Owned`` leaves for per-cloud state), ``out_specs`` one tree per output
    of ``fn``, or a function of the outputs that returns them (None: as the
    step leaves it)."""
    shape = dict(getattr(mesh, "shape", {}) or {}) if mesh is not None else {}
    c = _Counter(shape)
    _seed_tree(c, list(args), list(specs) if specs is not None else None)
    _ACTIVE.append(c)
    try:
        with c:
            out = fn(*args)
            if out_specs is not None:
                outs = out if isinstance(out, tuple) else (out,)
                _gather_outputs(c, outs, out_specs(outs) if callable(out_specs) else out_specs)
    finally:
        _ACTIVE.remove(c)
        c._alive = False
    del out
    return c.cost
