"""Continuous-batching serve engine.

The port of the reference engine's batched and bucketed scheduler (greedy
or sampled decoding, an optional EOS id, optional speculative decoding)
over either KV layout:

* ``paged_cache=False`` (the default, as in the reference): every slot owns
  a contiguous ring of C = window (0 < window < max_seq) or max_seq slots
  per layer; a request must satisfy prompt + gen <= max_seq unless a window
  lets the ring wrap. Decode attention over the rings skips each slot's dead
  pages (``paged_decode=True``) or streams every slot.
* ``paged_cache=True``: ONE shared pool of fixed-size physical pages plus per-slot page tables.
  A host-side ``PagePool`` (refcounts, LIFO free list, page 0 as scratch)
  hands out a request's prompt pages at admission and decode pages lazily,
  one per slot as decode crosses a page boundary. When the pool runs dry
  the youngest slot is preempted back to the head of the queue and later
  resumed by re-prefilling prompt + generated tokens. Admission keeps
  ``watermark_pages`` free while other slots are live.
  With a window the slot's logical ring is ceil(window/page) pages.
* ``prefill="chunked"``: every admission round is one batched prefill,
  padded to a shape bucket (pow2 width × pow2 length ladder; at its exact
  shape with ``bucket_prefill=False``), split into a cold dispatch (flash
  prefill) and a prefix-hit dispatch (suffix prefill).
  ``prefill="interleaved"``: prompt tokens are teacher-forced through the
  decode step, one per iteration (paged: pages arrive lazily); a prompt
  token's logits are discarded until the slot's last prompt token.
* Prefix sharing (``prefix_cache=True``, paged pool, chunked, no window;
  otherwise off with ``prefix_disabled_reason``): retired prompts' full pages are
  indexed in a radix trie; a later prompt maps its cached prefix onto the
  same physical pages and prefills only the suffix. A fully cached prompt
  re-prefills its last token into a copy-on-write split of its last page.
* One batched decode step per iteration advances every live slot: greedy
  slots take the batched argmax, sampled slots (``Request.sampling``) draw
  in one batched pass, each from its request's own stream
  (``sampling.request_stream``: its seed, or the engine ``seed`` and its
  uid). A request ends at ``max_new_tokens`` or at ``eos_id``.
* Speculative decoding (``draft_model``/``draft_params``/``spec_tokens``;
  paged, chunked, windowless): each iteration the draft proposes k tokens
  per slot (``spec_decode``), ONE suffix-prefill dispatch of the target
  verifies them all (``prefill_slots(return_all_logits=True)``), each row
  keeps its accepted run (greedy: exactly the plain decode step's tokens;
  sampled: rejection sampling) and rolls the rest back.
* ``kv_dtype="int8"`` stores the pool as int8 with one f32 scale per token
  slot per kv head (``ks``/``vs``): quantized at every write, dequantized
  inside the attention kernels.
* ``host_pages > 0`` adds a host-memory tier behind the pool
  (``HostTier``): a preempted slot's pages are copied device→host before
  its pool refs drop and are restored at re-admission without a prefill
  (swap instead of recompute), and prefix pages evicted from the index are
  demoted there and promoted back when a later prompt matches them.
* The request lifecycle: a request is never admitted before its
  ``arrival_time`` under ``step(respect_arrivals=True)``; a QUEUED request
  past its ``deadline_s`` is shed with an ``AdmissionError`` record
  (``shed``), a live slot older than ``max_wall_s`` retires with
  ``finish_reason="timeout"``, and a dry pool preempts the lowest
  ``priority`` first, the youngest within a priority. ``export_inflight``
  strips every in-flight request (live slots with their pages gathered to
  the host, their tokens, timing stamps and sampling streams; the queue with
  its resume records) and ``import_inflight`` adopts them at another
  engine's queue head: a layout-compatible importer with a host tier swaps
  the carried pages in, any other re-prefills (``launch/router.py`` moves a
  failed replica's work this way).

The caches and tables live on the engine's device and are updated in place
(the reference donated them through ``jit``); no cache tensor is ever
rebound. Every hot-path dispatch goes through the engine's ``GraphCache``
(``launch/graphs.py``): one CUDA graph per shape key, captured at its first
use and replayed after, as the reference's jit specializations are traced
once per shape. ``compiles`` counts them per entry point ("decode": one
per engine; "prefill_slots" per cold (width, length) bucket;
"prefill_suffix" per suffix (width, length, prefix-page width);
"sample_rows", the batched sampler at the full slot width, one; with a
draft "draft_prefill" per length bucket, "draft_propose" per whether any
row samples, and "spec_verify" per (width, length, prefix-page width)).
``graphs=False`` runs every dispatch eagerly: the same tokens and counters.
What stays eager: page-table pushes, slot resets, copy-on-write page
copies, host-tier copies, the greedy argmax, the speculative acceptance,
rollback and position fix-up, and the drafts' round trip to the host.

A ``mesh`` (``launch/mesh.make_serve_mesh``: a ``model`` axis over a list of
devices) serves tensor-parallel: the engine keeps its params and cache as
``Sharded`` trees, every replicated leaf once (positions and the one
host-side page table among them) beside each shard's ``wq``/``wk``/``wv``
head slices and its kv-head slice of every page or ring, and each dispatch
runs the per-shard model (``model.localize_config``) under the mesh's
tensor axis: attention per shard, the heads gathered, the rest once
(``models/sharding.py``). One process drives every shard; the scheduler,
pool and prefix index are unchanged, so the counters equal the unsharded
engine's. A mesh may name one
device several times (every shard on one card, or on the CPU); shards on
distinct devices run only with ``graphs=False`` (a graph captures one
device's stream) and are untested. A mesh refuses the host tier and
speculative decoding, as the reference does, and ``export_inflight`` carries
no pages from it."""
from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.kernels.paged_decode import kernel_head_dim
from repro_torch.launch.graphs import GraphCache
from repro_torch.launch.mesh import (
    MODEL_AXIS, axis_size, make_serve_mesh, shard_cache, shard_params,
)
from repro_torch.launch.prefix_cache import PrefixCache
from repro_torch.launch.sampling import (
    SamplingParams, request_stream, sample_rows, speculative_acceptance,
)
from repro_torch.launch.spec_decode import make_draft_backend
from repro_torch.models.attention import ring_capacity
from repro_torch.models.model import ModelAPI, build_model, localize_config
from repro_torch.models.sharding import TensorAxis, use_tensor_axis
from repro_torch.models.transformer import KV_PLANES, reset_slot

# Smallest padded prompt length of the bucket ladder.
LEN_BUCKET_MIN = 8
PREFILL_MODES = ("chunked", "interleaved")
# The reference's compile counters (``prefill``: per-request prefill, not
# ported yet, stays 0), and with a draft its speculative ones.
COMPILE_ENTRIES = ("decode", "prefill", "prefill_slots", "prefill_suffix")
SPEC_COMPILE_ENTRIES = ("spec_verify", "draft_propose", "draft_prefill")


def bucket_width(n: int, num_slots: int) -> int:
    """Round an admission-round width up to a power of two, capped at the
    slot-pool size — the extra rows are no-op padding rows (length 0)."""
    w = 1
    while w < n:
        w *= 2
    return min(w, num_slots)


def bucket_length(s: int, floor: int = LEN_BUCKET_MIN) -> int:
    """Round a padded prompt length up the ladder floor, 2·floor, 4·floor, …"""
    length = floor
    while length < s:
        length *= 2
    return length


def bucket_pages(pages: int, table_width: int) -> int:
    """Round a suffix round's max cached-prefix width (pages) up the pow2
    ladder 1, 2, 4, …, capped at the table width."""
    w = 1
    while w < pages:
        w *= 2
    return min(w, max(table_width, 1))


def serving_params(cfg, params: dict) -> dict:
    """``params`` as the engine reads them: ``lm_logits`` multiplies in
    fp32, so an untied unembedding is upcast once here instead of once per
    step. Idempotent (an fp32 leaf is returned as is), so engines built
    from one upcast dict share its tensors: the router upcasts once for all
    its replicas."""
    if cfg.tie_embeddings:
        return params
    return {**params, "embed": {**params["embed"],
                                "unembed": params["embed"]["unembed"].float()}}


class AdmissionError(ValueError):
    """A request the engine could not serve, with ``reason``: raised at
    submit for one it could never hold (``"exceeds_pool"`` on the pool,
    ``"exceeds_max_seq"`` on rings), recorded in ``shed`` for one shed from
    the queue (``"deadline_exceeded"``), and by the router for one no
    healthy replica can take (``"no_healthy_replica"``)."""

    def __init__(self, uid: int, reason: str, message: str):
        super().__init__(message)
        self.uid = uid
        self.reason = reason


class PagePool:
    """Host-side refcounted free-list allocator over the shared KV page pool.

    Page 0 is the reserved SCRATCH page: never handed out; every unallocated
    page-table entry points at it, so stray writes (retired slots whose
    ``pos`` keeps advancing in the batched decode step) land somewhere no
    live read looks. ``alloc`` hands pages out at rc=1, ``share`` adds a
    reference to a live page, ``free`` drops one — a page returns to the
    free list only at rc=0. Sharing a free page and over-freeing are errors.
    The free list is LIFO: the most recently freed pages are reused first; a
    fresh pool allocates 1, 2, …, P-1."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))
        self._rc: dict[int, int] = {}
        self.peak_in_use = 0

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.available

    @property
    def live_refs(self) -> int:
        return sum(self._rc.values())

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages at rc=1 each, or None (and nothing allocated)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def share(self, page: int) -> int:
        if self._rc.get(page, 0) < 1:
            raise ValueError(f"share of free/foreign page {page}")
        self._rc[page] += 1
        return self._rc[page]

    def free(self, pages) -> None:
        for p in pages:
            rc = self._rc.get(p, 0)
            if rc < 1:
                raise ValueError(f"double/foreign free of page {p}")
            if rc == 1:
                del self._rc[p]
                self._free.append(p)
            else:
                self._rc[p] = rc - 1


class HostTier:
    """Host-memory page store backing the device pool: the second tier of
    the KV cache.

    Two kinds of entry share one LRU budget of ``capacity_pages``:

    * SWAP entries (key ``("swap", uid)``): every page of a preempted slot,
      copied device→host before the pool refs drop. Re-admission restores
      them into fresh pool pages instead of recomputing the KV through a
      re-prefill.
    * PREFIX entries (key ``("prefix", token_tuple)``): a prefix-index page
      demoted at eviction; a later radix match promotes it back into a
      fresh pool page.

    An entry is a dict of CPU tensors, plane name → (L, n_pages, ...) (pinned
    when the pool is on a CUDA device), copied, never aliased: a dropped
    entry is never a correctness event — the engine falls back to recompute
    (swap) or a cold prefill (prefix)."""

    def __init__(self, capacity_pages: int):
        if capacity_pages < 1:
            raise ValueError(f"host tier capacity must be >= 1 page, got {capacity_pages}")
        self.capacity_pages = capacity_pages
        self._entries: collections.OrderedDict[tuple, dict] = collections.OrderedDict()
        self._pages = 0
        self.evictions = 0  # entries dropped by LRU pressure

    @property
    def pages(self) -> int:
        """Pages currently resident in the tier."""
        return self._pages

    def put(self, key: tuple, arrays: dict, n_pages: int) -> bool:
        """Store ``arrays`` under ``key``, LRU-evicting older entries to fit.
        False (and no store, no eviction) when the entry alone exceeds the
        tier."""
        if n_pages > self.capacity_pages:
            return False
        self.pop(key)
        while self._pages + n_pages > self.capacity_pages:
            _, old = self._entries.popitem(last=False)
            self._pages -= old["n"]
            self.evictions += 1
        self._entries[key] = {"arrays": arrays, "n": n_pages}
        self._pages += n_pages
        return True

    def get(self, key: tuple) -> dict | None:
        """Entry arrays for ``key`` (LRU touch), or None."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        self._entries.move_to_end(key)
        return entry["arrays"]

    def n_pages(self, key: tuple) -> int:
        entry = self._entries.get(key)
        return 0 if entry is None else entry["n"]

    def keys(self) -> list[tuple]:
        """Resident entry keys, least recently used first."""
        return list(self._entries)

    def pop(self, key: tuple) -> dict | None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return None
        self._pages -= entry["n"]
        return entry["arrays"]

    def clear(self) -> None:
        self._entries.clear()
        self._pages = 0


@dataclasses.dataclass
class _ResumeState:
    """Generation state of a preempted request. Re-admission prefills
    prompt + generated[:-1] and continues decoding from generated[-1].

    ``host_key`` marks a SWAPPED preemption: the slot's pages were copied to
    the ``HostTier`` before its pool refs dropped, and re-admission restores
    them (no prefill at all), bitwise the pages the slot held. ``pos`` is
    the slot's write position at preemption (the tokens of prompt +
    generated written so far; fewer than the prompt for a victim still
    teacher-forcing its prompt). A dropped tier entry falls back to the
    re-prefill.

    ``host_arrays`` carries the page content itself (plane name → (L, n,
    ...) CPU tensor) while the record migrates between engines
    (``export_inflight``): a tier key means nothing outside the engine that
    owns the tier, the copied pages do. ``rng`` is the request's sampling
    stream itself, so whoever resumes it continues its draws exactly."""
    generated: list[int]
    first_token_time: float
    admit_time: float
    host_key: tuple | None = None
    pos: int = 0
    rng: np.random.Generator | None = None
    host_arrays: dict | None = None


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_time`` is seconds on the engine
    clock (since its last ``reset_clock``/``reset_metrics``); with
    ``respect_arrivals`` the engine never admits a request before it.
    ``sampling=None`` (or temperature 0) decodes greedily. ``priority``
    orders preemption, not admission: a dry pool preempts the lowest
    priority first, the youngest within one (priority 0 everywhere is
    youngest-first). ``deadline_s``, relative to the arrival: a request
    still queued past it is shed with an ``AdmissionError("deadline_exceeded")``
    record; a request that has emitted tokens is never shed."""
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    sampling: SamplingParams | None = None
    priority: int = 0
    deadline_s: float | None = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")


@dataclasses.dataclass
class RequestOutput:
    uid: int
    prompt: list[int]
    tokens: list[int]             # generated ids (greedy or sampled), <= max_new
    slot: int
    finish_reason: str            # "eos" | "length" | "timeout"
    arrival_time: float
    admit_time: float
    first_token_time: float
    finish_time: float

    @property
    def latency(self) -> float:
        """Finish time from arrival."""
        return self.finish_time - self.arrival_time

    @property
    def ttft(self) -> float:
        """Time to first token, from arrival (includes queueing)."""
        return self.first_token_time - self.arrival_time


@dataclasses.dataclass
class _Slot:
    """Host-side state of one live slot."""
    req: Request
    generated: list[int]
    next_feed: int                # token the next decode step consumes
    admit_time: float
    feed: np.ndarray              # prompt, or prompt + generated[:-1] on resume
    # feed tokens not yet fed (interleaved prefill)
    pending: collections.deque = dataclasses.field(default_factory=collections.deque)
    prefix_len: int = 0           # leading feed tokens already in shared pages
    first_token_time: float = -1.0
    resumed: bool = False         # next emission is already known
    pos_host: int = 0             # host mirror of the slot's write position
    seq: int = 0                  # admission order (preemption: youngest in a priority)
    rng: np.random.Generator | None = None  # the request's stream (None = greedy)


class ServeEngine:
    """Slot-based continuous-batching scheduler over per-slot rings or the
    shared paged pool.

    Parameters follow the reference engine: ``num_slots`` (decode batch
    width), ``max_seq`` (the ring capacity without a window; sizes the
    default pool and table width), ``window`` (sliding-window span: 0 = full
    attention; below max_seq it shrinks the ring, or the slot's logical
    pages, to the window), ``prefill`` ("chunked" or "interleaved"),
    ``paged_decode`` (ring decode skips dead pages; the same tokens either
    way), ``paged_cache`` (the shared pool instead of rings), and for the
    pool ``page_size``, ``num_pages`` (incl. scratch page 0; 0 =
    ring-equivalent ``num_slots * ceil(capacity/page_size) + 1``),
    ``watermark_pages``, ``prefix_cache``, ``kv_dtype`` ("fp" or "int8"
    pages), ``host_pages`` (the host tier's capacity, 0 = none) and ``swap``
    (whether preemption swaps to that tier; prefix pages demote there either
    way). Without a window each slot's table holds ``table_width`` logical
    pages: by default ``num_slots * ceil(max_seq/page_size)``, the whole
    allocatable pool with ``long_requests``. ``prefix_cache_pages`` caps the
    pages the prefix index may pin (0 = the pool's capacity).
    ``draft_model``, ``draft_params`` and ``spec_tokens`` turn on
    speculative decoding (a ``ValueError`` names what blocks it). A request
    finishes after ``max_new_tokens`` or at ``eos_id`` (``finish_reason``
    "length" or "eos"), or at ``max_wall_s`` seconds after its first
    admission ("timeout"; 0 = no watchdog); ``seed`` keys the streams of
    sampled requests without a seed of their own. ``time_fn`` is the clock
    (``time.monotonic`` by default; a virtual one makes deadlines and the
    watchdog reproducible). ``device`` is where the
    caches live and the model runs (``"cuda"`` unless the caller asks for
    the CPU). ``bucket_prefill=False`` dispatches each admission round at
    its exact (width, length), so every distinct shape is a new
    specialization. ``graphs=False`` runs every dispatch eagerly instead of
    through CUDA graphs (the same tokens and counters). ``mesh`` serves
    tensor-parallel over its ``model`` axis (see the module docstring); the
    engine then runs on the mesh's first device."""

    def __init__(
        self,
        model: ModelAPI,
        params: dict,
        *,
        num_slots: int = 4,
        max_seq: int = 128,
        page_size: int = 16,
        num_pages: int = 0,
        table_width: int = 0,
        long_requests: bool = False,
        watermark_pages: int = 0,
        prefix_cache: bool = False,
        prefix_cache_pages: int = 0,
        device="cuda",
        window: int = 0,
        prefill: str = "chunked",
        paged_decode: bool = True,
        paged_cache: bool = False,
        kv_dtype: str = "fp",
        host_pages: int = 0,
        swap: bool = True,
        draft_model: ModelAPI | None = None,
        draft_params: dict | None = None,
        spec_tokens: int = 0,
        eos_id: int | None = None,
        seed: int = 0,
        max_wall_s: float = 0.0,
        time_fn=None,
        bucket_prefill: bool = True,
        graphs: bool = True,
        mesh=None,
    ):
        if model.init_slot_cache is None or model.prefill_slots is None:
            raise ValueError(
                f"arch {model.cfg.name!r} ({model.cfg.arch_type}) has no slot-cache API; the "
                "engine serves the transformer family")
        if prefill not in PREFILL_MODES:
            raise ValueError(f"prefill {prefill!r} not in {PREFILL_MODES}")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {max_seq}")
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
        if kv_dtype == "int8" and not paged_cache:
            raise ValueError("kv_dtype='int8' quantizes pool pages; it needs paged_cache=True")
        if host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got {host_pages}")
        if host_pages > 0 and not paged_cache:
            raise ValueError("host_pages tiers the page pool; it needs paged_cache=True")
        speculative = draft_model is not None or draft_params is not None or spec_tokens != 0
        if speculative:
            blockers = []
            if draft_model is None or draft_params is None:
                blockers.append("draft_model and draft_params are required")
            if spec_tokens < 1:
                blockers.append("spec_tokens must be >= 1")
            if not paged_cache:
                blockers.append("paged_cache=False (rollback is a page-table edit)")
            if prefill != "chunked":
                blockers.append(f"prefill={prefill!r} (verification is a batched "
                                "suffix-prefill round)")
            if window != 0:
                blockers.append(f"window={window} (suffix prefill is windowless)")
            if mesh is not None:
                blockers.append("mesh serving (single-device verify only)")
            if draft_model is not None and draft_model.cfg.vocab_size != model.cfg.vocab_size:
                blockers.append(f"draft vocab {draft_model.cfg.vocab_size} != target vocab "
                                f"{model.cfg.vocab_size}")
            if blockers:
                raise ValueError("speculative decoding unavailable: " + "; ".join(blockers))
        self.cfg = model.cfg
        self.model = model
        self.device = torch.device(device)
        # tensor-parallel serving: the shard count, the per-shard model and
        # the axis its dispatches run under (a 1-shard mesh keeps the model
        # and still runs the per-shard plumbing)
        self.mesh = mesh
        self.num_shards = 1
        self._tp_axis = None
        self._serve_model = model
        if mesh is not None:
            if MODEL_AXIS not in mesh.axis_names:
                raise ValueError(f"serving mesh needs a 'model' axis, got {mesh.axis_names}")
            if host_pages > 0:
                raise ValueError("host_pages with a mesh: the host tier copies a single-device "
                                 "pool, and a mesh shards it")
            if mesh.devices[0].type != self.device.type:
                raise ValueError(f"mesh on {mesh.devices[0]}, engine device {self.device}")
            if graphs and len(mesh.distinct_devices) > 1:
                raise ValueError(
                    f"graphs=True over a mesh of {len(mesh.distinct_devices)} distinct devices: "
                    "a CUDA graph captures one device's stream (pass graphs=False)")
            self.num_shards = axis_size(mesh, MODEL_AXIS)
            self.device = mesh.devices[0]
            self._tp_axis = TensorAxis(MODEL_AXIS, tuple(mesh.devices))
            if self.num_shards > 1:
                self._serve_model = build_model(localize_config(model.cfg, self.num_shards))
        self.params = serving_params(self.cfg, params)
        if mesh is not None:
            self.params = shard_params(self.params, mesh)
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.window = window
        self.prefill_mode = prefill
        self.paged_decode = paged_decode
        self.paged_cache = paged_cache
        self.kv_dtype = kv_dtype
        self.eos_id = eos_id
        self.seed = seed
        self.max_wall_s = max_wall_s
        self.bucket_prefill = bucket_prefill
        self.graphs = GraphCache(
            self.device, enabled=graphs,
            entries=COMPILE_ENTRIES + (SPEC_COMPILE_ENTRIES if speculative else ()))
        self._time_fn = time_fn or time.monotonic
        self._t0 = self._time_fn()

        self.prefix_disabled_reason = None
        if paged_cache:
            pages_per_ring = -(-ring_capacity(max_seq, window) // page_size)
            if num_pages <= 0:
                num_pages = num_slots * pages_per_ring + 1
            self.page_size = page_size
            self.num_pages = num_pages
            if 0 < window < max_seq:
                # the window bounds context: the slot's logical ring is the
                # window's pages, which the physical pool must hold
                self.table_width = pages_per_ring
                if num_pages - 1 < self.table_width:
                    raise ValueError(f"num_pages {num_pages} cannot back a table of "
                                     f"{self.table_width} pages (window {window})")
            elif table_width > 0:
                self.table_width = table_width
            elif long_requests:
                # one request may stretch across every allocatable page
                self.table_width = num_pages - 1
            else:
                self.table_width = num_slots * pages_per_ring
            self.cap = self.table_width * page_size
            self.pool = PagePool(num_pages, page_size)
            self.watermark_pages = watermark_pages
            self._table_np = np.zeros((num_slots, self.table_width), np.int32)
            self._table_dirty = False
            self._slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
            self.cache = model.init_paged_cache(
                num_slots, num_pages, page_size, self.table_width, device=self.device,
                kv_dtype=kv_dtype,
            )
            self.host = HostTier(host_pages) if host_pages > 0 else None
            if prefix_cache and window > 0:
                self.prefix_disabled_reason = (
                    f"window={window} (sliding-window ring wraps; prefix pages would be "
                    "overwritten)")
            elif prefix_cache and prefill != "chunked":
                self.prefix_disabled_reason = (
                    f"prefill={prefill!r} (suffix rounds need chunked batched admission)")
        else:
            self.pool = None
            self.host = None
            if prefix_cache:
                self.prefix_disabled_reason = (
                    "paged_cache=False (prefix sharing rides the page table)")
            self.cache = model.init_slot_cache(num_slots, max_seq, window=window,
                                               device=self.device)
        if self.prefix_disabled_reason is not None:
            logging.getLogger(__name__).warning(
                "prefix_cache requested but disabled: %s", self.prefix_disabled_reason)
        if mesh is not None:
            self.cache = shard_cache(self.cache, mesh)
        # the trees holding the cache planes (every shard's under a mesh) and
        # the one holding the positions and the page table
        self._planes = self.cache.shards if mesh is not None else [self.cache]
        self._slots = self.cache.full if mesh is not None else self.cache
        # the planes that carry page content: what every page copy moves
        self._kv_names = tuple(n for n in KV_PLANES if n in self._planes[0])
        self.swap = swap and self.host is not None
        self.prefix = PrefixCache(
            self.pool, prefix_cache_pages,
            demote_fn=self._demote_prefix_page if self.host else None,
            promote_fn=self._promote_prefix_page if self.host else None,
        ) if prefix_cache and self.prefix_disabled_reason is None else None
        self.prefix_cache = self.prefix is not None

        # speculative decoding: the counters exist in every mode (pool_stats
        # keeps one schema), the draft only when one is wired up
        self.draft = None
        self.spec_tokens = 0
        if speculative:
            self.spec_tokens = spec_tokens
            self.draft = make_draft_backend(
                draft_model, draft_params, num_slots=num_slots,
                cap=min(self.cap, self.pool.capacity * self.page_size),
                spec_tokens=spec_tokens, device=self.device, graphs=self.graphs,
            )
            # host mirror of each draft row's consumed-token count; -1 =
            # diverged or dead, forcing a re-sync prefill before the next
            # proposal (a reused slot never aliases its old occupant's state)
            self._draft_pos = np.full(num_slots, -1, np.int64)

        # resume records live in both cache layouts: ring engines never
        # preempt, but may import another engine's in-flight requests
        self._resume: dict[int, _ResumeState] = {}
        self._admit_seq = 0
        self.waiting: collections.deque[Request] = collections.deque()
        self.slots: list[_Slot | None] = [None] * num_slots
        self.finished: list[RequestOutput] = []
        self.shed: list[AdmissionError] = []   # deadline sheds, as records
        self.slot_history: dict[int, list[int]] = {}  # uid -> slots it ran in
        self._warmed: set[tuple] = set()
        self.reset_metrics()

    # ------------------------------------------------------------- plumbing
    def _now(self) -> float:
        return self._time_fn() - self._t0

    def reset_clock(self) -> None:
        """Restart the engine clock at 0 (arrival times are relative to
        it)."""
        self._t0 = self._time_fn()

    def reset_metrics(self) -> None:
        """Drop outputs and counters and restart the clock."""
        self.finished.clear()
        self.shed.clear()
        self.slot_history.clear()
        self.shed_requests = 0
        self.timeouts = 0
        self.steps = 0
        self.prefill_dispatches = 0
        self.suffix_dispatches = 0
        self.cold_dispatches = 0
        self.preemptions = 0
        self.occupancy: list[float] = []
        self.prefix_hit_pages = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.prefix_resume_hit_tokens = 0
        self.prefill_tokens = 0
        self.cow_copies = 0
        self.swapped_out_pages = 0
        self.swapped_in_pages = 0
        self.host_demoted_pages = 0
        self.host_promote_hits = 0
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        if self.paged_cache:
            self.pool.peak_in_use = self.pool.in_use
        if self.prefix is not None:
            self.prefix.reset_stats()
        self.reset_clock()

    def warm(self, prompt_lens, *, gen_tokens: int = 2,
             sampling: SamplingParams | None = None) -> None:
        """Run every (width, length) bucket a trace of ``prompt_lens`` can
        dispatch once (first-use costs: graph captures, kernel builds and
        loads, allocator growth; interleaved admission only sees width 1;
        without ``bucket_prefill`` every exact (width, length)), then clear
        the prefix index and the host tier and reset metrics. Each warm run
        starts from an empty prefix index, so that its round is a cold one
        at its bucket (the warm prompts are all zeros and would otherwise
        hit the pages the previous run published). Pass ``sampling`` when
        the trace will sample, so the sampler's first use is here too."""
        chunked = self.prefill_mode == "chunked"
        for p in sorted(set(prompt_lens)):
            for w in range(1, self.num_slots + 1) if chunked else [1]:
                key = ((bucket_width(w, self.num_slots), bucket_length(p))
                       if chunked and self.bucket_prefill else (w, p))
                if key in self._warmed:
                    continue
                self._warmed.add(key)
                if self.prefix is not None:
                    self.prefix.clear()
                self.run([
                    Request(uid=-1 - j, prompt=np.zeros(p, np.int32),
                            max_new_tokens=max(gen_tokens, 1), sampling=sampling)
                    for j in range(w)
                ])
        if self.prefix is not None:
            self.prefix.clear()
        if self.host is not None:
            self.host.clear()
        self.reset_metrics()

    @property
    def compiles(self) -> dict[str, int]:
        """Specializations (captured graphs; keys seen with ``graphs=False``)
        per hot-path entry point since construction. Not reset by
        ``reset_metrics``, as the reference's are not: captured graphs
        outlive a metrics window, and bucketing keeps these bounded as
        traffic diversity grows."""
        return dict(self.graphs.counts)

    @property
    def prefill_compiles(self) -> int:
        """``prefill_slots`` + suffix + per-request prefill specializations:
        what the bucket ladder bounds."""
        c = self.graphs.counts
        return c["prefill_slots"] + c["prefill_suffix"] + c["prefill"]

    def _kv_bytes_per_token(self) -> int:
        """Every layer's K and V of one token slot at the kernels' head dim
        (32 for a head dim of 30), with its f32 scales on int8 pages."""
        hd = kernel_head_dim(self.cfg.resolved_head_dim)
        row = hd + 4 if self.kv_dtype == "int8" else hd * getattr(torch, self.cfg.dtype).itemsize
        return self.cfg.n_layers * self.cfg.n_kv_heads * 2 * row

    @property
    def pool_stats(self) -> dict | None:
        """Pool occupancy and the page, prefix and tier counters (None for
        ring caches)."""
        if not self.paged_cache:
            return None
        occ = self.occupancy
        return {
            "shards": self.num_shards,
            "mesh_axes": dict(self.mesh.shape) if self.mesh is not None else None,
            # page tables are shard-invariant: every shard holds its kv-head
            # slice of the same live pages, so each shard's fill is the pool's
            "occupancy": [self.pool.in_use / max(self.pool.capacity, 1)] * self.num_shards,
            "page_size": self.page_size,
            "num_pages": self.num_pages,
            "allocatable_pages": self.pool.capacity,
            "pages_in_use": self.pool.in_use,
            "peak_pages_in_use": self.pool.peak_in_use,
            "preemptions": self.preemptions,
            "shed_requests": self.shed_requests,
            "timeouts": self.timeouts,
            "occupancy_mean": float(np.mean(occ)) if occ else 0.0,
            "occupancy_max": float(np.max(occ)) if occ else 0.0,
            "prefix_cache": self.prefix_cache,
            "prefix_hit_pages": self.prefix_hit_pages,
            # over fresh lookups only: resume re-admissions replay tokens the
            # engine itself published
            "prefix_hit_rate": (
                self.prefix_hit_tokens / self.prefix_lookup_tokens
                if self.prefix_lookup_tokens else 0.0
            ),
            "prefix_resume_hit_tokens": self.prefix_resume_hit_tokens,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            "prefill_tokens": self.prefill_tokens,
            "cow_copies": self.cow_copies,
            "suffix_dispatches": self.suffix_dispatches,
            "cold_dispatches": self.cold_dispatches,
            "prefix_pages_cached": self.prefix.size if self.prefix is not None else 0,
            "prefix_evicted_pages": self.prefix.evicted_pages if self.prefix is not None else 0,
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_token": self._kv_bytes_per_token(),
            "swap_enabled": self.swap,
            "host_capacity_pages": self.host.capacity_pages if self.host is not None else 0,
            "host_tier_pages": self.host.pages if self.host is not None else 0,
            "swapped_out_pages": self.swapped_out_pages,
            "swapped_in_pages": self.swapped_in_pages,
            "host_demoted_pages": self.host_demoted_pages,
            "host_promote_hits": self.host_promote_hits,
            # speculative decoding: accept_rate is accepted drafts over
            # drafted; dispatches_per_token is verify dispatches per emitted
            # token (1/(k+1) at full acceptance)
            "spec_enabled": self.draft is not None,
            "spec_tokens": self.spec_tokens,
            "spec_rounds": self.spec_rounds,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_emitted": self.spec_emitted,
            "spec_accept_rate": (self.spec_accepted / self.spec_drafted
                                 if self.spec_drafted else 0.0),
            "spec_dispatches_per_token": (self.spec_rounds / self.spec_emitted
                                          if self.spec_emitted else 0.0),
        }

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    def next_arrival(self) -> float | None:
        """Earliest arrival among waiting requests, or None."""
        return min((r.arrival_time for r in self.waiting), default=None)

    def prefix_probe(self, tokens) -> int:
        """Predicted cached-prefix tokens for a prompt: a read-only walk of
        the prefix index (``PrefixCache.probe``: no LRU touch, no hit or
        lookup counted, no page reference taken), in full pages times the
        page size. 0 without prefix sharing."""
        if self.prefix is None:
            return 0
        return self.prefix.probe(tokens) * self.page_size

    def capacity_shortfall(self, req: Request) -> int:
        """Tokens by which ``req`` exceeds the engine's static capacity (0 =
        servable): none with a window (the ring wraps), else the table width
        (``table_width``/``long_requests``) and the physical pool (paged) or
        ``max_seq`` (rings). It changes nothing, so a router may probe every
        replica with it."""
        need = len(req.prompt) + req.max_new_tokens
        if self.window != 0:
            return 0
        if self.paged_cache:
            return max(0, need - min(self.cap, self.pool.capacity * self.page_size))
        return max(0, need - self.max_seq)

    def submit(self, req: Request) -> None:
        """Enqueue a request, or raise ``AdmissionError`` if the engine could
        never hold it (it would wedge the head of the queue)."""
        short = self.capacity_shortfall(req)
        if short > 0 and not self.paged_cache:
            raise AdmissionError(
                req.uid, "exceeds_max_seq",
                f"request {req.uid}: prompt {len(req.prompt)} + gen {req.max_new_tokens} "
                f"exceeds max_seq {self.max_seq} by {short} tokens (the full-attention ring "
                "would overwrite live context)",
            )
        if short > 0:
            raise AdmissionError(
                req.uid, "exceeds_pool",
                f"request {req.uid}: prompt {len(req.prompt)} + gen {req.max_new_tokens} "
                f"exceeds pool capacity by {short} tokens (table {self.table_width} pages "
                f"× {self.page_size}, pool {self.pool.capacity} allocatable pages)",
            )
        self.waiting.append(req)

    # ------------------------------------------------------------ scheduling
    def _shed_expired(self, now: float) -> None:
        """Shed queued requests past their deadline, each recorded as an
        ``AdmissionError("deadline_exceeded")`` in ``shed`` (nobody calls
        the scheduler who could catch it). A preempted request that has
        emitted tokens is exempt: its client has output already. A shed
        request's resume record goes, and with it its host-tier entry."""
        if not any(r.deadline_s is not None for r in self.waiting):
            return
        kept: collections.deque[Request] = collections.deque()
        while self.waiting:
            req = self.waiting.popleft()
            resume = self._resume.get(req.uid)
            mid_stream = resume is not None and bool(resume.generated)
            if (req.deadline_s is not None and not mid_stream
                    and now - req.arrival_time > req.deadline_s):
                dropped = self._resume.pop(req.uid, None)
                if dropped is not None and dropped.host_key is not None and self.host is not None:
                    self.host.pop(dropped.host_key)
                self.shed.append(AdmissionError(
                    req.uid, "deadline_exceeded",
                    f"request {req.uid}: queued {now - req.arrival_time:.3f}s past arrival, "
                    f"deadline was {req.deadline_s:.3f}s; shed unserved",
                ))
                self.shed_requests += 1
            else:
                kept.append(req)
        self.waiting = kept

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _host(a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor for the graph cache, which copies it
        into its device buffers."""
        return torch.from_numpy(np.ascontiguousarray(a))

    def _greedy(self, logits: torch.Tensor) -> list[int]:
        """Argmax over the real vocabulary, one host transfer per batch."""
        return logits[:, : self.cfg.vocab_size].argmax(dim=-1).tolist()

    def _request_rng(self, req: Request) -> np.random.Generator | None:
        """The request's own sampling stream (None = greedy): its explicit
        seed, or the engine seed and its uid; never the slot."""
        sp = req.sampling
        if sp is None or sp.is_greedy:
            return None
        return request_stream(sp.seed, self.seed, req.uid)

    def _next_tokens(self, logits: torch.Tensor, rows: dict[int, int]) -> dict[int, int]:
        """The next token of each emitting slot (``rows``: slot → its row of
        ``logits``): greedy slots take the batched argmax, sampled slots
        one draw each from one batched filter-and-draw pass at the full slot
        width (one specialization, as the reference's ``_sample_rows``),
        each with one uniform from its own stream; greedy and idle rows
        ride along on row 0 with a dummy uniform, and their draws are
        dropped. A row's draw depends only on its own logits and uniform.
        At most two host transfers."""
        greedy = [i for i in rows if self.slots[i].rng is None]
        samp = [i for i in rows if self.slots[i].rng is not None]
        out: dict[int, int] = {}
        if greedy:
            g = self._greedy(logits)
            out.update((i, g[rows[i]]) for i in greedy)
        if samp:
            n = self.num_slots
            src = np.zeros(n, np.int64)
            u = np.full(n, 0.5)
            temps = np.ones(n, np.float32)
            topks = np.zeros(n, np.int64)
            topps = np.ones(n, np.float32)
            for i in samp:
                sp = self.slots[i].req.sampling
                src[i] = rows[i]
                u[i] = self.slots[i].rng.random()
                temps[i], topks[i], topps[i] = sp.temperature, sp.top_k, sp.top_p
            toks = self.graphs(
                "sample_rows", (), functools.partial(sample_rows, vocab_size=self.cfg.vocab_size),
                logits.index_select(0, self._tensor(src)), self._host(u), self._host(temps),
                self._host(topks), self._host(topps),
            ).tolist()
            out.update((i, toks[i]) for i in samp)
        return out

    def _done(self, slot: _Slot, last: int) -> bool:
        if self.eos_id is not None and last == self.eos_id:
            return True
        return len(slot.generated) >= slot.req.max_new_tokens

    def _admit(self, now: float, respect_arrivals: bool = False) -> None:
        """Shed the queue's expired requests, then fill free slots from the
        queue in submission order, stopping at the first request whose
        arrival is still ahead with ``respect_arrivals``. Chunked
        admission prefills each round's claims in one batched prefill;
        interleaved admission only queues the prompt for the decode step. On
        the paged pool each chunked claim takes its prompt pages up front
        (cached prefix pages shared, the rest fresh; interleaved pages arrive
        lazily); claiming stops, without dequeuing, when the pool cannot
        cover the next request plus the watermark (waived when no other slot
        is live). A request that finishes on its first token frees its slot
        for the next round. A swapped preemption comes back from the host
        tier without a prefill (``_swap_in``), or through the re-prefill when
        the tier dropped it."""
        chunked = self.prefill_mode == "chunked"
        self._shed_expired(now)
        while True:
            free = [i for i, s in enumerate(self.slots) if s is None]
            claimed: list[int] = []
            while free and self.waiting:
                req = self.waiting[0]
                if respect_arrivals and req.arrival_time > now:
                    break
                resume = self._resume.get(req.uid)
                if resume is not None and resume.host_key is not None and (
                        self.host is None or self.host.n_pages(resume.host_key) == 0):
                    resume.host_key = None  # the tier dropped it: recompute
                if resume is not None and resume.host_key is not None:
                    if not self._swap_in(req, resume, free, now):
                        break  # stays queued; recompute needs no fewer pages
                    continue
                feed = req.prompt
                if resume is not None and resume.generated:
                    feed = np.concatenate([req.prompt, np.asarray(resume.generated[:-1], np.int32)])
                hits: list[int] = []
                suffix_start = 0
                cow = False
                if self.paged_cache:
                    n_fresh = 1  # interleaved: pages arrive lazily
                    if chunked:
                        total_pages = min(-(-len(feed) // self.page_size), self.table_width)
                        if self.prefix is not None:
                            # share the hits first so eviction below cannot
                            # recycle them
                            hits = self.prefix.match(feed)
                            for p in hits:
                                self.pool.share(p)
                            # at least one token must run through prefill (its
                            # logits give the first emission): a fully cached
                            # prompt re-prefills its last token into a copy of
                            # its last page
                            suffix_start = min(len(hits) * self.page_size, len(feed) - 1)
                            cow = len(hits) * self.page_size > suffix_start
                        n_fresh = total_pages - len(hits) + (1 if cow else 0)
                    hold = self.watermark_pages if any(s is not None for s in self.slots) else 0
                    if self.pool.available < n_fresh + hold:
                        if self.prefix is not None:
                            self.prefix.evict(n_fresh + hold - self.pool.available)
                        if self.pool.available < n_fresh + hold:
                            self.pool.free(hits)
                            break  # stays queued
                self.waiting.popleft()
                i = free.pop(0)
                reset_slot(self._slots, i)
                slot = _Slot(req=req, generated=[], next_feed=-1, admit_time=now, feed=feed,
                             prefix_len=suffix_start, rng=self._request_rng(req))
                self._admit_seq += 1
                slot.seq = self._admit_seq
                if self.paged_cache:
                    pages = list(hits)
                    if cow:
                        src, dst = pages[-1], self.pool.alloc(1)[0]
                        for c in self._planes:
                            for name in self._kv_names:  # int8: the scale planes too
                                c[name][:, dst] = c[name][:, src]
                        self.pool.free([src])
                        pages[-1] = dst
                        self.cow_copies += 1
                    if chunked:
                        pages.extend(self.pool.alloc(total_pages - len(pages)))
                        if resume is None:
                            self.prefix_hit_pages += len(hits)
                            self.prefix_hit_tokens += suffix_start
                            self.prefix_lookup_tokens += len(feed)
                        else:
                            self.prefix_resume_hit_tokens += suffix_start
                    self._slot_pages[i] = pages
                    self._table_np[i, :] = 0
                    self._table_np[i, : len(pages)] = pages
                    self._table_dirty = True
                if resume is not None:
                    del self._resume[req.uid]
                    slot.generated = list(resume.generated)
                    slot.first_token_time = resume.first_token_time
                    slot.admit_time = resume.admit_time
                    slot.resumed = bool(resume.generated)
                    slot.rng = resume.rng
                self.slot_history.setdefault(req.uid, []).append(i)
                self.slots[i] = slot
                if chunked:
                    slot.pos_host = len(feed)
                    claimed.append(i)
                else:  # the decode step consumes the feed, one token a step
                    slot.pending = collections.deque(int(t) for t in feed)
                    slot.next_feed = slot.pending.popleft()
            if not claimed:
                return
            if not self._prefill_claimed(claimed):
                return

    def _swap_in(self, req: Request, resume: _ResumeState, free: list[int],
                 now: float) -> bool:
        """Restore a swapped request's pages from the host tier into fresh
        pool pages and give it a slot that continues decoding where it
        stopped: ``pos`` restored, next feed ``stream[pos]``, no prefill.
        False (nothing changed) when the pool cannot cover its pages plus
        the watermark even after prefix eviction. The evicted prefix pages
        demote into the same tier and may push this entry out: then the
        resume falls back to the re-prefill (True, still queued, with
        ``host_key`` cleared, so the caller reads the head again)."""
        n_need = self.host.n_pages(resume.host_key)
        hold = self.watermark_pages if any(s is not None for s in self.slots) else 0
        if self.pool.available < n_need + hold:
            if self.prefix is not None:
                self.prefix.evict(n_need + hold - self.pool.available)
                if self.host.n_pages(resume.host_key) == 0:
                    resume.host_key = None
                    return True
            if self.pool.available < n_need + hold:
                return False
        pages = self.pool.alloc(n_need)
        self.waiting.popleft()
        i = free.pop(0)
        del self._resume[req.uid]
        self._restore_pages(pages, self.host.pop(resume.host_key))
        self.swapped_in_pages += n_need
        self._slot_pages[i] = pages
        self._table_np[i, :] = 0
        self._table_np[i, :n_need] = pages
        self._table_dirty = True
        self._slots["pos"][i] = resume.pos
        # written tokens = stream[:pos]; the slot feeds stream[pos] next and
        # (a victim still teacher-forcing its prompt) the rest after it
        stream = np.concatenate([req.prompt, np.asarray(resume.generated, np.int32)])
        slot = _Slot(req=req, generated=list(resume.generated),
                     next_feed=int(stream[resume.pos]), admit_time=resume.admit_time,
                     feed=stream[: resume.pos], first_token_time=resume.first_token_time,
                     pos_host=resume.pos, rng=resume.rng,
                     pending=collections.deque(int(t) for t in stream[resume.pos + 1:]))
        self._admit_seq += 1
        slot.seq = self._admit_seq
        self.slot_history.setdefault(req.uid, []).append(i)
        self.slots[i] = slot
        return True

    def _prefill_claimed(self, claimed: list[int]) -> bool:
        """Prefill the claimed slots; returns True if any retired. The round
        splits into a cold group (no cached prefix: flash prefill) and a hit
        group (suffix prefill), each one dispatch padded to its bucket."""
        self._sync_table()
        first: dict[int, int] = {}
        emit = [i for i in claimed if not self.slots[i].resumed]
        cold = [i for i in claimed if self.slots[i].prefix_len == 0]
        hits = [i for i in claimed if self.slots[i].prefix_len > 0]
        for group, suffix in ((cold, False), (hits, True)):
            if not group:
                continue
            sufs = [self.slots[i].feed[self.slots[i].prefix_len:] for i in group]
            width, padded_len = len(group), max(p.size for p in sufs)
            if self.bucket_prefill:
                width = bucket_width(width, self.num_slots)
                padded_len = bucket_length(padded_len)
            tokens = np.zeros((width, padded_len), np.int32)
            lengths = np.zeros(width, np.int32)
            starts = np.zeros(width, np.int32)
            slot_ids = np.zeros(width, np.int32)
            for j, (i, p) in enumerate(zip(group, sufs)):
                tokens[j, : p.size] = p
                lengths[j] = p.size
                starts[j] = self.slots[i].prefix_len
                slot_ids[j] = i
            if width > len(group):
                # padding rows (length 0 writes nothing) aimed at distinct
                # slots outside this dispatch: outside the round first
                in_group = set(group)
                spare = [i for i in range(self.num_slots)
                         if i not in in_group and i not in claimed]
                spare += [i for i in claimed if i not in in_group]
                slot_ids[len(group):] = spare[: width - len(group)]
            if suffix:
                pw = bucket_pages(-(-int(starts.max()) // self.page_size), self.table_width)
                logits = self.graphs(
                    "prefill_suffix", (pw,),
                    lambda t, n, s, st: self._forward("prefill_slots", t, n, s, starts=st,
                                                      prefix_pages=pw),
                    self._host(tokens), self._host(lengths), self._host(slot_ids),
                    self._host(starts))
                self.suffix_dispatches += 1
            else:
                logits = self.graphs(
                    "prefill_slots", (),
                    lambda t, n, s: self._forward("prefill_slots", t, n, s, window=self.window),
                    self._host(tokens), self._host(lengths), self._host(slot_ids))
                self.cold_dispatches += 1
            self.prefill_dispatches += 1
            self.prefill_tokens += int(sum(p.size for p in sufs))
            # a resumed slot's next token is already known: no argmax, and
            # no draw from its stream
            first.update(self._next_tokens(logits, {i: j for j, i in enumerate(group)
                                                    if i in emit}))

        retired = False
        for i in claimed:  # emit in admission order
            slot = self.slots[i]
            if slot.resumed:
                # every generated token survived preemption: continue by
                # re-feeding the last one
                slot.resumed = False
                slot.next_feed = slot.generated[-1]
                continue
            g = first[i]
            slot.first_token_time = self._now()
            slot.generated.append(g)
            slot.next_feed = g
            if self._done(slot, g):
                self._retire(i, slot)
                retired = True
        return retired

    def _retire(self, i: int, slot: _Slot, reason: str | None = None) -> None:
        """Emit the slot's output and free it. Its full prompt pages are
        published to the prefix index first, except on a ``"timeout"``
        (an interleaved slot timed out mid-prompt may hold a partly written
        page, which no other request may alias)."""
        if reason is None:
            eos = self.eos_id is not None and slot.generated[-1] == self.eos_id
            reason = "eos" if eos else "length"
        self.finished.append(RequestOutput(
            uid=slot.req.uid, prompt=slot.req.prompt.tolist(), tokens=list(slot.generated),
            slot=i, finish_reason=reason, arrival_time=slot.req.arrival_time,
            admit_time=slot.admit_time, first_token_time=slot.first_token_time,
            finish_time=self._now(),
        ))
        self._release(i, publish=reason != "timeout")

    def _release(self, i: int, publish: bool = False) -> None:
        """Empty slot ``i``: the draft re-syncs its next occupant; on the
        pool (with ``publish``, the FULL prompt pages first go to the prefix
        index, which takes its own refs) the slot's page refs drop and its
        table row reverts to the scratch page."""
        slot = self.slots[i]
        self.slots[i] = None
        if self.draft is not None:
            self._draft_pos[i] = -1
        if not self.paged_cache:
            return
        if publish and self.prefix is not None:
            n_pub = min(len(slot.req.prompt) // self.page_size, len(self._slot_pages[i]))
            if n_pub > 0:
                self.prefix.insert(slot.req.prompt, self._slot_pages[i][:n_pub])
        self.pool.free(self._slot_pages[i])
        self._slot_pages[i] = []
        self._table_np[i, :] = 0
        self._table_dirty = True

    def _watchdog(self) -> None:
        """Retire every live slot older than ``max_wall_s`` since its first
        admission (a preemption round trip keeps the stamp) with
        ``finish_reason="timeout"`` and the tokens it has, so a slot that
        stops advancing cannot wedge ``run()``. Runs first in every step."""
        if self.max_wall_s <= 0:
            return
        now = self._now()
        for i, slot in enumerate(self.slots):
            if slot is not None and now - slot.admit_time > self.max_wall_s:
                self._retire_timeout(i, slot)

    def _retire_timeout(self, i: int, slot: _Slot) -> None:
        """The watchdog's retirement: a ``"timeout"`` output with the tokens
        generated so far; its pages are freed unpublished."""
        self.timeouts += 1
        self._retire(i, slot, "timeout")

    # ----------------------------------------------------------- paged pool
    def _sync_table(self) -> None:
        """Push the host page-table mirror (authoritative) to the device."""
        if self.paged_cache and self._table_dirty:
            self._slots["table"].copy_(torch.from_numpy(self._table_np))
            self._table_dirty = False

    def _forward(self, entry: str, *args, **kwargs) -> torch.Tensor:
        """The serving model's ``entry`` ("decode" or "prefill_slots") on the
        engine's params and cache, per shard under a mesh; its logits."""
        with use_tensor_axis(self._tp_axis):
            fn = getattr(self._serve_model, entry)
            return fn(self.params, self.cache, *args, **kwargs)[1]

    # -------------------------------------------------------- host tier I/O
    def _gather_host(self, pages: list[int]) -> dict:
        """Copy page content device→host: plane name → (L, n, page, ...) CPU
        tensor (pinned for a CUDA pool). The copy is synchronous: it is
        complete, and ordered after every write the stream queued to these
        pages, when this returns, so the caller may free the pages and let
        the next step rewrite them."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        out = {}
        for name in self._kv_names:
            src = self.cache[name].index_select(1, idx)
            if self.device.type == "cuda":
                dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                dst.copy_(src)
                src = dst
            out[name] = src
        return out

    def _restore_pages(self, pages: list[int], arrays: dict) -> None:
        """Copy host content back into freshly allocated pool pages, every
        plane (synchronous host→device copies)."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for name in self._kv_names:
            self.cache[name].index_copy_(1, idx, arrays[name].to(self.device))

    def _demote_prefix_page(self, key: tuple, page: int) -> None:
        """Prefix-index eviction hook: copy the page's content to the host
        tier (keyed by the token prefix it caches) before the index drops
        its pool ref. Co-readers still holding the page are unaffected."""
        if self.host.put(("prefix", key), self._gather_host([page]), 1):
            self.host_demoted_pages += 1

    def _promote_prefix_page(self, key: tuple) -> int | None:
        """Prefix-index miss hook: restore a demoted page into a fresh pool
        page, whose rc=1 ref becomes the index's. None when the tier holds
        no copy or the pool is too tight to spend a page on caching (a
        promotion never spends the admission watermark)."""
        if self.host.n_pages(("prefix", key)) != 1:
            return None
        if self.pool.available <= self.watermark_pages + 1:
            return None
        pages = self.pool.alloc(1)
        self._restore_pages(pages, self.host.pop(("prefix", key)))
        self.host_promote_hits += 1
        return pages[0]

    def _preempt_victim(self) -> int:
        """The slot a dry pool preempts: the lowest priority first, the
        youngest (largest admission ``seq``) within a priority, so default
        priorities preempt youngest-first."""
        return min((i for i, s in enumerate(self.slots) if s is not None),
                   key=lambda i: (self.slots[i].req.priority, -self.slots[i].seq))

    def _preempt(self, i: int) -> None:
        """Send slot ``i`` back to the HEAD of the queue, freeing its pages;
        re-admission re-prefills prompt + generated and continues. With the
        host tier on, the pages are first copied device→host (BEFORE the
        pool refs drop: a freed page may be rewritten by the very next
        decode step), and re-admission restores them instead; the re-prefill
        stays the fallback whenever the tier refused or dropped the entry."""
        slot = self.slots[i]
        pages = self._slot_pages[i]
        host_key = None
        if self.swap and pages:
            key = ("swap", slot.req.uid)
            if self.host.put(key, self._gather_host(pages), len(pages)):
                host_key = key
                self.swapped_out_pages += len(pages)
        self._resume[slot.req.uid] = _ResumeState(
            generated=list(slot.generated), first_token_time=slot.first_token_time,
            admit_time=slot.admit_time, host_key=host_key, pos=slot.pos_host, rng=slot.rng,
        )
        self.waiting.appendleft(slot.req)
        self._release(i)
        self.preemptions += 1

    def _ensure_decode_pages(self, live: list[int]) -> None:
        """Before a decode step, give every live slot whose next write
        crosses into an unallocated logical page one page; when the pool is
        dry, evict prefix-index pages, then preempt ``_preempt_victim``'s
        slot (until a page frees up, or the needy slot itself went)."""
        for i in live:
            slot = self.slots[i]
            if slot is None:
                continue  # preempted for an earlier slot's page
            pi = (slot.pos_host % self.cap) // self.page_size
            if self._table_np[i, pi] != 0:
                continue
            while True:
                pages = self.pool.alloc(1)
                if pages is not None:
                    self._slot_pages[i].append(pages[0])
                    self._table_np[i, pi] = pages[0]
                    self._table_dirty = True
                    break
                if self.prefix is not None and self.prefix.evict(1) > 0:
                    continue
                victim = self._preempt_victim()
                self._preempt(victim)
                if victim == i:
                    break

    # ------------------------------------------------------------ migration
    def export_inflight(self) -> list[tuple[Request, _ResumeState | None]]:
        """Strip every in-flight request off this engine, to be imported by
        another: live slots first, in admission order, then the queue, front
        first. Afterwards the engine holds no work and no page of them.

        A live slot that has emitted tokens leaves with a resume record: its
        tokens, timing stamps, write position and sampling stream (the
        ``np.random.Generator`` object itself, so the importer's draws
        continue it exactly), and on an unsharded pool its pages' content
        gathered to the host before they are freed (``host_arrays``; the
        importer's first dispatch may rewrite a freed page; a mesh's
        requests re-prefill instead, as the reference's do). A queued request keeps its
        resume record; a swapped one's tier entry is popped and carried as
        arrays, since its key means nothing to another engine."""
        items: list[tuple[Request, _ResumeState | None]] = []
        live = sorted((i for i, s in enumerate(self.slots) if s is not None),
                      key=lambda i: self.slots[i].seq)
        for i in live:
            slot = self.slots[i]
            resume = None
            if slot.generated:
                resume = _ResumeState(
                    generated=list(slot.generated), first_token_time=slot.first_token_time,
                    admit_time=slot.admit_time, pos=slot.pos_host, rng=slot.rng)
                if self.paged_cache and self.mesh is None and self._slot_pages[i]:
                    resume.host_arrays = self._gather_host(self._slot_pages[i])
            items.append((slot.req, resume))
            self._release(i)
        while self.waiting:
            req = self.waiting.popleft()
            resume = self._resume.pop(req.uid, None)
            if resume is not None and resume.host_key is not None:
                if self.host is not None:
                    resume.host_arrays = self.host.pop(resume.host_key)
                resume.host_key = None
            items.append((req, resume))
        return items

    def _adopt_host_arrays(self, uid: int, resume: _ResumeState, arrays: dict) -> bool:
        """Put a migrated record's page content into this engine's host tier
        under its own ("swap", uid) key, so that admission swaps the request
        in instead of re-prefilling it. Only an exactly matching pool layout
        adopts (the same planes, fp or int8 with scales, layer count, page
        shape and dtypes); anything else recomputes."""
        if self.host is None or resume.pos <= 0:
            return False
        if set(arrays) != set(self._kv_names):
            return False
        for name in self._kv_names:
            ref, a = self.cache[name], arrays[name]
            if a.shape[0] != ref.shape[0] or a.shape[2:] != ref.shape[2:] or a.dtype != ref.dtype:
                return False
        key = ("swap", uid)
        if not self.host.put(key, arrays, int(arrays[self._kv_names[0]].shape[1])):
            return False
        resume.host_key = key
        return True

    def import_inflight(self, items: list[tuple[Request, _ResumeState | None]]) -> None:
        """Adopt exported requests at the front of the queue, in their
        order: a failed replica's in-flight work is older than anything
        queued here. A request with emitted tokens resumes: by swap-in of
        its carried pages when this engine adopts them, else by the
        re-prefill of prompt + generated[:-1]; either way it re-feeds its
        last token and continues its own sampling stream."""
        for req, resume in reversed(items):
            if self.capacity_shortfall(req) > 0:
                raise AdmissionError(
                    req.uid, "exceeds_pool",
                    f"migrated request {req.uid} exceeds this engine's static capacity")
            if resume is not None and resume.generated:
                if resume.host_arrays is not None:
                    self._adopt_host_arrays(req.uid, resume, resume.host_arrays)
                    resume.host_arrays = None
                self._resume[req.uid] = resume
            self.waiting.appendleft(req)

    # ------------------------------------------------------- spec decoding
    def _ensure_spec_pages(self, live: list[int],
                           k_r: dict[int, int]) -> dict[int, list[tuple[int, int]]]:
        """Best-effort lookahead pages for a speculative round: slot ``i``
        verifying ``k_r[i]`` drafts writes positions pos .. pos + k_r[i],
        which may cross into logical pages past the one
        ``_ensure_decode_pages`` gave it. Lookahead pages never preempt and
        never dip below the watermark: on a tight pool the round runs
        shallower (``k_r`` shrinks to what the covered pages hold; 0 is a
        one-token verify). Returns the fresh (page index, page) pairs per
        slot, so rollback frees exactly the pages left holding no kept
        token."""
        fresh: dict[int, list[tuple[int, int]]] = {}
        for i in live:
            p = self.slots[i].pos_host
            got = []
            for pi in range(p // self.page_size + 1, (p + k_r[i]) // self.page_size + 1):
                if self._table_np[i, pi] != 0:
                    continue
                pages = None
                if self.pool.available > self.watermark_pages:
                    pages = self.pool.alloc(1)
                if (pages is None and self.prefix is not None and self.prefix.evict(1) > 0
                        and self.pool.available > self.watermark_pages):
                    pages = self.pool.alloc(1)
                if pages is None:
                    k_r[i] = pi * self.page_size - 1 - p
                    break
                self._slot_pages[i].append(pages[0])
                self._table_np[i, pi] = pages[0]
                self._table_dirty = True
                got.append((pi, pages[0]))
            if got:
                fresh[i] = got
        return fresh

    def _rollback_spec_pages(self, i: int, fresh_i: list[tuple[int, int]],
                             keep_pos: int) -> None:
        """Free the round's fresh lookahead pages past the accepted span
        (``keep_pos`` written tokens kept). Pages the slot held before the
        round hold committed history and are never touched, so rejection
        rounds can neither leak nor double-free a page."""
        last = (keep_pos - 1) // self.page_size
        for pi, page in fresh_i:
            if pi > last:
                self.pool.free([page])
                self._slot_pages[i].remove(page)
                self._table_np[i, pi] = 0
                self._table_dirty = True

    def _spec_round(self, live: list[int]) -> None:
        """One speculative iteration over the live slots: the draft proposes
        up to k tokens per row, ONE batched suffix-prefill dispatch of the
        target verifies every row's proposals (logits at every position),
        then each row keeps a prefix of its drafts (greedy: the longest run
        matching the target's argmax, then the target's token; sampled:
        Leviathan rejection sampling) and rolls the rest back by position
        truncation and a lookahead-page free.

        Greedy rows emit the tokens the plain decode step would: the verify
        logits at position p + j are the forward the decode step computes
        after the same j accepted tokens, and the walk stops at the first
        mismatch. Sampled rows draw exactly from the target distribution,
        with one block of uniforms from the request's stream per round:
        the draft's proposals and the acceptance tests on disjoint parts."""
        kk = self.spec_tokens
        vocab = self.cfg.vocab_size
        for i in live:
            slot = self.slots[i]
            # chunked admission prefills whole prompts: no decode-phase slot
            # is mid-prefill or holds a resumed token here
            assert not slot.pending and not slot.resumed, "spec round over a resumed slot"
        # draft re-sync: rows whose draft state is not at pos_host (fresh
        # admissions, preemption returns, slot reuse) re-prefill their
        # written stream; rows in sync ride along as length-0 rows
        stale = [i for i in live if self._draft_pos[i] != self.slots[i].pos_host]
        if stale:
            lb = bucket_length(max(self.slots[i].pos_host for i in stale))
            toks = np.zeros((self.num_slots, lb), np.int32)
            lens = np.zeros(self.num_slots, np.int32)
            for i in stale:
                slot = self.slots[i]
                p = slot.pos_host
                toks[i, :p] = np.concatenate(
                    [slot.req.prompt, np.asarray(slot.generated, np.int32)])[:p]
                lens[i] = p
            self.draft.prefill_rows(self._host(toks), self._host(lens))
            for i in stale:
                self._draft_pos[i] = self.slots[i].pos_host
        # per-row depth: never past max_new (the correction or bonus token
        # must fit) or the slot's capacity; the page pass may shrink it
        lim = min(self.cap, self.pool.capacity * self.page_size)
        k_r = {}
        for i in live:
            slot = self.slots[i]
            rem = slot.req.max_new_tokens - len(slot.generated)
            k_r[i] = max(0, min(kk, rem - 1, lim - 1 - slot.pos_host))
        fresh = self._ensure_spec_pages(live, k_r)
        # round inputs at the full slot width, like every engine dispatch
        feed = np.zeros(self.num_slots, np.int32)
        greedy = np.ones(self.num_slots, bool)
        temps = np.ones(self.num_slots, np.float32)
        topks = np.zeros(self.num_slots, np.int64)
        topps = np.ones(self.num_slots, np.float32)
        u_draft = np.full((self.num_slots, kk), 0.5)
        u_acc: dict[int, np.ndarray] = {}
        samp = [i for i in live if self.slots[i].rng is not None]
        for i in live:
            feed[i] = self.slots[i].next_feed
        for i in samp:
            sp = self.slots[i].req.sampling
            greedy[i] = False
            temps[i], topks[i], topps[i] = sp.temperature, sp.top_k, sp.top_p
            block = self.slots[i].rng.random(2 * kk + 2)   # one advance per round
            u_draft[i], u_acc[i] = block[:kk], block[kk:]
        drafts_dev, logq = self.draft.propose(
            self._host(feed), self._host(u_draft) if samp else None,
            self._host(greedy), self._host(temps), self._host(topks), self._host(topps))
        drafts = drafts_dev.cpu().numpy()                  # (num_slots, k)
        # one verify dispatch: row j feeds [next_feed, d_1..d_kr] as a suffix
        # at starts = pos over the shared page table
        self._sync_table()
        n = len(live)
        width = bucket_width(n, self.num_slots)
        s_len = bucket_length(max(k_r[i] for i in live) + 1)
        tokens = np.zeros((width, s_len), np.int32)
        lengths = np.zeros(width, np.int32)
        starts = np.zeros(width, np.int32)
        slot_ids = np.zeros(width, np.int32)
        for j, i in enumerate(live):
            kr = k_r[i]
            tokens[j, 0] = self.slots[i].next_feed
            tokens[j, 1:kr + 1] = drafts[i, :kr]
            lengths[j] = kr + 1
            starts[j] = self.slots[i].pos_host
            slot_ids[j] = i
        in_round = set(live)
        slot_ids[n:] = [s for s in range(self.num_slots) if s not in in_round][: width - n]
        pw = bucket_pages(-(-int(starts.max()) // self.page_size), self.table_width)
        vlog = self.graphs(
            "spec_verify", (pw,),
            lambda t, n, s, st: self._forward("prefill_slots", t, n, s, starts=st,
                                              prefix_pages=pw, return_all_logits=True),
            self._host(tokens), self._host(lengths), self._host(slot_ids), self._host(starts))
        self.spec_rounds += 1
        self.steps += 1
        # acceptance: one batched argmax transfer for the greedy rows, one
        # batched rejection-sampling pass for the sampled rows
        g_host = None
        if len(samp) < n:
            g_host = vlog[..., :vocab].argmax(dim=-1).cpu().numpy()   # (width, s_len)
        accepted: dict[int, list[int]] = {}
        if samp:
            rows = [live.index(i) for i in samp]
            take = np.minimum(np.arange(kk + 1), s_len - 1)
            sel = self._tensor(np.array(samp, np.int64))
            n_emit, emitted = speculative_acceptance(
                self._tensor(np.stack([u_acc[i] for i in samp])),
                vlog[self._tensor(np.array(rows, np.int64))][:, self._tensor(take)],
                drafts_dev.index_select(0, sel), logq.index_select(0, sel),
                self._tensor(np.array([k_r[i] for i in samp], np.int64)),
                self._tensor(temps[samp]), self._tensor(topks[samp]),
                self._tensor(topps[samp]), vocab,
            )
            n_emit, emitted = n_emit.cpu().numpy(), emitted.cpu().numpy()
            for r, i in enumerate(samp):
                accepted[i] = [int(x) for x in emitted[r, : min(int(n_emit[r]), k_r[i] + 1)]]
        # commit: append each row's accepted run, truncate the target's pos
        # to the kept span, free lookahead pages past it, truncate the draft
        now = self._now()
        new_pos = np.zeros(self.num_slots, np.int32)
        mask = np.zeros(self.num_slots, bool)
        # a recurrent draft's rollback: the snapshot after each row's last
        # kept token (the rows without a live slot keep the last one)
        snap_idx = np.full(self.num_slots, kk, np.int32)
        for j, i in enumerate(live):
            slot = self.slots[i]
            kr = k_r[i]
            p = slot.pos_host
            if i in accepted:
                emitted_i = accepted[i]
            else:
                g = g_host[j]
                t = 0
                while t < kr and int(drafts[i, t]) == int(g[t]):
                    t += 1
                emitted_i = [int(x) for x in g[: t + 1]]
            if slot.first_token_time < 0:
                slot.first_token_time = now
            appended = 0
            done = False
            for tok in emitted_i:
                slot.generated.append(tok)
                appended += 1
                if self._done(slot, tok):
                    done = True
                    break
            self.spec_drafted += kr
            self.spec_emitted += appended
            self.spec_accepted += appended - 1
            new_pos[i] = p + appended
            mask[i] = True
            snap_idx[i] = appended - 1
            if done:
                # _retire frees every slot page, lookahead included: a
                # rollback first would free some twice
                self._retire(i, slot)
            else:
                self._rollback_spec_pages(i, fresh.get(i, []), p + appended)
                slot.pos_host = p + appended
                slot.next_feed = emitted_i[-1]
                self._draft_pos[i] = p + appended
        mask_t, pos_t = self._tensor(mask), self._tensor(new_pos)
        self._slots["pos"].copy_(torch.where(mask_t, pos_t, self._slots["pos"]))
        self.draft.commit(mask_t, pos_t, self._tensor(snap_idx))
        self.occupancy.append(self.pool.in_use / max(self.pool.capacity, 1))

    def decode_step(self, feed: np.ndarray) -> torch.Tensor:
        """One batched decode step over every slot: feed (num_slots, 1)
        int32 on the host → logits (num_slots, Vp), the decode graph's
        static output. Every slot writes its token at its position and
        advances ``pos``; the graph reads the cache planes, ``pos`` and the
        page table in place."""
        return self.graphs(
            "decode", (),
            lambda f: self._forward("decode", f, window=self.window, paged=self.paged_decode),
            self._host(feed))

    def step(self, *, respect_arrivals: bool = False) -> list[RequestOutput]:
        """One iteration: watchdog → admit → lazy pages (paged pool) → one
        batched decode step (or, with a draft, one speculative round) →
        retire. A slot still teacher-forcing its prompt (interleaved)
        discards its logits; a resumed slot re-feeds its last known token.
        With ``respect_arrivals`` admission compares each request's
        ``arrival_time`` with the engine clock; otherwise the queue drains
        in order as slots free up (virtual time). Returns the requests that
        finished in it."""
        n_done = len(self.finished)
        self._watchdog()
        self._admit(self._now(), respect_arrivals)
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if live and self.paged_cache:
            self._ensure_decode_pages(live)
            live = [i for i, s in enumerate(self.slots) if s is not None]
        if live and self.draft is not None:
            self._spec_round(live)
        elif live:
            self._sync_table()
            feed = np.zeros((self.num_slots, 1), np.int32)
            for i in live:
                feed[i, 0] = self.slots[i].next_feed
            logits = self.decode_step(feed)
            self.steps += 1
            if self.paged_cache:
                self.occupancy.append(self.pool.in_use / max(self.pool.capacity, 1))
            # resumed and mid-prefill slots emit nothing: no argmax, no draw
            nxt = self._next_tokens(logits, {
                i: i for i in live if not self.slots[i].pending and not self.slots[i].resumed})
            now = self._now()
            for i in live:
                slot = self.slots[i]
                slot.pos_host += 1
                if slot.pending:  # mid-prefill: the logits are teacher-forced
                    slot.next_feed = slot.pending.popleft()
                    continue
                if slot.resumed:  # an interleaved resume re-fed its history
                    slot.resumed = False
                    slot.next_feed = slot.generated[-1]
                    continue
                g = nxt[i]
                if slot.first_token_time < 0:
                    slot.first_token_time = now
                slot.generated.append(g)
                slot.next_feed = g
                if self._done(slot, g):
                    self._retire(i, slot)
        return self.finished[n_done:]

    def run(self, requests=(), *, realtime: bool = False) -> list[RequestOutput]:
        """Drain ``requests`` (submitted in arrival order) plus anything
        queued to completion. ``realtime=True`` honours arrival times on the
        engine clock, sleeping only while no slot is live and the next
        arrival is ahead; otherwise the queue replays in arrival order at
        full speed."""
        for req in sorted(requests, key=lambda r: r.arrival_time):
            self.submit(req)
        outs: list[RequestOutput] = []
        while self.has_work:
            if realtime and self.active_slots == 0:
                nxt = self.next_arrival()
                delay = 0.0 if nxt is None else nxt - self._now()
                if delay > 0:
                    time.sleep(delay)
            outs.extend(self.step(respect_arrivals=realtime))
        return sorted(outs, key=lambda o: o.uid)


# ----------------------------------------------------------------- helpers
def synthetic_prompts(cfg, n: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    """(n, prompt_len) int32 prompts: the serving CLIs' law (the synthetic
    corpus, 4 equally likely noiseless domains) drawn from ``seed + 1`` on a
    ``torch.Generator`` (the reference's law, not its bits)."""
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, n_domains=4, noise=0.0)
    gen = torch.Generator().manual_seed(seed + 1)
    return corpus.sample(gen, torch.ones(4) / 4, n, prompt_len)["tokens"].numpy()


def make_requests(cfg, *, n_requests: int, prompt_len: int, gen_tokens: int,
                  seed: int = 0, stagger: float = 0.0) -> list[Request]:
    """Synthetic trace: row r of ``synthetic_prompts`` is request r, so uid
    r's output is comparable with ``serve_batch``'s row r; request r
    arrives at ``r * stagger`` seconds."""
    prompts = synthetic_prompts(cfg, n_requests, prompt_len, seed)
    return [
        Request(uid=r, prompt=prompts[r], max_new_tokens=gen_tokens, arrival_time=r * stagger)
        for r in range(n_requests)
    ]


def serve_continuous(
    arch: str, *, smoke: bool = True, num_slots: int = 4, n_requests: int = 8,
    prompt_len: int = 32, gen_tokens: int = 32, window: int = 0, prefill: str = "chunked",
    paged_decode: bool = True, paged_cache: bool = True, page_size: int = 16,
    num_pages: int = 0, long_requests: bool = False, watermark_pages: int = 0,
    prefix_cache: bool = True, prefix_cache_pages: int = 0,
    kv_dtype: str = "fp", host_pages: int = 0, swap: bool = True, num_shards: int = 0,
    num_devices: int = 0, draft: str | None = None, spec_tokens: int = 0,
    sampling: SamplingParams | None = None, bucket_prefill: bool = True, seed: int = 0,
    stagger: float = 0.0, max_wall_s: float = 0.0, device="cuda", log_fn=print,
) -> dict:
    """Build a model with seeded random weights and an engine (the shared
    paged pool unless ``paged_cache=False``), serve a synthetic trace after
    a warm-up run, report throughput and latency. ``draft`` names a second
    config for speculative decoding, seeded like the target (so ``draft ==
    arch`` gives a same-params draft): it proposes ``spec_tokens`` tokens per
    slot per round, verified in one target dispatch. ``sampling`` samples
    every request, request r on the seed ``sampling.seed + r`` when a seed
    is given. ``bucket_prefill=False`` dispatches admission rounds at their
    exact shapes. Request r arrives at ``r * stagger`` seconds; with a
    stagger the trace is served in real time (``run(realtime=True)``).
    ``num_shards > 0`` serves tensor-parallel on a ``model``-axis mesh of
    that many shards over the visible devices of ``device``'s type, or with
    ``num_devices > 0`` over ``device`` named that many times (every shard
    on one device). The result reports ``compiles`` (specializations per
    entry point, the warm-up's included)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    mesh = None
    if num_shards > 0:
        dev = torch.device(device)
        mesh = make_serve_mesh(num_shards, devices=[dev] * num_devices if num_devices else None,
                               kind=dev.type)
    draft_model = draft_params = None
    if draft is not None:
        draft_model = build_model(get_smoke_config(draft) if smoke else get_config(draft))
        draft_params = draft_model.init(torch.Generator(device=device).manual_seed(seed),
                                        device)
    engine = ServeEngine(
        model, params, num_slots=num_slots, max_seq=prompt_len + gen_tokens, window=window,
        prefill=prefill, paged_decode=paged_decode, paged_cache=paged_cache,
        page_size=page_size, num_pages=num_pages, long_requests=long_requests,
        watermark_pages=watermark_pages, prefix_cache=prefix_cache,
        prefix_cache_pages=prefix_cache_pages, kv_dtype=kv_dtype, host_pages=host_pages,
        swap=swap, draft_model=draft_model, draft_params=draft_params, spec_tokens=spec_tokens,
        bucket_prefill=bucket_prefill, seed=seed, max_wall_s=max_wall_s, device=device,
        mesh=mesh,
    )
    reqs = make_requests(cfg, n_requests=n_requests, prompt_len=prompt_len,
                         gen_tokens=gen_tokens, seed=seed, stagger=stagger)
    if sampling is not None and not sampling.is_greedy:
        for r in reqs:  # a stream of its own per request, even under one seed
            r.sampling = dataclasses.replace(
                sampling, seed=None if sampling.seed is None else sampling.seed + r.uid)
    engine.warm([prompt_len], gen_tokens=min(2, gen_tokens), sampling=sampling)
    t0 = time.time()
    outs = engine.run(reqs, realtime=stagger > 0)
    wall = time.time() - t0
    total = sum(len(o.tokens) for o in outs)
    lat = [o.latency for o in outs] or [0.0]
    ttft = [o.ttft for o in outs] or [0.0]
    ps = engine.pool_stats
    result = {
        "arch": cfg.name,
        "device": str(engine.device),
        "num_slots": num_slots,
        "n_requests": n_requests,
        "prompt_len": prompt_len,
        "gen_tokens": gen_tokens,
        "window": window,
        "prefill": prefill,
        "paged_decode": paged_decode,
        "paged_cache": paged_cache,
        "shards": engine.num_shards,
        "mesh_axes": dict(engine.mesh.shape) if engine.mesh is not None else None,
        "prefix_cache": engine.prefix_cache,
        "kv_dtype": kv_dtype,
        "host_pages": host_pages,
        "draft": None if draft_model is None else draft_model.cfg.name,
        "spec_tokens": engine.spec_tokens,
        "sampling": None if sampling is None else dataclasses.asdict(sampling),
        "prefill_tokens": engine.prefill_tokens,
        "engine_steps": engine.steps,
        "prefill_dispatches": engine.prefill_dispatches,
        "bucket_prefill": engine.bucket_prefill,
        "compiles": engine.compiles,
        "pool": ps,
        "wall_seconds": wall,
        "tokens_per_second": total / max(wall, 1e-9),
        "generated": [o.tokens for o in outs],
        "finish_reasons": [o.finish_reason for o in outs],
        "slots": [o.slot for o in outs],
        "latency_p50": float(np.percentile(lat, 50)),
        "latency_p95": float(np.percentile(lat, 95)),
        "ttft_p50": float(np.percentile(ttft, 50)),
        "shed": [(e.uid, e.reason) for e in engine.shed],
        "timeouts": engine.timeouts,
    }
    pool_line = ""
    if ps is not None:
        pool_line = (
            f", pool occ mean {ps['occupancy_mean']:.0%} / max {ps['occupancy_max']:.0%} over "
            f"{ps['allocatable_pages']} pages, {ps['preemptions']} preemptions"
        )
    if engine.mesh is not None:
        pool_line += f", {engine.num_shards}-shard mesh"
    if engine.prefix_cache:
        pool_line += (
            f", prefix hit {ps['prefix_hit_rate']:.0%} "
            f"({ps['prefix_hit_pages']} pages, {ps['cow_copies']} CoW)"
        )
    if kv_dtype != "fp":
        pool_line += f", {kv_dtype} pages"
    if engine.host is not None:
        pool_line += (
            f", host tier {ps['swapped_out_pages']} pages swapped out / "
            f"{ps['swapped_in_pages']} in, {ps['host_demoted_pages']} demoted / "
            f"{ps['host_promote_hits']} promoted"
        )
    if engine.draft is not None:
        pool_line += (
            f", spec k={ps['spec_tokens']} accept {ps['spec_accept_rate']:.0%}, "
            f"{ps['spec_dispatches_per_token']:.2f} dispatch/tok"
        )
    log_fn(
        f"{cfg.name}: {n_requests} reqs × {gen_tokens} tok over {num_slots} slots in "
        f"{engine.steps} steps + {engine.prefill_dispatches} prefill dispatches, {wall:.2f}s "
        f"({result['tokens_per_second']:.1f} tok/s, p50 {result['latency_p50']:.2f}s "
        f"p95 {result['latency_p95']:.2f}s{pool_line})"
    )
    return result
