"""Shape-keyed CUDA graphs: the port's counterpart of the reference's bounded
``jax.jit`` specializations.

The reference runs each serving forward as one compiled program per shape
bucket and counts the traces (its engine's ``compiles``). The port captures
one ``torch.cuda.CUDAGraph`` per key and replays it. A key is an entry point
("decode", "prefill_slots", ...), the static arguments the reference's jit
retraces on (a prefix-page width, whether any draft row samples), and the
shapes and dtypes of the inputs. ``GraphCache.counts[entry]`` rises once per
new key, on every device and in every mode: those counts are the engine's
``compiles``.

On the card, the first call of a key:

1. copies the inputs into fresh static buffers;
2. runs the function once eagerly on the cache's side stream. This is the
   call's real execution (the forwards write the KV cache in place and
   advance ``pos``), and the warm-up that resolves first-launch work outside
   the capture: kernel builds and loads, function attributes, the tensor-map
   encoder's lookup, the stream's cuBLAS workspace;
3. captures the function into a graph on the same stream, in the cache's one
   memory pool. Capture executes nothing;
4. copies the warm-up's outputs into the graph's static outputs and returns
   those. It does not also replay: the step would run twice.

Every later call copies its inputs into the static buffers and replays. A
capture error propagates: nothing falls back to eager dispatch. Python's
cyclic garbage collector is off while a graph is captured: a collection
there may free a dead engine's graphs, and destroying a graph is not
permitted while a stream captures (CUDA refuses it and invalidates the
capture). Engines sit in reference cycles (the prefix index's hooks are
bound methods), so their graphs go only when the collector runs, after
the capture. What a graph
reads in place (parameters, the cache planes, ``pos``, the page table) must
keep its address for the graph's life: write it in place, never rebind it.

On the CPU there are no graphs: the function runs eagerly on the static input
buffers and its outputs are copied into the static outputs, so that a caller
sees the same aliasing as on the card (an output read after the next call of
its key holds the newer values). ``enabled=False`` runs every call eagerly on
its own inputs and returns fresh outputs; it still counts keys.

The pool rule. All graphs of one cache share one memory pool, so a graph's
replay may overwrite memory that another graph's capture used. What makes
the sharing safe: a graph's static outputs are read, or copied to memory
outside the pool, before any other graph of the same cache replays. (The
draft copies its proposals and log-probs, which the acceptance test reads
after the verify, into buffers of its own.)

Launch accounting. ``build.launch`` counts launches on the host, so a
capture would count launches that never run and a replay none. The cache
takes each graph's per-kernel launch delta off ``LAUNCHES`` after its capture
and adds it back at every replay, so the counts are of kernels that ran."""
from __future__ import annotations

import gc

import torch

from repro_torch.kernels.build import LAUNCHES


def _as_tuple(out) -> tuple[tuple, bool]:
    """A function's outputs as a tuple, and whether it returned one tensor."""
    if isinstance(out, tuple):
        return out, False
    return (out,), True


def _copy_into(static: tuple, fresh: tuple) -> None:
    for s, x in zip(static, fresh):
        if s is not None:
            s.copy_(x)


class _Graph:
    """One specialization: its static input buffers and outputs, and on the
    card its graph and the kernel launches one replay makes."""

    def __init__(self, inputs: tuple, outputs: tuple, single: bool, graph=None,
                 launches: dict | None = None):
        self.inputs = inputs
        self.outputs = outputs
        self.single = single
        self.graph = graph
        self.launches = launches or {}

    def result(self):
        return self.outputs[0] if self.single else self.outputs


class GraphCache:
    """Specializations of one engine, keyed by entry point, static arguments
    and input shapes. ``cache(entry, static, fn, *inputs)`` returns
    ``fn(*inputs)``'s outputs (a tensor or a tuple of tensors and Nones).
    Inputs may live on the host; they are copied into device buffers.

    ``tap``, when set, is called as ``tap(entry, static, inputs, call)`` in
    place of every call and must return ``call()``: an instrument that sees
    each dispatch's inputs and outputs, replays included."""

    def __init__(self, device, *, enabled: bool = True, entries=()):
        self.device = torch.device(device)
        self.enabled = enabled
        self.graphed = enabled and self.device.type == "cuda"
        self.counts: dict[str, int] = {name: 0 for name in entries}
        self._graphs: dict[tuple, _Graph] = {}
        self._seen: set[tuple] = set()   # keys of the eager mode
        self._pool = self._stream = None
        self.tap = None

    def _key(self, entry: str, static: tuple, inputs: tuple) -> tuple:
        return (entry, static, tuple(None if x is None else (tuple(x.shape), x.dtype)
                                     for x in inputs))

    def __call__(self, entry: str, static: tuple, fn, *inputs):
        if self.tap is not None:
            return self.tap(entry, static, inputs, lambda: self._call(entry, static, fn, inputs))
        return self._call(entry, static, fn, inputs)

    def _call(self, entry: str, static: tuple, fn, inputs: tuple):
        key = self._key(entry, static, inputs)
        if not self.enabled:
            if key not in self._seen:
                self._seen.add(key)
                self.counts[entry] = self.counts.get(entry, 0) + 1
            return fn(*(None if x is None else x.to(self.device) for x in inputs))
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(fn, inputs) if self.graphed else self._first_eager(fn, inputs)
            self._graphs[key] = g
            self.counts[entry] = self.counts.get(entry, 0) + 1
            return g.result()
        _copy_into(g.inputs, inputs)
        if g.graph is None:
            _copy_into(g.outputs, _as_tuple(fn(*g.inputs))[0])
        else:
            g.graph.replay()
            for name, n in g.launches.items():
                LAUNCHES[name] += n
        return g.result()

    def _static_inputs(self, inputs: tuple) -> tuple:
        return tuple(None if x is None else
                     torch.empty(x.shape, dtype=x.dtype, device=self.device).copy_(x)
                     for x in inputs)

    def _first_eager(self, fn, inputs: tuple) -> _Graph:
        static = self._static_inputs(inputs)
        out, single = _as_tuple(fn(*static))
        return _Graph(static, out, single)

    def _capture(self, fn, inputs: tuple) -> _Graph:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        static = self._static_inputs(inputs)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            first, single = _as_tuple(fn(*static))    # the call's real execution
        cur.wait_stream(self._stream)
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                outputs, _ = _as_tuple(fn(*static))
        except BaseException:
            # a failed capture may leave the capture stream current
            torch.cuda.set_stream(cur)
            raise
        finally:
            if collecting:
                gc.enable()
            launches = {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}
            for k, n in launches.items():
                LAUNCHES[k] -= n
        _copy_into(outputs, first)
        return _Graph(static, outputs, single, graph, launches)

    @property
    def graphs(self) -> int:
        """Specializations held."""
        return len(self._graphs)

    def pool_bytes(self) -> int | None:
        """Device bytes the graphs' memory pool holds (0 without graphs;
        None where the allocator's snapshot does not tell pools apart)."""
        if self._pool is None:
            return 0
        total, seen = 0, False
        for seg in torch.cuda.memory._snapshot(self.device)["segments"]:
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            seen = True
            if tuple(pid) == tuple(self._pool):
                total += seg["total_size"]
        return total if seen else None
