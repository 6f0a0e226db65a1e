"""Fault-tolerant multi-replica serve router: prefix-affinity routing,
SLO-aware scheduling and token-exact failover (the port of the reference's
``launch/router.py``).

``ServeRouter`` fronts N in-process ``ServeEngine`` replicas: the serving
side of the paper's cross-cloud scheduling problem, where any cloud may slow
down, fill up or drop out in the middle of a round. It does four things:

* **Placement** (``submit`` → ``_place_pending``): a request goes to the
  replica whose prefix index already holds the longest prefix of its prompt
  (``ServeEngine.prefix_probe``: a read-only walk of the trie, no prefill, no
  LRU touch); with no predicted hit anywhere, to the least-occupied replica.
  A request no replica could ever serve is rejected at once with an
  ``AdmissionError`` naming the best-fit shortfall: the smallest margin by
  which any replica falls short.
* **Backpressure**: when every healthy replica is saturated (its live slots
  plus its queue fill its slots and the router's queue cap), the request
  waits in the router's queue and is retried (``retries`` counts attempts;
  real-time runs sleep ``backoff_s`` × the attempt); after ``max_retries``
  it is placed on the least-occupied replica anyway, so saturation degrades
  to queueing, never to failure.
* **Fault tolerance**: a ``FaultPlan`` injects kill, stall and slow faults at
  each replica's own step counts. Every round the router checks health: a
  kill surfaces as ``ReplicaFault``; a stall is found from observable state
  alone (a replica with work whose state has not changed for
  ``stall_patience`` rounds), never from the plan. The replica is marked
  dead and all its in-flight work (live slots and queue) moves through
  ``export_inflight``/``import_inflight`` to the healthy replicas: pages
  carried to the host swap back in on a layout-compatible replica with a
  host tier, other requests resume by re-prefill, and every request
  continues its own sampling stream, so the merged output is the tokens of
  a run without the fault. A slow replica keeps its work; occupancy-based
  placement moves new work away from it.
* **SLOs** ride the engines: ``priority`` orders preemption,
  ``deadline_s`` sheds expired queued requests with structured records,
  ``max_wall_s`` retires slots that stop advancing. ``router_stats``
  gathers occupancy, migrations, sheds, timeouts and retries.

The replicas share one ``model`` and one params dict (upcast for serving
once, ``engine.serving_params``; the CUDA graphs of every replica read the
same weights in place) and the engine seed, so a request's logits and its
stream are the same wherever it runs.

    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \\
        --replicas 2 --fault kill:1@8 --stagger 0.02
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.engine import (
    AdmissionError, Request, RequestOutput, ServeEngine, make_requests, serving_params,
)
from repro_torch.launch.sampling import SamplingParams
from repro_torch.models.model import build_model


class ReplicaFault(RuntimeError):
    """An injected replica failure, raised at a router step boundary: the
    in-process stand-in for a cloud's worker process dying."""

    def __init__(self, replica: int, kind: str):
        super().__init__(f"replica {replica}: injected {kind}")
        self.replica = replica
        self.kind = kind


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault schedule, keyed by each replica's own count of
    attempted steps (reproducible however the rounds interleave).

    ``kill[r] = k``: replica r's step k and every later one raise
    ``ReplicaFault``. ``stall[r] = k``: from step k the replica silently
    does nothing (the hung process the router must detect). ``slow[r] =
    (k, seconds)``: from step k every step first sleeps (a straggler, never
    fatal). Kill wins over stall over slow on one replica."""

    kill: dict[int, int] = dataclasses.field(default_factory=dict)
    stall: dict[int, int] = dataclasses.field(default_factory=dict)
    slow: dict[int, tuple[int, float]] = dataclasses.field(default_factory=dict)

    def action(self, replica: int, step: int) -> tuple[str, float] | None:
        k = self.kill.get(replica)
        if k is not None and step >= k:
            return ("kill", 0.0)
        s = self.stall.get(replica)
        if s is not None and step >= s:
            return ("stall", 0.0)
        sl = self.slow.get(replica)
        if sl is not None and step >= sl[0]:
            return ("slow", sl[1])
        return None


def parse_fault_spec(specs) -> FaultPlan:
    """The CLI's fault grammar: ``kill:R@S``, ``stall:R@S``, ``slow:R@S@SEC``
    (replica R, its own step S). Several specs make one plan."""
    plan = FaultPlan()
    for spec in specs or ():
        try:
            kind, rest = spec.split(":", 1)
            parts = rest.split("@")
            rid, step = int(parts[0]), int(parts[1])
            if kind == "kill":
                plan.kill[rid] = step
            elif kind == "stall":
                plan.stall[rid] = step
            elif kind == "slow":
                plan.slow[rid] = (step, float(parts[2]))
            else:
                raise ValueError(kind)
        except (ValueError, IndexError) as e:
            raise ValueError(f"bad fault spec {spec!r} (want kill:R@S, stall:R@S or "
                             f"slow:R@S@SEC): {e}") from None
    return plan


class ServeRouter:
    """Router over N in-process ``ServeEngine`` replicas.

    ``model``/``params`` are shared by every replica built from
    ``engine_kw`` (``replicas`` of them; ignored when ``engines`` gives a
    pre-built list, which may mix pool sizes). ``fault_plan`` is injected at
    step boundaries. ``stall_patience``: rounds without observable progress
    on a replica with work before it is declared hung. ``max_retries``:
    placement attempts while every candidate is saturated before a forced
    placement. ``backoff_s``: real-time sleep per failed attempt, times the
    attempt (virtual-time runs skip it: stepping the replicas is the
    backoff). ``max_queue``: a replica's queued-request cap that defines
    saturation (0 = twice its slots). ``time_fn`` is the clock of the router
    and of the replicas it builds."""

    def __init__(self, model=None, params=None, *, replicas: int = 2,
                 engines: list[ServeEngine] | None = None, fault_plan: FaultPlan | None = None,
                 stall_patience: int = 3, max_retries: int = 8, backoff_s: float = 0.01,
                 max_queue: int = 0, time_fn: Callable[[], float] | None = None, **engine_kw):
        if engines is not None:
            self.engines = list(engines)
        else:
            if model is None or params is None:
                raise ValueError("need model+params or pre-built engines")
            params = serving_params(model.cfg, params)  # one upcast for all replicas
            self.engines = [ServeEngine(model, params, time_fn=time_fn, **engine_kw)
                            for _ in range(replicas)]
        if not self.engines:
            raise ValueError("router needs at least one replica")
        n = len(self.engines)
        self.fault_plan = fault_plan
        self.stall_patience = stall_patience
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_queue = max_queue
        self._time_fn = time_fn or time.monotonic
        self._t0 = self._time_fn()
        self._realtime = False

        self.healthy = [True] * n
        self.fail_reason: list[str | None] = [None] * n
        self._steps = [0] * n          # attempted steps: the fault clock
        self._sig: list[tuple | None] = [None] * n
        self._no_progress = [0] * n

        self.pending: collections.deque[Request] = collections.deque()
        self._attempts: dict[int, int] = {}   # uid -> placement attempts
        self.finished: list[RequestOutput] = []
        self.shed: list[AdmissionError] = []  # router-level sheds only

        self.migrations = 0            # replica deaths that moved work
        self.migrated_requests = 0
        self.retries = 0
        self.forced_placements = 0
        self.affinity_routed = 0
        self.balance_routed = 0
        self.replica_requests = [0] * n

    # ------------------------------------------------------------- plumbing
    def _now(self) -> float:
        return self._time_fn() - self._t0

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(
            e.has_work for e, h in zip(self.engines, self.healthy) if h)

    def occupancy(self, rid: int) -> float:
        """A replica's load: its pool's fill, or the live-slot fraction of a
        ring replica (which has no pool)."""
        e = self.engines[rid]
        if e.paged_cache:
            return e.pool.in_use / max(e.pool.capacity, 1)
        return e.active_slots / max(e.num_slots, 1)

    def _queue_cap(self, rid: int) -> int:
        return self.max_queue or 2 * self.engines[rid].num_slots

    def _saturated(self, rid: int) -> bool:
        """Live slots plus queued admissions fill the slots and the queue
        cap: load counted, not stepped state, so one burst does not land
        whole on a replica that merely has not stepped yet."""
        e = self.engines[rid]
        return e.active_slots + len(e.waiting) >= e.num_slots + self._queue_cap(rid)

    def warm(self, prompt_lens, **kw) -> None:
        """Warm every replica (``ServeEngine.warm``), then restart all their
        clocks and the router's at one instant: warming one after another
        would skew the replicas' clocks, which deadlines and latencies
        compare."""
        for e in self.engines:
            e.warm(prompt_lens, **kw)
        for e in self.engines:
            e.reset_clock()
        self._t0 = self._time_fn()

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> None:
        """Accept a request, or reject it with the best-fit shortfall when
        no replica could ever serve it (every replica is probed, mixed pool
        sizes included)."""
        shorts = [e.capacity_shortfall(req) for e in self.engines]
        if min(shorts) > 0:
            best = int(np.argmin(shorts))
            raise AdmissionError(
                req.uid, "exceeds_pool",
                f"request {req.uid}: prompt {len(req.prompt)} + gen {req.max_new_tokens} "
                f"exceeds every replica's capacity; best fit is replica {best}, short "
                f"{shorts[best]} tokens (per-replica shortfalls: {shorts})")
        self.pending.append(req)

    def _choose_replica(self, req: Request, candidates: list[int]) -> int:
        """Affinity first: the candidate whose prefix index predicts the
        deepest hit (ties to the less occupied). No predicted hit anywhere:
        the least occupied, ties to the least routed, then the lowest id."""
        hits = [(self.engines[rid].prefix_probe(req.prompt), rid) for rid in candidates]
        if max(h for h, _ in hits) > 0:
            self.affinity_routed += 1
            return max(hits, key=lambda t: (t[0], -self.occupancy(t[1])))[1]
        self.balance_routed += 1
        return min(candidates,
                   key=lambda rid: (self.occupancy(rid), self.replica_requests[rid], rid))

    def _place_pending(self) -> None:
        """Move router-queued requests onto replicas, first in first out,
        stopping at the first one that cannot be placed this round (a later
        arrival must not overtake an earlier one under backpressure)."""
        now = self._now()
        while self.pending:
            req = self.pending[0]
            if self._realtime and req.arrival_time > now:
                break
            capable = [rid for rid, e in enumerate(self.engines)
                       if self.healthy[rid] and e.capacity_shortfall(req) == 0]
            if not capable:
                # every replica that could hold it has failed: shed it with a
                # record rather than tear down the healthy replicas' work
                self.pending.popleft()
                self.shed.append(AdmissionError(
                    req.uid, "no_healthy_replica",
                    f"request {req.uid}: every replica with capacity for it has failed"))
                continue
            free = [rid for rid in capable if not self._saturated(rid)]
            if not free:
                attempts = self._attempts.get(req.uid, 0) + 1
                self._attempts[req.uid] = attempts
                self.retries += 1
                if attempts <= self.max_retries:
                    if self._realtime and self.backoff_s > 0:
                        time.sleep(self.backoff_s * attempts)
                    break  # hold the queue; the replicas drain, and we retry
                free = capable  # retries exhausted: force the placement
                self.forced_placements += 1
            rid = self._choose_replica(req, free)
            self.pending.popleft()
            self.engines[rid].submit(req)
            self.replica_requests[rid] += 1

    # --------------------------------------------------------- health/fault
    def _progress_sig(self, e: ServeEngine) -> tuple:
        """Observable engine state that a healthy step changes: counters and
        the slots' write positions. Nothing the fault plan knows."""
        return (len(e.finished), e.steps, e.prefill_dispatches, len(e.waiting),
                e.shed_requests, e.timeouts, e.preemptions,
                tuple(s.pos_host if s is not None else -1 for s in e.slots))

    def _note_progress(self, rid: int) -> None:
        e = self.engines[rid]
        sig = self._progress_sig(e)
        if not e.has_work:
            self._no_progress[rid] = 0
        elif self._realtime and e.active_slots == 0 and (
                (nxt := e.next_arrival()) is not None and nxt > self._now()):
            self._no_progress[rid] = 0  # idle, waiting for a future arrival
        elif sig == self._sig[rid]:
            self._no_progress[rid] += 1
            if self._no_progress[rid] >= self.stall_patience:
                self._mark_dead(rid, "stalled (no progress)")
        else:
            self._no_progress[rid] = 0
        self._sig[rid] = sig

    def _mark_dead(self, rid: int, why: str) -> None:
        """Retire a replica and move all its in-flight work to the healthy
        ones, each request by ``_choose_replica`` among those with capacity
        for it (saturation ignored: migrated work is the oldest in the
        system and queues at the head wherever it lands)."""
        self.healthy[rid] = False
        self.fail_reason[rid] = why
        items = self.engines[rid].export_inflight()
        if not items:
            return
        if not any(self.healthy):
            raise RuntimeError(f"replica {rid} failed ({why}) with {len(items)} requests in "
                               "flight and no healthy replica remains")
        self.migrations += 1
        self.migrated_requests += len(items)
        # grouped per target in order (import puts a group at the queue head)
        per_target: dict[int, list] = {}
        for req, resume in items:
            capable = [r for r, e in enumerate(self.engines)
                       if self.healthy[r] and e.capacity_shortfall(req) == 0]
            if not capable:
                self.shed.append(AdmissionError(
                    req.uid, "no_healthy_replica",
                    f"request {req.uid}: migrated off replica {rid} but no healthy replica "
                    "has capacity for it"))
                continue
            t = self._choose_replica(req, capable)
            per_target.setdefault(t, []).append((req, resume))
            self.replica_requests[t] += 1
        for t, group in per_target.items():
            self.engines[t].import_inflight(group)

    def _step_replicas(self) -> list[RequestOutput]:
        """One round: step every healthy replica that has work, injecting
        the plan's faults at the boundary, and check each one's health.
        Returns the requests that finished in the round."""
        done: list[RequestOutput] = []
        for rid, e in enumerate(self.engines):
            if not self.healthy[rid] or not e.has_work:
                continue
            act = (self.fault_plan.action(rid, self._steps[rid])
                   if self.fault_plan is not None else None)
            self._steps[rid] += 1
            try:
                if act is not None and act[0] == "kill":
                    raise ReplicaFault(rid, "kill")
                if act is not None and act[0] == "stall":
                    self._note_progress(rid)  # nothing ran: the state is frozen
                    continue
                if act is not None and act[0] == "slow":
                    time.sleep(act[1])
                done.extend(e.step(respect_arrivals=self._realtime))
            except ReplicaFault as f:
                self._mark_dead(rid, f"killed (injected at step {self._steps[rid] - 1}): {f}")
                continue
            self._note_progress(rid)
        return done

    # ------------------------------------------------------------------ run
    def step(self) -> list[RequestOutput]:
        """One scheduling round: place pending requests, step the replicas,
        check health. For callers that drive their own loop."""
        self._place_pending()
        outs = self._step_replicas()
        self.finished.extend(outs)
        return outs

    def run(self, requests=(), *, realtime: bool = False) -> list[RequestOutput]:
        """Drain ``requests`` (submitted in arrival order) plus anything
        pending across the replicas. Outputs merge across replicas and
        migrations; shed requests are in ``shed_errors``, never here.
        ``realtime`` honours arrival times on the router's clock, sleeping
        only while no healthy replica has a live slot."""
        for req in sorted(requests, key=lambda r: r.arrival_time):
            self.submit(req)
        self._realtime = realtime
        while self.has_work:
            if not any(self.healthy):
                raise RuntimeError("every replica has failed")
            if realtime and all(e.active_slots == 0
                                for e, h in zip(self.engines, self.healthy) if h):
                nxts = [t for e, h in zip(self.engines, self.healthy) if h
                        for t in [e.next_arrival()] if t is not None]
                if not self.pending and nxts:
                    delay = min(nxts) - self._now()
                    if delay > 0:
                        time.sleep(delay)
            self.step()
        return sorted(self.finished, key=lambda o: o.uid)

    # ------------------------------------------------------------- metrics
    @property
    def shed_errors(self) -> list[AdmissionError]:
        """Every shed in the system: the router's (no healthy replica), then
        each replica's deadline sheds."""
        out = list(self.shed)
        for e in self.engines:
            out.extend(e.shed)
        return out

    @property
    def router_stats(self) -> dict:
        return {
            "replicas": len(self.engines),
            "healthy": list(self.healthy),
            "fail_reasons": list(self.fail_reason),
            "occupancy": [self.occupancy(rid) for rid in range(len(self.engines))],
            "active_slots": [e.active_slots for e in self.engines],
            "queued": [len(e.waiting) for e in self.engines],
            "replica_requests": list(self.replica_requests),
            "replica_steps": list(self._steps),
            "migrations": self.migrations,
            "migrated_requests": self.migrated_requests,
            "shed_requests": len(self.shed) + sum(e.shed_requests for e in self.engines),
            "timeouts": sum(e.timeouts for e in self.engines),
            "preemptions": sum(e.preemptions for e in self.engines),
            "retries": self.retries,
            "forced_placements": self.forced_placements,
            "affinity_routed": self.affinity_routed,
            "balance_routed": self.balance_routed,
        }


# ----------------------------------------------------------------- serving
def serve_router_continuous(
    arch: str, *, smoke: bool = True, replicas: int = 2, num_slots: int = 4,
    n_requests: int = 8, prompt_len: int = 32, gen_tokens: int = 32, window: int = 0,
    paged_cache: bool = True, page_size: int = 16, num_pages: int = 0,
    watermark_pages: int = 0, prefix_cache: bool = True,
    sampling: SamplingParams | None = None, fault_plan: FaultPlan | None = None,
    seed: int = 0, stagger: float = 0.0, max_wall_s: float = 0.0, device="cuda",
    log_fn=print,
) -> dict:
    """Build one model with seeded random weights and ``replicas`` engines
    behind a ``ServeRouter``, serve a synthetic trace after a warm-up
    (optionally under a fault plan; in real time with a ``stagger``), and
    report merged throughput, latency from arrival and the router's
    counters."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    router = ServeRouter(
        model, params, replicas=replicas, fault_plan=fault_plan, num_slots=num_slots,
        max_seq=prompt_len + gen_tokens, window=window, paged_cache=paged_cache,
        page_size=page_size, num_pages=num_pages, watermark_pages=watermark_pages,
        prefix_cache=prefix_cache, seed=seed, max_wall_s=max_wall_s, device=device,
    )
    reqs = make_requests(cfg, n_requests=n_requests, prompt_len=prompt_len,
                         gen_tokens=gen_tokens, seed=seed, stagger=stagger)
    if sampling is not None and not sampling.is_greedy:
        for r in reqs:  # a stream of its own per request, even under one seed
            r.sampling = dataclasses.replace(
                sampling, seed=None if sampling.seed is None else sampling.seed + r.uid)
    router.warm([prompt_len], gen_tokens=min(2, gen_tokens), sampling=sampling)
    t0 = time.time()
    outs = router.run(reqs, realtime=stagger > 0)
    wall = time.time() - t0
    total = sum(len(o.tokens) for o in outs)
    lat = [o.latency for o in outs] or [0.0]
    ttft = [o.ttft for o in outs] or [0.0]
    rs = router.router_stats
    result = {
        "arch": cfg.name,
        "device": str(torch.device(device)),
        "replicas": replicas,
        "num_slots": num_slots,
        "n_requests": n_requests,
        "prompt_len": prompt_len,
        "gen_tokens": gen_tokens,
        "stagger": stagger,
        "sampling": None if sampling is None else dataclasses.asdict(sampling),
        "wall_seconds": wall,
        "tokens_per_second": total / max(wall, 1e-9),
        "latency_p50": float(np.percentile(lat, 50)),
        "latency_p95": float(np.percentile(lat, 95)),
        "ttft_p50": float(np.percentile(ttft, 50)),
        "completed": len(outs),
        "shed": [(e.uid, e.reason) for e in router.shed_errors],
        "router": rs,
        "compiles": [e.compiles for e in router.engines],
        "generated": [o.tokens for o in outs],
        "finish_reasons": [o.finish_reason for o in outs],
    }
    log_fn(
        f"{cfg.name}: {len(outs)}/{n_requests} reqs over {replicas} replicas × {num_slots} "
        f"slots in {wall:.2f}s ({result['tokens_per_second']:.1f} tok/s, TTFT p50 "
        f"{result['ttft_p50']:.3f}s, latency p50 {result['latency_p50']:.2f}s from arrival); "
        f"healthy={rs['healthy']}, occ={['%.0f%%' % (100 * o) for o in rs['occupancy']]}, "
        f"{rs['migrations']} migrations ({rs['migrated_requests']} reqs), "
        f"{rs['shed_requests']} shed, {rs['retries']} retries, "
        f"affinity {rs['affinity_routed']} / balance {rs['balance_routed']}"
    )
    return result
