"""Heterogeneity & asynchrony scheduling — supports §3.2/§3.3 async mode.
The port's own copy of the reference's ``core/scheduler.py`` (numpy only).

Clouds have different accelerators and different network distances, so their
local rounds complete at different wall times. The scheduler simulates
arrival order and staleness for the asynchronous aggregator (formula 4) and
produces the (arrived, alpha) masks the trainer's sync round consumes.

Staleness discount: α_i(s) = α₀ / (1 + s)  where s = number of global
versions that elapsed since cloud i last synchronized (the standard
staleness-aware async-FL rule)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CloudSpec:
    name: str
    speed: float = 1.0        # relative local-step throughput
    link_latency_s: float = 0.05
    link_bandwidth: float = 1e9  # bytes/sec to the aggregation point


@dataclasses.dataclass
class AsyncEvent:
    time: float
    cloud: int
    staleness: int
    alpha: float


def simulate_async_schedule(
    clouds: list[CloudSpec],
    local_steps: int,
    n_rounds: int,
    base_alpha: float = 0.5,
    step_time: float = 1.0,
    sync_bytes: float = 0.0,
) -> list[AsyncEvent]:
    """Event-ordered async aggregation trace.

    Each cloud loops: H local steps (H·step_time/speed) + uplink transfer,
    then immediately merges into the global model. Staleness = how many
    merges happened since that cloud last pulled the global model."""
    c = len(clouds)
    next_done = np.zeros(c)
    version_at_pull = np.zeros(c, dtype=int)
    for i, spec in enumerate(clouds):
        compute = local_steps * step_time / spec.speed
        xfer = spec.link_latency_s + sync_bytes / spec.link_bandwidth
        next_done[i] = compute + xfer
    events: list[AsyncEvent] = []
    version = 0
    while len(events) < n_rounds:
        i = int(np.argmin(next_done))
        t = next_done[i]
        staleness = version - version_at_pull[i]
        alpha = base_alpha / (1.0 + staleness)
        events.append(AsyncEvent(time=t, cloud=i, staleness=int(staleness), alpha=alpha))
        version += 1
        version_at_pull[i] = version
        spec = clouds[i]
        compute = local_steps * step_time / spec.speed
        xfer = spec.link_latency_s + sync_bytes / spec.link_bandwidth
        next_done[i] = t + compute + xfer
    return events


def events_to_round_masks(
    events: list[AsyncEvent], n_clouds: int, rounds: int
) -> tuple[np.ndarray, np.ndarray]:
    """Bucket the event trace into per-round (arrived, alpha) arrays for
    masked_async_update. Round k applies events[k]."""
    arrived = np.zeros((rounds, n_clouds), bool)
    alphas = np.zeros((rounds, n_clouds), np.float32)
    for k, ev in enumerate(events[:rounds]):
        arrived[k, ev.cloud] = True
        alphas[k, ev.cloud] = ev.alpha
    return arrived, alphas


def sync_round_time(
    clouds: list[CloudSpec],
    local_steps: int,
    step_time: float,
    sync_bytes: float,
) -> float:
    """Synchronous-mode round latency: slowest compute + slowest transfer."""
    compute = max(local_steps * step_time / c.speed for c in clouds)
    xfer = max(c.link_latency_s + sync_bytes / c.link_bandwidth for c in clouds)
    return compute + xfer
