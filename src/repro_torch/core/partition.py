"""Data partitioning & distribution — the paper's §3.1 (the port's own copy
of the reference's ``core/partition.py``; numpy only, as there).

The partitioner decides how many samples (and how large a per-step batch
share) each cloud processes. Strategies:

* ``fixed``    — equal shards regardless of cloud capability.
* ``weighted`` — shards ∝ nominal throughput (provisioned capability).
* ``dynamic``  — the paper's §3.1 cycle ("Adjust Granularity → Balance Load
  → Monitor & Adjust"): shards rebalanced each round from *observed*
  throughput with EMA smoothing, bounded step size, and a minimum shard so
  no cloud starves.

Granularity: shard sizes are quantized to ``granule`` samples — the paper's
"data partition granularity" knob. Coarse granules cut redistribution
traffic; fine granules balance better. Ties between equal fractional parts
are broken by the same ``np.argsort`` call as the reference, so tied shares
give the same sizes."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PartitionState:
    shares: np.ndarray          # (C,) fraction of the global batch per cloud
    ema_throughput: np.ndarray  # (C,) samples/sec estimate
    moved_samples: int = 0      # cumulative redistribution traffic (samples)


@dataclasses.dataclass(frozen=True)
class Partitioner:
    strategy: str = "dynamic"          # fixed | weighted | dynamic
    n_clouds: int = 3
    granule: int = 1                   # samples per indivisible shard unit
    ema: float = 0.5
    max_step: float = 0.25             # max relative share change per round
    min_share: float = 0.05

    def init(self, nominal_throughput=None) -> PartitionState:
        c = self.n_clouds
        if self.strategy == "weighted" and nominal_throughput is not None:
            t = np.asarray(nominal_throughput, np.float64)
            shares = t / t.sum()
        else:
            shares = np.full((c,), 1.0 / c)
        ema = (
            np.asarray(nominal_throughput, np.float64)
            if nominal_throughput is not None
            else np.ones((c,))
        )
        return PartitionState(shares=shares, ema_throughput=ema)

    def quantize(self, state: PartitionState, global_batch: int) -> np.ndarray:
        """Integer per-cloud batch sizes respecting granularity + min share."""
        g = max(self.granule, 1)
        units = global_batch // g
        raw = state.shares * units
        sizes = np.floor(raw).astype(int)
        # distribute the remainder to largest fractional parts
        rem = units - sizes.sum()
        order = np.argsort(-(raw - sizes))
        sizes[order[:rem]] += 1
        sizes = np.maximum(sizes, 1)
        # renormalize if the min-clamp overflowed the budget
        while sizes.sum() > units:
            sizes[np.argmax(sizes)] -= 1
        return sizes * g

    def observe(
        self, state: PartitionState, samples_done: np.ndarray, step_times: np.ndarray
    ) -> PartitionState:
        """Feed back one round of measurements; rebalance if dynamic."""
        thr = np.asarray(samples_done, np.float64) / np.maximum(step_times, 1e-9)
        ema = self.ema * state.ema_throughput + (1 - self.ema) * thr
        if self.strategy != "dynamic":
            return PartitionState(state.shares, ema, state.moved_samples)
        target = ema / ema.sum()
        delta = np.clip(
            target - state.shares,
            -self.max_step * state.shares,
            self.max_step * np.maximum(state.shares, self.min_share),
        )
        shares = state.shares + delta
        shares = np.maximum(shares, self.min_share)
        shares = shares / shares.sum()
        moved = state.moved_samples + int(
            np.abs(shares - state.shares).sum() * 10_000
        )
        return PartitionState(shares, ema, moved)

    @staticmethod
    def round_time(batch_sizes: np.ndarray, throughput: np.ndarray) -> float:
        """Synchronous round latency = the straggler's time."""
        return float(np.max(batch_sizes / np.maximum(throughput, 1e-9)))

    @staticmethod
    def utilization(batch_sizes: np.ndarray, throughput: np.ndarray) -> float:
        """Mean busy-fraction across clouds within a synchronous round."""
        times = batch_sizes / np.maximum(throughput, 1e-9)
        return float(np.mean(times / times.max()))
