"""Heterogeneous clouds on the PyTorch port: dynamic partitioning +
asynchronous aggregation (the reference's ``heterogeneous_clouds.py``).

    PYTHONPATH=src python examples/torch_heterogeneous_clouds.py [--device cpu] [--steps 80]

Simulates three clouds with 1×/2×/4× accelerator speeds (the paper's §3.1
"Balance Load Across Platforms" + §3.3 async scenario):
 1. the dynamic partitioner learns per-cloud batch shares from observed
    throughput (including a mid-run slowdown on one cloud),
 2. the async aggregator (formula 4) trains against the event schedule and
    is compared with synchronous FedAvg at equal wall-clock (modeled)."""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.partition import Partitioner
from repro_torch.core.scheduler import (
    CloudSpec, events_to_round_masks, simulate_async_schedule, sync_round_time,
)
from repro_torch.data import SyntheticCorpus, dirichlet_mixtures, federated_batch
from repro_torch.models.model import build_model

SPEEDS = [1.0, 2.0, 4.0]
H = 4


def partitioning_demo():
    print("=== dynamic partitioning (§3.1) ===")
    p = Partitioner(strategy="dynamic", n_clouds=3)
    state = p.init()
    speeds = np.asarray(SPEEDS)
    for r in range(30):
        if r == 15:
            speeds = np.asarray([1.0, 0.4, 4.0])
            print("  !! cloud-1 degrades to 0.4x at round 15")
        sizes = p.quantize(state, 128)
        state = p.observe(state, sizes, sizes / speeds)
        if r % 10 == 9 or r == 0:
            t = Partitioner.round_time(sizes, speeds)
            u = Partitioner.utilization(sizes, speeds)
            print(f"  round {r+1:2d}: shares={np.round(state.shares,2)} "
                  f"batch={sizes} round_time={t:.1f} util={u:.2f}")
    return state


def async_demo(device: str, steps: int) -> dict:
    print("\n=== async vs sync aggregation (§3.3 formula 4) ===")
    clouds = [CloudSpec(f"c{i}", s) for i, s in enumerate(SPEEDS)]
    n_rounds = max(steps // H, 1)
    events = simulate_async_schedule(clouds, H, n_rounds + 1, sync_bytes=1e8)
    arrived, alphas = events_to_round_masks(events, 3, n_rounds + 1)
    t_sync = n_rounds * sync_round_time(clouds, H, 1.0, 1e8)
    t_async = events[n_rounds - 1].time
    print(f"  modeled wall-clock for {n_rounds} rounds: "
          f"sync={t_sync:.0f}s async={t_async:.0f}s "
          f"(speedup {t_sync/t_async:.2f}x)")
    print(f"  mean staleness: {np.mean([e.staleness for e in events]):.2f}")

    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, n_domains=4, noise=0.1)
    mix = dirichlet_mixtures(torch.Generator().manual_seed(4), 3, 4, beta=0.3)
    final = {}
    for aggregation in ("fedavg", "async"):
        fed = FederatedConfig(n_clouds=3, local_steps=H, aggregation=aggregation)
        trainer = FederatedTrainer(model, fed, TrainConfig(steps=steps, lr=3e-3,
                                                           warmup_steps=8))
        state = trainer.init_state(torch.Generator(device=device).manual_seed(0), device)
        data = torch.Generator().manual_seed(6)
        losses = []
        for i in range(steps):
            batch = {k: v.to(device) for k, v in
                     federated_batch(corpus, data, mix, 4, 32).items()}
            rnd = min(i // H, n_rounds)
            state, m = trainer.train_step(state, batch,
                                          torch.from_numpy(arrived[rnd]).to(device),
                                          torch.from_numpy(alphas[rnd]).to(device))
            losses.append(float(m["loss"]))
        final[aggregation] = float(np.mean(losses[-8:]))
        print(f"  {aggregation:7s}: final loss {final[aggregation]:.4f}")
    return final


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args()
    partitioning_demo()
    async_demo(args.device, args.steps)


if __name__ == "__main__":
    main()
