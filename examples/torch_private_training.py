"""Privacy-preserving cross-cloud training on the PyTorch port: DP
clipping/noise + secure aggregation (the reference's
``private_training.py``, the paper's §3.1 "Ensure Data Security").

    PYTHONPATH=src python examples/torch_private_training.py [--device cpu] [--steps 60]

Demonstrates:
 1. DP-FedAvg: per-cloud update clipping + calibrated Gaussian noise, with
    the privacy/utility trade-off across noise multipliers,
 2. secure aggregation: pairwise-masked updates whose masks cancel exactly
    in the cross-cloud sum (the server never sees an individual update)."""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core import privacy
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data import SyntheticCorpus, dirichlet_mixtures, federated_batch
from repro_torch.models.model import build_model


def dp_sweep(device: str, steps: int) -> dict:
    print("=== DP-FedAvg: privacy/utility trade-off ===")
    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, n_domains=4, noise=0.1)
    mix = dirichlet_mixtures(torch.Generator().manual_seed(2), 3, 4, beta=0.3)
    final = {}
    for noise_mult in (0.0, 0.3, 1.0, 3.0):
        fed = FederatedConfig(
            n_clouds=3, local_steps=2, aggregation="fedavg",
            dp_clip=0.5, dp_noise_mult=noise_mult,
        )
        trainer = FederatedTrainer(model, fed, TrainConfig(steps=steps, lr=3e-3,
                                                           warmup_steps=6))
        state = trainer.init_state(torch.Generator(device=device).manual_seed(0), device)
        data = torch.Generator().manual_seed(3)
        losses = []
        for _ in range(steps):
            batch = {k: v.to(device) for k, v in
                     federated_batch(corpus, data, mix, 4, 32).items()}
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
        final[noise_mult] = float(np.mean(losses[-8:]))
        print(f"  σ={noise_mult:3.1f}: final loss {final[noise_mult]:.4f}")
    return final


def secure_agg_demo(device: str) -> float:
    """Three clouds' masked updates summed; returns the largest per-element
    error of the secure sum against the plain fp32 sum (fixed-point
    rounding only: at most 3 · 2**-17)."""
    print("\n=== secure aggregation: masks cancel exactly ===")
    gen = torch.Generator(device=device).manual_seed(0)
    updates = [{"w": 0.01 * torch.randn((4, 6), generator=gen, device=device)}
               for _ in range(3)]
    masked = [
        privacy.mask_update(privacy.to_fixed(u), i, 3, round_idx=0)
        for i, u in enumerate(updates)
    ]
    print("  raw update[0][:3]:     ", updates[0]["w"].flatten()[:3].tolist())
    print("  masked transmit[0][:3]:", masked[0]["w"].flatten()[:3].tolist(),
          " <- uniform noise to the server")
    agg = privacy.from_fixed(privacy.secure_sum(masked), torch.float32)
    plain = updates[0]["w"] + updates[1]["w"] + updates[2]["w"]
    diff = agg["w"] - plain
    print(f"  |secure_sum - plain_sum| = {diff.norm().item():.2e} "
          f"(fixed-point quantization only)")
    return diff.abs().max().item()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    dp_sweep(args.device, args.steps)
    secure_agg_demo(args.device)


if __name__ == "__main__":
    main()
