"""Training entry point of the port: cross-cloud federated training (the
reference's ``launch/train.py``), on the card unless ``--device cpu``.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --full --clouds 2 \\
        --local-steps 2 --steps 4 --seq-len 256 --batch 8 \\
        --compression topk+int8 --dp-clip 1.0 --dp-noise 0.1

``--checkpoint-dir DIR`` saves the global parameters every 100 steps in the
reference's checkpoint format (``repro_torch.checkpoint``)."""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.scheduler import CloudSpec, events_to_round_masks, simulate_async_schedule
from repro_torch.data import SyntheticCorpus, dirichlet_mixtures, federated_batch
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_count_params

CHECKPOINT_EVERY = 100   # steps between saves of the global params, as the reference


def run_training(
    arch: str = "stablelm-1.6b",
    *,
    smoke: bool = True,
    steps: int = 100,
    seq_len: int = 64,
    per_cloud_batch: int = 8,
    n_clouds: int = 3,
    local_steps: int = 4,
    aggregation: str = "fedavg",
    compression: str = "none",
    topk_ratio: float = 0.01,
    dp_clip: float = 0.0,
    dp_noise: float = 0.0,
    beta: float = 0.3,
    lr: float = 1e-3,
    seed: int = 0,
    outer_optimizer: str = "none",
    log_every: int = 10,
    checkpoint_dir: str = "",
    n_domains: int = 8,
    device: str = "cuda",
    log_fn=print,
    step_fn=None,
) -> dict:
    """Federated training from seeded random weights on synthetic non-IID
    data. ``step_fn(trainer, state, batch, arrived, alphas)``, if given,
    replaces ``trainer.train_step`` (a caller's timing hook). The result
    holds the trainer and its final state under "trainer" and "state"."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    fed = FederatedConfig(
        n_clouds=n_clouds, local_steps=local_steps, aggregation=aggregation,
        compression=compression, topk_ratio=topk_ratio, dp_clip=dp_clip,
        dp_noise_mult=dp_noise, outer_optimizer=outer_optimizer,
    )
    tcfg = TrainConfig(
        seq_len=seq_len, global_batch=per_cloud_batch * n_clouds, steps=steps, lr=lr,
        warmup_steps=max(steps // 10, 1), seed=seed, log_every=log_every,
        checkpoint_every=CHECKPOINT_EVERY if checkpoint_dir else 0,
        checkpoint_dir=checkpoint_dir,
    )
    trainer = FederatedTrainer(build_model(cfg), fed, tcfg)
    init_gen = torch.Generator(device=device).manual_seed(seed)
    state = trainer.init_state(init_gen, device, noise_seed=seed + 0xFED)
    n_params = tree_count_params(state["global"]["params"])
    log_fn(f"arch={cfg.name} params={n_params:,} agg={aggregation} "
           f"H={local_steps} compression={compression} device={device}")

    data_gen = torch.Generator().manual_seed(seed + 1)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, n_domains=n_domains, noise=0.1)
    mixtures = dirichlet_mixtures(data_gen, n_clouds, n_domains, beta)

    # async arrival schedule from heterogeneous cloud speeds
    clouds = [CloudSpec(f"cloud{i}", speed=1.0 + 0.5 * i) for i in range(n_clouds)]
    n_rounds = max(steps // max(local_steps, 1), 1)
    events = simulate_async_schedule(clouds, local_steps, n_rounds + 1,
                                     base_alpha=trainer.fed.async_alpha)
    arrived_rounds, alpha_rounds = events_to_round_masks(events, n_clouds, n_rounds + 1)

    step_fn = step_fn or (lambda tr, *a: tr.train_step(*a))
    ckpt = Checkpointer(tcfg.checkpoint_dir) if tcfg.checkpoint_every else None
    history = []
    t0 = time.time()
    for i in range(steps):
        batch = federated_batch(corpus, data_gen, mixtures, per_cloud_batch, seq_len)
        batch = {k: v.to(device) for k, v in batch.items()}
        rnd = min(i // max(local_steps, 1), n_rounds)
        arrived = torch.from_numpy(arrived_rounds[rnd]).to(device)
        alphas = torch.from_numpy(alpha_rounds[rnd]).to(device)
        state, metrics = step_fn(trainer, state, batch, arrived, alphas)
        if (i + 1) % tcfg.log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            acc = float(metrics["accuracy"])
            history.append({"step": i + 1, "loss": loss, "accuracy": acc,
                            "per_cloud_loss": metrics["per_cloud_loss"].tolist()})
            log_fn(f"step {i+1:5d}  loss {loss:.4f}  acc {acc:.4f}  "
                   f"({(time.time()-t0)/(i+1):.2f}s/step)")
        if ckpt and (i + 1) % tcfg.checkpoint_every == 0:
            ckpt.save(i + 1, state["global"]["params"])

    bytes_per_sync = trainer.sync_bytes_per_cloud(state["global"]["params"])
    total_syncs = steps * trainer.syncs_per_step()
    return {
        "arch": cfg.name,
        "params": n_params,
        "aggregation": aggregation,
        "compression": compression,
        "device": device,
        "final_loss": history[-1]["loss"] if history else None,
        "final_accuracy": history[-1]["accuracy"] if history else None,
        "history": history,
        "oracle_accuracy": corpus.oracle_accuracy(),
        "bytes_per_cloud_per_sync": bytes_per_sync,
        "total_comm_gb": bytes_per_sync * total_syncs * n_clouds / 1e9,
        "wall_seconds": time.time() - t0,
        "trainer": trainer,
        "state": state,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--clouds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--aggregation", default="fedavg",
                    choices=["fedavg", "dynamic", "gradient", "async"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "int8", "topk+int8"])
    ap.add_argument("--topk-ratio", type=float, default=0.01)
    ap.add_argument("--dp-clip", type=float, default=0.0)
    ap.add_argument("--dp-noise", type=float, default=0.0)
    ap.add_argument("--beta", type=float, default=0.3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--outer", default="none", choices=["none", "sgd", "nesterov"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()

    result = run_training(
        args.arch, smoke=args.smoke, steps=args.steps, seq_len=args.seq_len,
        per_cloud_batch=args.batch, n_clouds=args.clouds,
        local_steps=args.local_steps, aggregation=args.aggregation,
        compression=args.compression, topk_ratio=args.topk_ratio,
        dp_clip=args.dp_clip, dp_noise=args.dp_noise, beta=args.beta,
        lr=args.lr, seed=args.seed, outer_optimizer=args.outer,
        checkpoint_dir=args.checkpoint_dir, device=args.device,
    )
    print(f"final: loss={result['final_loss']:.4f} acc={result['final_accuracy']:.4f} "
          f"(oracle acc {result['oracle_accuracy']:.3f}); "
          f"comm {result['total_comm_gb']:.3f} GB")
    if args.json_out:
        out = {k: v for k, v in result.items() if k not in ("trainer", "state")}
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
