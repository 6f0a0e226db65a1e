"""Quickstart on the PyTorch port: 3 clouds federated-train a small LM (the
reference's ``quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--steps 60]

Walks the public API end to end: pick an architecture config, build the
model, configure the paper's federated knobs (aggregation formula, local
steps, compression, privacy), and train on a non-IID synthetic corpus. On
the card by default (the channel's top-k kernel compresses every sync);
``--device cpu`` runs the plain versions."""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data import SyntheticCorpus, dirichlet_mixtures, federated_batch
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_count_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=48)
    args = ap.parse_args(argv)
    device = args.device

    # 1. pick an architecture (any of the 10 ids works; smoke = a small size)
    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg)

    # 2. the paper's federated configuration (§3.1-3.3)
    fed = FederatedConfig(
        n_clouds=3,
        local_steps=4,               # H local steps between cross-cloud syncs
        aggregation="dynamic",       # formula 2: softmax(-loss) weighting
        compression="topk",          # §3.2 update sparsification
        topk_ratio=0.05,
        error_feedback=True,
    )
    train = TrainConfig(steps=args.steps, lr=3e-3, warmup_steps=max(args.steps // 10, 1))
    trainer = FederatedTrainer(model, fed, train)

    state = trainer.init_state(torch.Generator(device=device).manual_seed(0), device)
    n_params = tree_count_params(state["global"]["params"])
    print(f"model: {cfg.name}  params={n_params:,}  device={device}")
    print(f"sync payload per cloud: "
          f"{trainer.sync_bytes_per_cloud(state['global']['params']) / 1e6:.2f} MB "
          f"(raw would be {n_params * 2 / 1e6:.2f} MB)")

    # 3. non-IID data: each cloud samples its own Dirichlet domain mixture
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, n_domains=4, noise=0.1)
    mixtures = dirichlet_mixtures(torch.Generator().manual_seed(1), fed.n_clouds, 4, beta=0.2)

    # 4. train
    data = torch.Generator().manual_seed(2)
    losses = []
    for i in range(args.steps):
        batch = {k: v.to(device) for k, v in
                 federated_batch(corpus, data, mixtures, per_cloud_batch=4,
                                 seq=args.seq).items()}
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            print(f"step {i + 1:3d}  loss {losses[-1]:.4f}  "
                  f"acc {float(metrics['accuracy']):.3f}  synced={bool(metrics['synced'])}")

    print(f"done. oracle accuracy for this corpus: {corpus.oracle_accuracy():.3f}")
    return {"params": n_params, "losses": losses}


if __name__ == "__main__":
    main()
