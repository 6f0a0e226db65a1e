"""End-to-end run on the PyTorch port: federated-train a ~25M-parameter
dense LM for a few hundred steps across 3 simulated clouds, comparing the
paper's three aggregation algorithms, with checkpointing and held-out
evaluation (the reference's ``federated_lm.py``).

    PYTHONPATH=src python examples/torch_federated_lm.py [--device cpu] [--steps 300] \\
        [--d-model 320] [--checkpoint]

Table 3's experiment at a small scale: expect next-token accuracy to climb
toward the corpus oracle (0.9) as the model learns the per-domain
transition structure. On the card by default (the top-k channel kernel
compresses every sync); ``--device cpu`` runs the plain versions.
Checkpoints go under ``--checkpoint-dir`` (``build/fedlm``)."""
import argparse
import os
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import FederatedConfig, ModelConfig, TrainConfig
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data import SyntheticCorpus, dirichlet_mixtures, federated_batch
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_count_params


def model_config(d_model: int, n_layers: int) -> ModelConfig:
    return ModelConfig(
        name=f"dense-{d_model}x{n_layers}",
        arch_type="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=max(d_model // 64, 2),
        n_kv_heads=max(d_model // 128, 1),
        d_ff=int(d_model * 8 / 3) // 32 * 32,
        vocab_size=512,
        remat=False,
    )


def run(aggregation: str, args, corpus, mixtures) -> dict:
    device = args.device
    cfg = model_config(args.d_model, args.layers)
    model = build_model(cfg)
    fed = FederatedConfig(
        n_clouds=args.clouds, local_steps=args.local_steps,
        aggregation=aggregation, compression=args.compression,
        topk_ratio=0.05, cloud_sample_counts=(2000, 3000, 5000)[:args.clouds],
    )
    tcfg = TrainConfig(steps=args.steps, lr=args.lr, warmup_steps=max(args.steps // 10, 1))
    trainer = FederatedTrainer(model, fed, tcfg)
    state = trainer.init_state(torch.Generator(device=device).manual_seed(args.seed), device)
    if aggregation == "fedavg":
        print(f"params: {tree_count_params(state['global']['params']):,}")
    ckpt = (Checkpointer(os.path.join(args.checkpoint_dir, aggregation))
            if args.checkpoint else None)

    data = torch.Generator().manual_seed(args.seed + 3)
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: v.to(device) for k, v in
                 federated_batch(corpus, data, mixtures, args.batch, args.seq).items()}
        state, metrics = trainer.train_step(state, batch)
        if (i + 1) % 50 == 0 or i + 1 == args.steps:
            print(f"  [{aggregation}] step {i + 1:4d} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
            if ckpt:
                ckpt.save(i + 1, state["global"]["params"])

    # held-out IID eval of the aggregated global model
    eval_batch = corpus.sample(torch.Generator().manual_seed(777),
                               torch.ones(corpus.n_domains) / corpus.n_domains, 64, args.seq)
    with torch.no_grad():
        loss, m = model.loss(state["global"]["params"],
                             {"tokens": eval_batch["tokens"].to(device),
                              "labels": eval_batch["labels"].to(device)})
    return {"eval_loss": float(loss), "eval_acc": float(m["accuracy"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=320)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--clouds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--compression", default="topk")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", action="store_true")
    ap.add_argument("--checkpoint-dir", default=os.path.join("build", "fedlm"))
    ap.add_argument("--aggregators", default="fedavg,dynamic,gradient")
    args = ap.parse_args(argv)

    corpus = SyntheticCorpus(vocab_size=512, n_domains=6, noise=0.1)
    mixtures = dirichlet_mixtures(torch.Generator().manual_seed(9), args.clouds, 6,
                                  beta=args.beta)

    results = {}
    for aggregation in args.aggregators.split(","):
        print(f"=== {aggregation} ===")
        results[aggregation] = run(aggregation, args, corpus, mixtures)
    print(f"\nheld-out results (oracle acc {corpus.oracle_accuracy():.3f}):")
    for k, v in results.items():
        print(f"  {k:10s} loss={v['eval_loss']:.4f} acc={v['eval_acc']:.3f}")
    return results


if __name__ == "__main__":
    main()
