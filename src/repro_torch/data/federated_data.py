"""Cross-cloud data distribution: non-IID splits and per-cloud batches (the
reference's ``data/federated_data.py``, on ``torch.Generator``).

A Dirichlet(β) mixture over domains per cloud is the non-IID control
(β→∞ = IID, β→0 = each cloud sees one domain). ``federated_batch`` makes one
synchronized global step: a (n_clouds, per_cloud_batch, seq) batch stack."""
from __future__ import annotations

import torch

from repro_torch.data.pipeline import SyntheticCorpus


def dirichlet_mixtures(generator: torch.Generator, n_clouds: int, n_domains: int,
                       beta: float) -> torch.Tensor:
    """(n_clouds, n_domains) rows on the simplex; β controls skew."""
    if beta <= 0:
        # degenerate: cloud i sees only domain i (mod n_domains)
        return torch.eye(n_domains)[torch.arange(n_clouds) % n_domains]
    conc = torch.full((n_clouds, n_domains), float(beta), dtype=torch.float64)
    g = torch._standard_gamma(conc, generator=generator)
    return (g / g.sum(dim=1, keepdim=True)).float()


def federated_batch(corpus: SyntheticCorpus, generator: torch.Generator,
                    mixtures: torch.Tensor, per_cloud_batch: int, seq: int) -> dict:
    """One global step of data: leaves shaped (n_clouds, B, ...), on the CPU."""
    batches = [corpus.sample(generator, mixtures[i], per_cloud_batch, seq)
               for i in range(mixtures.shape[0])]
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def cloud_sample_counts(generator: torch.Generator, n_clouds: int, skew: float = 0.0,
                        base: int = 10_000) -> torch.Tensor:
    """n_i of formula 1. skew=0 → uniform; skew>0 → lognormal size spread."""
    if skew <= 0:
        return torch.full((n_clouds,), base, dtype=torch.int32)
    sizes = base * torch.exp(skew * torch.randn(n_clouds, generator=generator))
    return sizes.to(torch.int32).clamp(min=1)
