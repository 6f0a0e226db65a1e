"""Deterministic synthetic LM corpus with domain structure (the reference's
``data/pipeline.py``, on ``torch.Generator``).

Each domain d is a noisy affine automaton over the vocabulary:

    t_{k+1} = (a_d · t_k + c_d) mod V     with prob 1−ε
    t_{k+1} ~ Uniform(V)                  with prob ε

A model that learns the per-domain transition reaches next-token accuracy
→ (1−ε); per-cloud mixtures over domains give the paper's uneven data
distribution. Batches are made on the CPU from an explicit generator (the
same law as the reference, not its threefry bits) and moved to the
device by the caller."""
from __future__ import annotations

import dataclasses

import torch

_PRIMES = torch.tensor([3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59])


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    vocab_size: int
    n_domains: int = 8
    noise: float = 0.1

    def domain_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        d = torch.arange(self.n_domains)
        return _PRIMES[d % len(_PRIMES)], (7 * d + 1) % self.vocab_size

    def sample(self, generator: torch.Generator, domain_mix: torch.Tensor, batch: int,
               seq: int) -> dict:
        """domain_mix: (n_domains,) simplex. Returns {"tokens", "labels"
        (B, seq) int32, "domain" (B,) int32}."""
        v = self.vocab_size
        dom = torch.multinomial(domain_mix.double(), batch, replacement=True,
                                generator=generator)
        a_all, c_all = self.domain_params()
        a, c = a_all[dom], c_all[dom]
        t = torch.randint(0, v, (batch,), generator=generator)
        noise_mask = torch.rand((batch, seq), generator=generator) < self.noise
        noise_tok = torch.randint(0, v, (batch, seq), generator=generator)
        toks = [t]
        for i in range(seq):
            t = torch.where(noise_mask[:, i], noise_tok[:, i], (a * t + c) % v)
            toks.append(t)
        toks = torch.stack(toks, dim=1).to(torch.int32)       # (B, seq+1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "domain": dom.to(torch.int32)}

    def oracle_accuracy(self) -> float:
        """Best achievable next-token accuracy (predict the affine map)."""
        return (1.0 - self.noise) + self.noise / self.vocab_size
