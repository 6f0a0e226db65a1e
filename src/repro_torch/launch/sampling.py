"""Per-request sampling for the serve engine: temperature / top-k / top-p.

``SamplingParams`` travels on each ``Request``. The filters follow the
serving order of the reference (temperature scale → top-k rank cut → top-p
nucleus cut on the post-top-k distribution, where the best token always
survives → categorical draw). Every function here works on a batch of rows
at once, each row with its own temperature, top-k and top-p (tensors of one
entry per row), so the engine draws for all its sampled rows in one pass.

Streams: the reference keys each request with a threefry key; the port
cannot replay those bits, so it has streams of its own with the same rules
(``request_stream``). Each request owns one host-side Philox generator,
seeded by ``SamplingParams.seed`` when given, else by the engine seed and
the request uid: never by the slot, so a retired request's slot can neither
resume nor reuse its stream. The draw itself runs on the logits' device as
an inverse-CDF lookup of host-drawn uniforms (``draw``), so a request's
tokens do not depend on its slot, its neighbours or the batch width, and
are the same on the CPU and the card up to the rounding of the CDF."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG_INF = -2.0**30
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls.

    temperature: 0 means greedy (argmax; top-k/top-p ignored).
    top_k: keep the k highest-probability tokens; 0 disables the cut.
    top_p: keep the smallest prefix of the sorted distribution with
        cumulative probability >= top_p; 1.0 disables the cut.
    seed: explicit seed for this request's stream. None lets the engine
        derive a stream from its own seed and the request uid.
    """
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None

    def __post_init__(self):
        if not self.temperature >= 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def request_stream(seed: int | None, engine_seed: int, uid: int) -> np.random.Generator:
    """A request's own stream: from its explicit ``seed``, else from the
    engine seed and its uid. The two kinds differ in their spawn key, so an
    explicit seed never replays an engine-derived stream. Negative values
    (the warm-up's uids) are taken modulo 2**64."""
    if seed is not None:
        ss = np.random.SeedSequence(seed & _MASK64, spawn_key=(0,))
    else:
        ss = np.random.SeedSequence(engine_seed & _MASK64, spawn_key=(1, uid & _MASK64))
    return np.random.Generator(np.random.Philox(ss))


def _per_row(x, rows: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(-1).expand(rows)


def filter_logits(
    logits: torch.Tensor, temperature, top_k, top_p, vocab_size: int,
) -> torch.Tensor:
    """Temperature/top-k/top-p filtered logits, row by row.

    logits (R, Vp); ``temperature``, ``top_k``, ``top_p`` one per row (or
    one for all). Returns (R, vocab_size) fp32 with every filtered-out
    column at NEG_INF: softmax of a row is the distribution its request
    samples from. Shared by the per-token draw and the speculative
    acceptance sampler, which needs the same filtered target distribution.
    Ties in the sort keep the lower token id first (a stable sort)."""
    r = logits.shape[0]
    dev = logits.device
    temps = _per_row(temperature, r, torch.float32, dev)
    ks = _per_row(top_k, r, torch.int64, dev)
    ps = _per_row(top_p, r, torch.float32, dev)
    x = logits[:, :vocab_size].float()
    # divide by a tensor: CUDA turns a division by a Python scalar into a
    # multiply by its reciprocal
    x = x / temps.clamp(min=1e-6)[:, None]
    order = torch.argsort(-x, dim=-1, stable=True)            # descending
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(vocab_size, device=dev).expand(r, -1))
    neg = torch.full_like(x, NEG_INF)
    x = torch.where((ks[:, None] > 0) & (ranks >= ks[:, None]), neg, x)
    # nucleus cut on the post-top-k distribution: keep rank i iff the mass
    # strictly before it is < top_p (the best token always survives)
    probs_sorted = torch.softmax(x.gather(1, order), dim=-1)
    before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    keep_sorted = (before < ps[:, None]) | (ps[:, None] >= 1.0)
    return torch.where(keep_sorted.gather(1, ranks), x, neg)


def draw(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row by inverse CDF: the first token whose
    cumulative probability exceeds u·(row total). probs (R, V) >= 0, u (R,)
    in [0, 1). A token of probability 0 is never drawn (rounding that
    carries u·total past the last step lands on the last token with mass)."""
    cdf = torch.cumsum(probs.float(), dim=-1)
    target = u.to(cdf)[:, None] * cdf[:, -1:]
    idx = (cdf <= target).sum(dim=-1)
    v = probs.shape[-1]
    last = v - 1 - torch.argmax((probs.flip(-1) > 0).to(torch.uint8), dim=-1)
    return torch.minimum(idx, last)


def sample_rows(
    logits: torch.Tensor, u: torch.Tensor, temperature, top_k, top_p, vocab_size: int,
) -> torch.Tensor:
    """One token id per row of ``logits`` (R, Vp) from its filtered
    distribution, drawn with the row's uniform ``u`` (R,). Every row must
    sample (temperature > 0); greedy rows take the engine's argmax."""
    flt = filter_logits(logits, temperature, top_k, top_p, vocab_size)
    return draw(torch.softmax(flt, dim=-1), u)


def sample_token(
    rng: np.random.Generator, logits: torch.Tensor, temperature: float, top_k: int,
    top_p: float, vocab_size: int,
) -> int:
    """Draw one token id from a single row of logits (Vp,), advancing the
    request's stream ``rng`` by one uniform."""
    u = torch.tensor([rng.random()], dtype=torch.float64, device=logits.device)
    return int(sample_rows(logits[None], u, temperature, top_k, top_p, vocab_size)[0])


def speculative_acceptance(
    u: torch.Tensor, tgt_logits: torch.Tensor, draft_tokens: torch.Tensor,
    draft_logq: torch.Tensor, k_live: torch.Tensor, temperature, top_k, top_p,
    vocab_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Leviathan-style rejection sampling for R sampled rows' round at once.

    tgt_logits (R, K+1, Vp): target logits at absolute positions p..p+K
    (one verify dispatch); draft_tokens (R, K): proposals d_1..d_K;
    draft_logq (R, K, V): the draft's filtered log-probs each proposal was
    drawn from; k_live (R,): how many proposals each row speculated (<= K);
    u (R, K+2) uniforms of the row's round: K acceptance tests, the
    residual draw, the bonus draw.

    Accept d_j while u_j · q_j(d_j) < p_{j-1}(d_j); the first rejection
    draws from the normalized residual max(p - q, 0) (p when the residual
    has no mass); a fully accepted row draws a bonus token from p_{k_live}.
    Emitted tokens are exact samples from the target distribution whatever
    the draft. Returns (n_emit (R,), emitted (R, K+1)): emitted[:n_emit] =
    accepted drafts + the final draw, n_emit in [1, k_live+1]."""
    r, kk = draft_tokens.shape
    dev = tgt_logits.device
    vp = tgt_logits.shape[-1]
    rep = lambda x, dt: _per_row(x, r, dt, dev).repeat_interleave(kk + 1)  # noqa: E731
    flt = filter_logits(tgt_logits.reshape(r * (kk + 1), vp), rep(temperature, torch.float32),
                        rep(top_k, torch.int64), rep(top_p, torch.float32), vocab_size)
    p = torch.softmax(flt, dim=-1).reshape(r, kk + 1, vocab_size)   # target dists
    q = torch.exp(draft_logq.float())                               # proposal dists
    d = draft_tokens.long()
    p_d = p[:, :kk].gather(2, d[..., None])[..., 0]
    q_d = q.gather(2, d[..., None])[..., 0]
    u = u.to(device=dev, dtype=torch.float32)
    k_live = k_live.to(device=dev, dtype=torch.int64)
    steps = torch.arange(kk, device=dev)
    ok = (steps[None, :] < k_live[:, None]) & (u[:, :kk] * q_d.clamp(min=1e-30) < p_d)
    # leading run of accepts: d_j lands iff every d_<j did too
    n_acc = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)
    rows = torch.arange(r, device=dev)
    p_rej = p[rows, n_acc]
    q_rej = q[rows, n_acc.clamp(max=kk - 1)]
    resid = (p_rej - q_rej).clamp(min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(mass > 0, resid / mass.clamp(min=1e-30), p_rej)
    resid_tok = draw(resid, u[:, kk])
    bonus_tok = draw(p[rows, k_live], u[:, kk + 1])
    final = torch.where(n_acc >= k_live, bonus_tok, resid_tok)
    pos = torch.arange(kk + 1, device=dev)[None, :]
    padded = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    emitted = torch.where(pos < n_acc[:, None], padded,
                          torch.where(pos == n_acc[:, None], final[:, None],
                                      torch.zeros_like(padded)))
    return n_acc + 1, emitted
