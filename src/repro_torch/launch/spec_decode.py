"""Draft-model backends for paged speculative decoding.

The engine's speculative round is draft-propose → one verify dispatch →
accept/rollback (``ServeEngine._spec_round``). This module owns the draft
side: a second, cheap model that runs k sequential decode steps per round,
so that the target verifies all k proposals in ONE batched suffix-prefill
dispatch.

``TransformerDraft``: the draft is a KV-cache model with its own per-slot
contiguous ring of capacity ``cap + k + 1`` (a request at the engine's
token limit still has k lookahead rows; no paging, the draft's KV is
small), rounded up to a multiple of 64 so that the ring decode kernel skips
dead pages. Its re-sync is a cold prefill of the rows' streams (the
``flash_prefill`` kernel), its proposals are decode steps over the rings
(``paged_decode_ring``), and rollback after a rejection is a masked
position truncation: ring rows past the accepted point drop out of the
validity mask and are overwritten in the next round.

Both ends run at the full ``num_slots`` width every round; dead rows carry
length-0 or masked work. Proposals use the filter chain of the target's
sampler and collect each step's filtered log-probs q (the acceptance test
needs q(d)); greedy rows take the argmax of the raw logits and have no q.
After ``propose`` the draft has consumed k+1 tokens past each row's
position (k proposals and one trailing step feeding the last one, its
output dropped), so a fully accepted row (k accepts and the bonus token)
moves forward to ``pos + k + 1`` without another dispatch; ``commit`` then
truncates every row to its accepted length.

Random draws: the engine passes each sampled row k uniforms per round from
the request's stream, disjoint from the uniforms of its acceptance test.

Both ends run through the engine's ``GraphCache``: the re-sync prefill as
"draft_prefill", one graph per length bucket, and the k proposal steps with
the trailing step as ONE "draft_propose" graph, keyed by whether any row
samples (the all-greedy variant skips the filter and returns no q). That
second key is the one place where the port's count may exceed the
reference's, whose one propose trace draws for every row. The proposals
and their log-probs are read by the acceptance test after the verify
graph has replayed, so ``propose`` copies them out of the graph pool into
buffers of the draft's own.

The reference's recurrent draft (``XlstmDraft``, snapshot rollback for
``ssm`` models) needs the xlstm family, which the port does not have yet."""
from __future__ import annotations

import torch

from repro_torch.launch.graphs import GraphCache
from repro_torch.launch.sampling import draw, filter_logits

RING_ALIGN = 64  # the ring decode kernel's smallest page


def _propose_step(logits: torch.Tensor, u_t: torch.Tensor | None, greedy: torch.Tensor,
                  temps: torch.Tensor, topks: torch.Tensor, topps: torch.Tensor,
                  vocab: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One proposal step's tokens (B,) and filtered log-probs (B, V) for
    every row. Greedy rows take the argmax of the raw logits (the target
    engine's greedy draw on the same logits); sampled rows draw from the
    filtered distribution with their uniform of this step. Greedy rows'
    filter runs at temperature 1 only to keep their (unread) q finite.
    ``u_t`` None (no sampled row): argmax only, and no q."""
    d_g = logits[:, :vocab].argmax(dim=-1)
    if u_t is None:
        return d_g.to(torch.int32), None
    flt = filter_logits(logits, torch.where(greedy, torch.ones_like(temps), temps), topks,
                        topps, vocab)
    d_s = draw(torch.softmax(flt, dim=-1), u_t)
    d = torch.where(greedy, d_g, d_s).to(torch.int32)
    return d, torch.log_softmax(flt, dim=-1)


class TransformerDraft:
    """Ring-cache draft backend (KV-cache models)."""

    def __init__(self, model, params: dict, *, num_slots: int, cap: int, spec_tokens: int,
                 device, graphs: GraphCache | None = None):
        self.model = model
        # the engine's cache (one pool, one set of counts), else its own
        self.graphs = graphs if graphs is not None else GraphCache(device)
        # lm_logits multiplies in fp32: upcast the unembedding once, as the
        # engine does for the target
        if not model.cfg.tie_embeddings:
            params = {**params, "embed": {
                **params["embed"], "unembed": params["embed"]["unembed"].float(),
            }}
        self.params = params
        self.spec_tokens = spec_tokens
        self.cap = -(-(cap + spec_tokens + 1) // RING_ALIGN) * RING_ALIGN
        self.cache = model.init_slot_cache(num_slots, self.cap, device=device)
        self._slots = torch.arange(num_slots, device=device)
        self._drafts = self._logq = None   # the proposals, outside the graph pool

    def prefill_rows(self, tokens: torch.Tensor, lengths: torch.Tensor) -> None:
        """Re-sync the rows with ``lengths > 0``: row r's first lengths[r]
        tokens overwrite its ring from slot 0 and its position becomes
        lengths[r]; length-0 rows are untouched."""
        def fn(t, n):
            self.model.prefill_slots(self.params, self.cache, t, n, self._slots)
            return ()

        self.graphs("draft_prefill", (), fn, tokens, lengths)

    def _propose(self, feed, u, greedy, temps, topks, topps):
        vocab = self.model.cfg.vocab_size
        cur = feed.to(torch.int32)
        ds, lqs = [], []
        for t in range(self.spec_tokens):
            _, logits = self.model.decode(self.params, self.cache, cur[:, None])
            cur, lq = _propose_step(logits, None if u is None else u[:, t], greedy, temps,
                                    topks, topps, vocab)
            ds.append(cur)
            lqs.append(lq)
        # the trailing step feeds the last draft: a fully accepted row needs
        # the draft to have seen all k proposals in the next round
        self.model.decode(self.params, self.cache, cur[:, None])
        return torch.stack(ds, dim=1), None if u is None else torch.stack(lqs, dim=1)

    def propose(self, feed: torch.Tensor, u: torch.Tensor | None, greedy: torch.Tensor,
                temps: torch.Tensor, topks: torch.Tensor,
                topps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """k draft tokens for every row: (drafts (B, k) int32, logq (B, k, V)
        or None when ``u`` is None, i.e. every row is greedy), in the
        draft's own buffers (valid until the next ``propose``). ``u`` (B, k)
        holds each row's uniforms of this round. The rings advance k+1
        positions."""
        drafts, logq = self.graphs("draft_propose", (u is not None,), self._propose, feed, u,
                                   greedy, temps, topks, topps)
        if self._drafts is None:
            self._drafts = torch.empty_like(drafts)
        self._drafts.copy_(drafts)
        if logq is None:
            return self._drafts, None
        if self._logq is None:
            self._logq = torch.empty_like(logq)
        self._logq.copy_(logq)
        return self._drafts, self._logq

    def commit(self, mask: torch.Tensor, new_pos: torch.Tensor) -> None:
        """Truncate the rows in ``mask`` to their accepted position (a
        rollback, or the fully accepted row's forward move)."""
        self.cache["pos"].copy_(torch.where(mask, new_pos.to(torch.int32), self.cache["pos"]))


def make_draft_backend(model, params: dict, *, num_slots: int, cap: int, spec_tokens: int,
                       device, graphs: GraphCache | None = None) -> TransformerDraft:
    """The draft's state layout for a model: a ring cache for the models
    with the slot-cache API. Recurrent (``ssm``) drafts are not ported."""
    if model.cfg.arch_type == "ssm":
        raise NotImplementedError(
            f"draft {model.cfg.name!r} is recurrent (ssm): its snapshot-rollback backend "
            "needs the xlstm family, a later slice of the port")
    return TransformerDraft(model, params, num_slots=num_slots, cap=cap,
                            spec_tokens=spec_tokens, device=device, graphs=graphs)
