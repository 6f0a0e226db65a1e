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

``XlstmDraft``: the draft is recurrent (``arch_type == "ssm"``, e.g.
xlstm-125m), and its state cannot be truncated by position. Its re-sync
resets the refreshed rows to the empty state (``xlstm.select_rows``) and
teacher-forces the padded prompts through the decode step, each row frozen
past its own length; ``propose`` copies the state after each of its k + 1
steps into a snapshot stack of the draft's own (allocated once, outside
the graph pool, since ``commit`` reads it after the verify graph); and
``commit`` restores each row to the snapshot just after its last accepted
token (``xlstm.gather_snapshots``)."""
from __future__ import annotations

import torch

from repro_torch.launch.graphs import GraphCache
from repro_torch.launch.sampling import draw, filter_logits
from repro_torch.models import xlstm
from repro_torch.utils.tree import tree_leaves, tree_map

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


def _upcast_unembed(model, params: dict) -> dict:
    """``lm_logits`` multiplies in fp32: the draft's params with an untied
    unembedding upcast once, as the engine does for the target."""
    if model.cfg.tie_embeddings:
        return params
    return {**params, "embed": {**params["embed"],
                                "unembed": params["embed"]["unembed"].float()}}


class TransformerDraft:
    """Ring-cache draft backend (KV-cache models)."""

    def __init__(self, model, params: dict, *, num_slots: int, cap: int, spec_tokens: int,
                 device, graphs: GraphCache | None = None):
        self.model = model
        # the engine's cache (one pool, one set of counts), else its own
        self.graphs = graphs if graphs is not None else GraphCache(device)
        self.params = _upcast_unembed(model, params)
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

    def commit(self, mask: torch.Tensor, new_pos: torch.Tensor,
               snap_idx: torch.Tensor | None = None) -> None:
        """Truncate the rows in ``mask`` to their accepted position (a
        rollback, or the fully accepted row's forward move); ``snap_idx``
        is the recurrent draft's and unused here."""
        self.cache["pos"].copy_(torch.where(mask, new_pos.to(torch.int32), self.cache["pos"]))


def _copy_tree_(dst, src) -> None:
    for d, x in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(x)


class XlstmDraft:
    """Recurrent-state draft backend (``ssm`` models)."""

    def __init__(self, model, params: dict, *, num_slots: int, spec_tokens: int, device,
                 graphs: GraphCache | None = None):
        self.model = model
        self.graphs = graphs if graphs is not None else GraphCache(device)
        self.params = _upcast_unembed(model, params)
        self.spec_tokens = spec_tokens
        self.cache = model.init_cache(num_slots, 1, device=device)
        self._empty = xlstm.state_tree(model.init_cache(num_slots, 1, device=device))
        # snapshot s = the state after s + 1 of a round's k + 1 steps
        self._snaps = tree_map(lambda x: x.new_zeros((spec_tokens + 1, *x.shape)),
                               xlstm.state_tree(self.cache))
        self._drafts = self._logq = None

    def prefill_rows(self, tokens: torch.Tensor, lengths: torch.Tensor) -> None:
        """Re-sync the rows with ``lengths > 0`` from the empty state: row r
        consumes its first lengths[r] tokens; the other rows are untouched."""
        def fn(t, n):
            state = xlstm.state_tree(self.cache)
            _copy_tree_(state, xlstm.select_rows(n > 0, self._empty, state))
            for i in range(t.shape[1]):
                before = tree_map(torch.clone, state)
                self.model.decode(self.params, self.cache, t[:, i:i + 1])
                _copy_tree_(state, xlstm.select_rows(i < n, state, before))
            return ()

        self.graphs("draft_prefill", (), fn, tokens, lengths)

    def _propose(self, feed, u, greedy, temps, topks, topps):
        vocab = self.model.cfg.vocab_size
        state = xlstm.state_tree(self.cache)
        cur = feed.to(torch.int32)
        ds, lqs = [], []
        for t in range(self.spec_tokens + 1):
            _, logits = self.model.decode(self.params, self.cache, cur[:, None])
            for snap, x in zip(tree_leaves(self._snaps), tree_leaves(state)):
                snap[t].copy_(x)
            if t == self.spec_tokens:   # the trailing step: its output is dropped
                break
            cur, lq = _propose_step(logits, None if u is None else u[:, t], greedy, temps,
                                    topks, topps, vocab)
            ds.append(cur)
            lqs.append(lq)
        return torch.stack(ds, dim=1), None if u is None else torch.stack(lqs, dim=1)

    propose = TransformerDraft.propose

    def commit(self, mask: torch.Tensor, new_pos: torch.Tensor,
               snap_idx: torch.Tensor) -> None:
        """Restore every row from its accepted-point snapshot (snap_idx[r],
        clipped to 0..k). Rows without a live slot take a valid snapshot
        that the next re-sync overwrites."""
        idx = snap_idx.to(self.cache["pos"].device).clamp(0, self.spec_tokens)
        _copy_tree_(xlstm.state_tree(self.cache), xlstm.gather_snapshots(self._snaps, idx))


def make_draft_backend(model, params: dict, *, num_slots: int, cap: int, spec_tokens: int,
                       device, graphs: GraphCache | None = None):
    """The draft's state layout for a model: a ring cache where the model
    has the slot-cache API, snapshots of the recurrent state for ``ssm``
    models."""
    if model.init_slot_cache is not None and model.prefill_slots is not None:
        return TransformerDraft(model, params, num_slots=num_slots, cap=cap,
                                spec_tokens=spec_tokens, device=device, graphs=graphs)
    if model.cfg.arch_type == "ssm":
        return XlstmDraft(model, params, num_slots=num_slots, spec_tokens=spec_tokens,
                          device=device, graphs=graphs)
    raise ValueError(f"draft arch {model.cfg.name!r} ({model.cfg.arch_type}) has neither a "
                     "slot-cache API nor recurrent decode state")
