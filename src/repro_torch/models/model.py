"""Model API of the port: ``build_model(cfg)`` returns a ``ModelAPI`` whose
members close over the config — the transformer part of the reference's
``ModelAPI`` that the trainer and the serving engine use, with the dense
gated FFN or, for ``arch_type == "moe"``, the MoE layer; the recurrent
families (``"hybrid"``: recurrentgemma, ``models/rglru.py``; ``"ssm"``:
xLSTM, ``models/xlstm.py``) with whole-prompt prefill and decode and no
slot-cache API, as in the reference — and ``localize_config``, the
per-shard config of tensor-parallel serving."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, transformer, xlstm
from repro_torch.models.moe import MOE_FFN


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    # init(generator, device) -> params
    init: Callable[..., dict]
    # loss(params, batch {"tokens", "labels"} (B, S)) -> (loss, metrics)
    loss: Callable[..., tuple[Any, dict]]
    # forward(params, batch) -> logits fp32 (B, S, Vp)
    forward: Callable[..., Any]
    # decode(params, cache, tokens (B, 1), window=, paged=) -> (cache, logits (B, Vp));
    # either cache layout; ``paged`` picks the ring kernel that skips dead pages.
    # The cache is updated in place (a CUDA graph replays the step on its tensors)
    decode: Callable[..., tuple[dict, Any]]
    # init_cache(batch, max_seq, window=, device=) -> lockstep decode cache (pos ())
    init_cache: Callable[..., dict]
    # The slot-cache API of continuous batching (None where the arch has none,
    # as in the reference: the recurrent families):
    # prefill_slots(params, cache, tokens (n, S), lengths (n,), slots (n,),
    #               starts=None, prefix_pages=None, window=, return_all_logits=False)
    #     -> (cache, logits (n, Vp), or (n, S, Vp) with return_all_logits)
    prefill_slots: Callable[..., tuple[dict, Any]] | None = None
    # init_paged_cache(num_slots, num_pages, page_size, table_width, device=,
    #                  kv_dtype=) -> shared paged pool + per-slot page tables
    init_paged_cache: Callable[..., dict] | None = None
    # init_slot_cache(num_slots, max_seq, window=, device=) -> per-slot rings (pos (B,))
    init_slot_cache: Callable[..., dict] | None = None
    # prefill(params, tokens (B, S), window=, cache_window=) -> (decode cache at
    # pos S, logits (B, Vp) of the last position): the recurrent families'
    # whole-prompt prefill
    prefill: Callable[..., tuple[dict, Any]] | None = None


def localize_config(cfg: ModelConfig, shards: int) -> ModelConfig:
    """Per-shard view of a tensor-parallel-served config: each shard sees
    its slice of the attention heads and of the KV pages, so the head
    counts divide (and head_dim is pinned, which would otherwise re-derive
    from the unchanged d_model); the shard's attention is then the
    unsharded math on that slice. The FFN (dense or MoE: router and
    experts alike) is replicated, as in the reference."""
    if shards == 1:
        return cfg
    if cfg.n_heads % shards or cfg.n_kv_heads % shards:
        raise ValueError(
            f"{cfg.name}: n_heads={cfg.n_heads} / n_kv_heads={cfg.n_kv_heads}"
            f" must both divide by the model-axis size {shards}"
        )
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // shards,
        n_kv_heads=cfg.n_kv_heads // shards,
        head_dim=cfg.resolved_head_dim,
    )


def _recurrent_api(cfg: ModelConfig, mod) -> ModelAPI:
    """The hybrid (``rglru``) or ssm (``xlstm``) family: ``mod`` holds its
    init, loss, forward, decode cache, decode step and prefill."""
    def init(generator, device):
        return mod.init_params(cfg, generator, device)

    def loss(params, batch):
        return mod.loss_fn(cfg, params, batch)

    def forward(params, batch):
        return mod.forward(cfg, params, batch["tokens"])[0]

    def decode(params, cache, tokens, *, window=0, paged=True):
        return mod.decode_step(cfg, params, cache, tokens, window=window, paged=paged)

    def init_cache(batch, max_seq, *, window=0, device):
        return mod.init_decode_cache(cfg, batch, max_seq, window=window, device=device)

    def prefill(params, tokens, *, window=0, cache_window=0):
        return mod.prefill(cfg, params, tokens, window=window, cache_window=cache_window)

    return ModelAPI(cfg, init, loss, forward, decode, init_cache, prefill=prefill)


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.arch_type not in ("dense", "moe", "hybrid", "ssm"):
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: the port serves the dense and MoE transformers "
            "and the recurrent families; the vlm and audio families are a later slice"
        )
    if cfg.act not in ("silu", "gelu"):
        raise NotImplementedError(f"act {cfg.act!r}: the port's MLPs are SwiGLU and GeGLU")
    if cfg.arch_type == "hybrid":
        return _recurrent_api(cfg, rglru)
    if cfg.arch_type == "ssm":
        return _recurrent_api(cfg, xlstm)
    ffn = MOE_FFN if cfg.arch_type == "moe" else transformer.DENSE_FFN

    def init(generator, device):
        return transformer.init_params(cfg, generator, device, ffn)

    def loss(params, batch):
        return transformer.loss_fn(cfg, params, batch, ffn=ffn, window=cfg.window)

    def forward(params, batch):
        return transformer.forward(cfg, params, batch["tokens"], ffn=ffn,
                                   window=cfg.window)[0]

    def decode(params, cache, tokens, *, window=0, paged=True):
        return transformer.decode_step(cfg, params, cache, tokens, ffn=ffn, window=window,
                                       paged=paged)

    def prefill_slots(params, cache, tokens, lengths, slots, *, starts=None,
                      prefix_pages=None, window=0, return_all_logits=False):
        return transformer.prefill_slots(
            cfg, params, cache, tokens, lengths, slots, starts=starts,
            prefix_pages=prefix_pages, ffn=ffn, window=window,
            return_all_logits=return_all_logits,
        )

    def init_paged_cache(num_slots, num_pages, page_size, table_width, *, device,
                         kv_dtype="fp"):
        return transformer.init_paged_cache(
            cfg, num_slots, num_pages, page_size, table_width, device=device,
            kv_dtype=kv_dtype,
        )

    def init_cache(batch, max_seq, *, window=0, device):
        return transformer.init_decode_cache(cfg, batch, max_seq, window=window, device=device)

    def init_slot_cache(num_slots, max_seq, *, window=0, device):
        return transformer.init_decode_cache(cfg, num_slots, max_seq, window=window,
                                             per_slot=True, device=device)

    return ModelAPI(cfg, init, loss, forward, decode, init_cache, prefill_slots=prefill_slots,
                    init_paged_cache=init_paged_cache, init_slot_cache=init_slot_cache)
