"""Model API of the port: ``build_model(cfg)`` returns a ``ModelAPI`` whose
members close over the config — the transformer part of the reference's
``ModelAPI`` that the trainer and the serving engine use, with the dense
SwiGLU FFN or, for ``arch_type == "moe"``, the MoE layer — and
``localize_config``, the per-shard config of tensor-parallel serving."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
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
    # either cache layout; ``paged`` picks the ring kernel that skips dead pages
    decode: Callable[..., tuple[dict, Any]]
    # prefill_slots(params, cache, tokens (n, S), lengths (n,), slots (n,),
    #               starts=None, prefix_pages=None, window=, return_all_logits=False)
    #     -> (cache, logits (n, Vp), or (n, S, Vp) with return_all_logits)
    prefill_slots: Callable[..., tuple[dict, Any]]
    # init_paged_cache(num_slots, num_pages, page_size, table_width, device=,
    #                  kv_dtype=) -> shared paged pool + per-slot page tables
    init_paged_cache: Callable[..., dict]
    # init_cache(batch, max_seq, window=, device=) -> lockstep ring cache (pos ())
    init_cache: Callable[..., dict]
    # init_slot_cache(num_slots, max_seq, window=, device=) -> per-slot rings (pos (B,))
    init_slot_cache: Callable[..., dict]


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


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.arch_type not in ("dense", "moe"):
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: the port serves the dense and MoE transformers; "
            "the vlm, hybrid, ssm and audio families are a later slice"
        )
    if cfg.act != "silu":
        raise NotImplementedError(f"act {cfg.act!r}: the port's FFNs are SwiGLU")
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

    return ModelAPI(cfg, init, loss, forward, decode, prefill_slots, init_paged_cache,
                    init_cache, init_slot_cache)
