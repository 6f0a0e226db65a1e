"""Model API of the port: ``build_model(cfg)`` returns a ``ModelAPI`` whose
members close over the config — the dense-transformer part of the
reference's ``ModelAPI`` that the trainer and the serving engine use."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    # init(generator, device) -> params
    init: Callable[..., dict]
    # loss(params, batch {"tokens", "labels"} (B, S)) -> (loss, metrics)
    loss: Callable[..., tuple[Any, dict]]
    # forward(params, batch) -> logits fp32 (B, S, Vp)
    forward: Callable[..., Any]
    # decode(params, cache, tokens (B, 1), window=) -> (cache, logits (B, Vp))
    decode: Callable[..., tuple[dict, Any]]
    # prefill_slots(params, cache, tokens (n, S), lengths (n,), slots (n,),
    #               starts=None, prefix_pages=None, window=) -> (cache, logits (n, Vp))
    prefill_slots: Callable[..., tuple[dict, Any]]
    # init_paged_cache(num_slots, num_pages, page_size, table_width, device=,
    #                  kv_dtype=) -> shared paged pool + per-slot page tables
    init_paged_cache: Callable[..., dict]


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: the port serves the dense transformer; the "
            "moe, vlm, hybrid, ssm and audio families are a later slice"
        )
    if cfg.act != "silu":
        raise NotImplementedError(f"act {cfg.act!r}: the port's MLP is SwiGLU")

    def init(generator, device):
        return transformer.init_params(cfg, generator, device)

    def loss(params, batch):
        return transformer.loss_fn(cfg, params, batch, window=cfg.window)

    def forward(params, batch):
        return transformer.forward(cfg, params, batch["tokens"], window=cfg.window)[0]

    def decode(params, cache, tokens, *, window=0):
        return transformer.decode_step(cfg, params, cache, tokens, window=window)

    def prefill_slots(params, cache, tokens, lengths, slots, *, starts=None,
                      prefix_pages=None, window=0):
        return transformer.prefill_slots(
            cfg, params, cache, tokens, lengths, slots, starts=starts,
            prefix_pages=prefix_pages, window=window,
        )

    def init_paged_cache(num_slots, num_pages, page_size, table_width, *, device,
                         kv_dtype="fp"):
        return transformer.init_paged_cache(
            cfg, num_slots, num_pages, page_size, table_width, device=device,
            kv_dtype=kv_dtype,
        )

    return ModelAPI(cfg, init, loss, forward, decode, prefill_slots, init_paged_cache)
