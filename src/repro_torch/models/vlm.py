"""Pixtral-12B: the dense decoder over a multimodal prefix.
[hf:mistralai/Pixtral-12B-2409]

As in the reference, the vision tower is a stub: the inputs carry
precomputed patch embeddings (B, vision_seq, D). A learned projector
(``projector/w`` (D, D), ``projector/b`` (D,)) maps them into the decoder's
embedding space, in front of the token embeddings; the training loss covers
the text region only. Everything after that is the dense decoder of
``models/transformer.py``: ``forward_embeds`` for training, ``prefill_embeds``
(causal flash prefill into the ring caches) for the multimodal prefill, and
its ``init_decode_cache`` and ``decode_step`` once the prefix is cached."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import embed_tokens, lm_logits, positions_for
from repro_torch.models.layers import cross_entropy_loss, he_init


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """The dense decoder's weights, then the projector (He, zero bias)."""
    params = tfm.init_params(cfg, generator, device)
    dt = getattr(torch, cfg.dtype)
    params["projector"] = {
        "w": he_init((cfg.d_model, cfg.d_model), dt, generator, device),
        "b": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    return params


def _multimodal_embeds(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """[projected patch embeddings ; token embeddings] along the sequence."""
    proj = batch["patch_embeds"] @ params["projector"]["w"] + params["projector"]["b"]
    toks = embed_tokens(params["embed"], batch["tokens"])
    return torch.cat([proj.to(toks.dtype), toks], dim=1)


def forward(cfg: ModelConfig, params: dict, batch: dict):
    """{"patch_embeds" (B, P, D), "tokens" (B, S)} → (logits fp32 (B, P + S,
    Vp), aux 0)."""
    x = _multimodal_embeds(cfg, params, batch)
    x, aux = tfm.forward_embeds(cfg, params, x, positions_for(x[..., 0]))
    return lm_logits(params["embed"], x, cfg), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Next-token loss on the text region only (the image prefix is left
    out)."""
    logits, _ = forward(cfg, params, batch)
    n_patch = batch["patch_embeds"].shape[1]
    loss, acc = cross_entropy_loss(logits[:, n_patch:], batch["labels"], batch.get("mask"))
    return loss, {"loss": loss, "accuracy": acc}


# Once the prefix is cached, decode is the dense decoder's.
init_decode_cache = tfm.init_decode_cache
decode_step = tfm.decode_step


def prefill(cfg: ModelConfig, params: dict, batch: dict, *, window: int = 0,
            cache_window: int = 0) -> tuple[dict, torch.Tensor]:
    """The image prefix and the prompt in one causal prefill: (the decode
    cache at pos P + S, logits (B, Vp) of the last position)."""
    return tfm.prefill_embeds(cfg, params, _multimodal_embeds(cfg, params, batch),
                              window=window, cache_window=cache_window)
