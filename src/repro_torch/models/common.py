"""Common model machinery: vocabulary padding, embeddings, logits."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig

VOCAB_ALIGN = 256  # the reference pads the vocab so tensor-parallel shards stay aligned
NEG_INF = -(2.0**30)


def round_up(x: int, to: int) -> int:
    return int(math.ceil(x / to) * to)


def padded_vocab(vocab_size: int) -> int:
    return round_up(vocab_size, VOCAB_ALIGN)


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits with the padded-vocab columns set to -2**30. An fp32
    unembedding is used as is (no per-call copy)."""
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    logits = x.float() @ w.float()
    if logits.shape[-1] != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


def positions_for(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :].expand(b, s)
