"""Common model machinery: vocabulary padding, embeddings, logits, and the
periodic layer layout of the recurrent families with their leaf
initializers."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def default_q_chunk(seq_len: int) -> int:
    """Query-chunk size for blockwise attention: bound live score memory."""
    if seq_len <= 2048:
        return seq_len
    for c in (1024, 512, 256):
        if seq_len % c == 0:
            return c
    return seq_len


# ------------------------------------------------- periodic layer patterns
# The recurrent families repeat a pattern of layer kinds (Griffin's (rglru,
# rglru, attn), xLSTM's mLSTM blocks with every k-th one an sLSTM). Their
# parameter and decode-cache trees keep the reference's periodic layout:
# {"periods": {"pos0": tree, ...} or None, "rest": [tree, ...]}, where
# "pos{p}" stacks the layers at pattern position p of every whole period on
# a leading axis and "rest" lists the layers after the last whole period.
# The reference scans over the periods; the port runs the layers in order,
# each on views of its slice (``periodic_layer``).
def _stack_trees(trees: list, stack):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def periodic_stack(per_layer: list, pattern_len: int, stack=torch.stack) -> tuple:
    """Per-layer trees → (periods, rest) as the reference's
    ``periodic_stack`` groups them (``stack``: ``torch.stack`` or
    ``np.stack``)."""
    n_periods = len(per_layer) // pattern_len
    rest = per_layer[n_periods * pattern_len:]
    if n_periods == 0:
        return None, rest
    periods = {f"pos{p}": _stack_trees([per_layer[i * pattern_len + p]
                                        for i in range(n_periods)], stack)
               for p in range(pattern_len)}
    return periods, rest


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def periodic_layer(tree: dict, i: int, pattern_len: int):
    """Layer i's tree from a periodic tree ({"periods", "rest"}, parameters
    or a decode cache): views of its slice of the stacked leaves, or its
    entry of ``rest``."""
    periods = tree["periods"]
    n_periods = 0 if periods is None else _first_leaf(periods).shape[0]
    if i < n_periods * pattern_len:
        return _slice_tree(periods[f"pos{i % pattern_len}"], i // pattern_len)
    return tree["rest"][i - n_periods * pattern_len]


def _slice_tree(tree, j: int):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, j) for k, v in tree.items()}
    return tree[j]


# Initializers of a leaf, the reference's: normal (He: std sqrt(2 / fan_in),
# fan_in the second-to-last dim, as every recurrent-family matrix has it;
# 0.02 for embeddings), a constant, and RG-LRU's Λ (numpy's RandomState(0)
# whatever the key, in the reference and here alike).
class LeafInit(NamedTuple):
    shape: tuple
    kind: str                  # "normal" | "const" | "lam"
    arg: float = 0.0           # normal: the std; const: the value; lam: RG-LRU's c
    f32: bool = False          # kept float32 whatever the model dtype


def he(*shape) -> LeafInit:
    return LeafInit(shape, "normal", (2.0 / max(shape[-2], 1)) ** 0.5)


def const(shape, value: float = 0.0, f32: bool = False) -> LeafInit:
    return LeafInit(tuple(shape), "const", value, f32)


def stack_inits(inits: list) -> LeafInit:
    """``periodic_stack``'s ``stack`` over leaf initializers."""
    return inits[0]._replace(shape=(len(inits), *inits[0].shape))


def lam_init(shape, c: float) -> np.ndarray:
    """RG-LRU's Λ (every layer alike, over a stacked shape too):
    softplus(Λ) uniform in [-ln 0.999 / c, -ln 0.9 / c], so a =
    exp(-c·softplus(Λ)) starts in [0.9, 0.999]; from RandomState(0)."""
    lo, hi = -np.log(0.999) / c, -np.log(0.9) / c
    u = np.random.RandomState(0).uniform(lo, hi, size=(shape[-1],))
    return np.broadcast_to(np.log(np.expm1(u)).astype(np.float32), shape).copy()


def init_leaves(specs, generator: torch.Generator, device, dtype: torch.dtype):
    """A tree of ``LeafInit`` drawn in tree order from ``generator`` on
    ``device`` (the model dtype, float32 where a leaf says so)."""
    if isinstance(specs, dict):
        return {k: init_leaves(v, generator, device, dtype) for k, v in specs.items()}
    if isinstance(specs, list):
        return [init_leaves(v, generator, device, dtype) for v in specs]
    if specs is None:
        return None
    dt = torch.float32 if specs.f32 else dtype
    if specs.kind == "normal":
        x = torch.randn(specs.shape, generator=generator, device=device, dtype=torch.float32)
        return (x * specs.arg).to(dt)
    if specs.kind == "lam":
        return torch.from_numpy(lam_init(specs.shape, specs.arg)).to(device, dt)
    return torch.full(specs.shape, specs.arg, dtype=dt, device=device)


def param_specs(cfg: ModelConfig, layer_specs, pattern: tuple) -> dict:
    """The recurrent families' parameter tree as ``LeafInit``s: the
    embeddings, the per-layer trees of ``layer_specs(cfg, kind)`` in the
    periodic layout, the final norm."""
    vp = padded_vocab(cfg.vocab_size)
    embed = {"tok": LeafInit((vp, cfg.d_model), "normal", 0.02)}
    if not cfg.tie_embeddings:
        embed["unembed"] = LeafInit((cfg.d_model, vp), "normal", 0.02)
    layers = [layer_specs(cfg, pattern[i % len(pattern)]) for i in range(cfg.n_layers)]
    periods, rest = periodic_stack(layers, len(pattern), stack_inits)
    return {"embed": embed, "periods": periods, "rest": rest,
            "ln_f": {"scale": const((cfg.d_model,))}}
