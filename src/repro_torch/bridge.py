"""Weights carried between the reference package and the port.

Both packages use one parameter tree: ``embed/tok`` (Vp, D),
``embed/unembed`` (D, Vp), per-layer leaves stacked on a leading L axis —
``layers/{ln1,ln2}/scale`` (L, D), ``layers/attn/{wq,wk,wv,wo}``,
``layers/ffn/{w_gate,w_up,w_down}`` — and ``ln_f/scale`` (D,), every matrix
laid out for ``x @ W``. ``numpy_params`` draws such a tree with numpy, so the
reference (through ``jnp.asarray``) and the port can load the same weights
on a machine without JAX."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import padded_vocab


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """Random float32 weights at the reference's init scales (He for the
    matrices with fan-in = rows, 0.02 for embeddings, zero RMS scales), drawn
    leaf by leaf in a fixed order from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    vp = padded_vocab(cfg.vocab_size)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    def he(rows, cols):
        return normal((L, rows, cols), (2.0 / rows) ** 0.5)

    embed = {"tok": normal((vp, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["unembed"] = normal((d, vp), 0.02)
    return {
        "embed": embed,
        "layers": {
            "ln1": {"scale": np.zeros((L, d), np.float32)},
            "attn": {
                "wq": he(d, cfg.n_heads * hd),
                "wk": he(d, cfg.n_kv_heads * hd),
                "wv": he(d, cfg.n_kv_heads * hd),
                "wo": he(cfg.n_heads * hd, d),
            },
            "ln2": {"scale": np.zeros((L, d), np.float32)},
            "ffn": {
                "w_gate": he(d, cfg.d_ff),
                "w_up": he(d, cfg.d_ff),
                "w_down": he(cfg.d_ff, d),
            },
        },
        "ln_f": {"scale": np.zeros((d,), np.float32)},
    }


def params_from_numpy(tree: dict, cfg: ModelConfig, device, dtype=None) -> dict:
    """The port's parameters from a tree of numpy arrays (same leaf paths),
    cast to ``dtype`` (default: the config's) on ``device``."""
    dtype = dtype or getattr(torch, cfg.dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.asarray(node, np.float32)).to(device=device, dtype=dtype)

    return conv(tree)


def numpy_from_params(params: dict) -> dict:
    """The inverse of ``params_from_numpy``: float32 numpy arrays."""
    if isinstance(params, dict):
        return {k: numpy_from_params(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()
