"""Weights and federated trainer state carried between the reference package
and the port.

Both packages use one parameter tree: ``embed/tok`` (Vp, D),
``embed/unembed`` (D, Vp), per-layer leaves stacked on a leading L axis —
``layers/{ln1,ln2}/scale`` (L, D), ``layers/attn/{wq,wk,wv,wo}``,
``layers/ffn/{w_gate,w_up,w_down}`` (the MoE family: ``layers/ffn/router``
(L, D, E), ``w_gate``/``w_up`` (L, E, D, F), ``w_down`` (L, E, F, D)) — and
``ln_f/scale`` (D,), every matrix laid out for ``x @ W``; a tied config has
no ``unembed``. The recurrent families (hybrid, ssm) keep the reference's
periodic tree: ``periods`` ({"pos0": stacked layers, ...} or None) and
``rest`` (a list of layer trees) beside ``embed`` and ``ln_f``. Pixtral
(vlm) adds ``projector/{w (D, D), b (D,)}`` to the dense tree; whisper
(audio) has ``enc/layers/{ln1, attn, ln2, mlp}`` and ``enc/ln_post``,
``dec/layers/{ln1, attn, ln_x, xattn, ln2, mlp}`` and ``dec/ln_f``, each
LayerNorm ``{scale, bias}``, each MLP ``{w_up, b_up, w_down, b_down}``.
``numpy_params`` draws such trees with numpy, so the reference (through
``jnp.asarray``) and the port can load the same weights on a machine
without JAX. The router, RG-LRU's Λ and xLSTM's gate biases stay float32 in
both packages."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import padded_vocab


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """Random float32 weights at the reference's init scales (He for the
    matrices with fan-in = rows, 0.02 for embeddings, zero RMS scales), drawn
    leaf by leaf in a fixed order from ``np.random.default_rng(seed)``. The
    recurrent families (``_numpy_periodic``) and whisper (``_numpy_whisper``)
    take their own trees; pixtral's projector is drawn after the dense tree
    (its bias, like every constant leaf of the trees of their own, at its
    init value plus N(0, 0.1²), so that a test exercises it)."""
    if cfg.arch_type in ("hybrid", "ssm"):
        return _numpy_periodic(cfg, seed)
    if cfg.arch_type == "audio":
        return _numpy_whisper(cfg, seed)
    rng = np.random.default_rng(seed)
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    vp = padded_vocab(cfg.vocab_size)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    def he(rows, cols, experts=()):
        return normal((L, *experts, rows, cols), (2.0 / rows) ** 0.5)

    embed = {"tok": normal((vp, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["unembed"] = normal((d, vp), 0.02)
    tree = {
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
            "ffn": _numpy_ffn(cfg, he),
        },
        "ln_f": {"scale": np.zeros((d,), np.float32)},
    }
    if cfg.arch_type == "vlm":
        tree["projector"] = {"w": normal((d, d), (2.0 / d) ** 0.5),
                             "b": np.float32(0.1) * rng.standard_normal(d, dtype=np.float32)}
    return tree


def _numpy_whisper(cfg: ModelConfig, seed: int) -> dict:
    """Whisper's tree: matrices and the embedding at their init scales,
    every LayerNorm scale 1 and bias 0 and every MLP bias 0 plus N(0,
    0.1²)."""
    rng = np.random.default_rng(seed)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def const(shape, value):
        return np.float32(value) + normal(shape, 0.1)

    def stack(L, cross):
        def he(rows, cols):
            return normal((L, rows, cols), (2.0 / rows) ** 0.5)

        def attn():
            return {"wq": he(d, cfg.n_heads * hd), "wk": he(d, cfg.n_kv_heads * hd),
                    "wv": he(d, cfg.n_kv_heads * hd), "wo": he(cfg.n_heads * hd, d)}

        def ln():
            return {"scale": const((L, d), 1.0), "bias": const((L, d), 0.0)}

        layers = {"ln1": ln(), "attn": attn()}
        if cross:
            layers.update(ln_x=ln(), xattn=attn())
        layers["ln2"] = ln()
        layers["mlp"] = {"w_up": he(d, f), "b_up": const((L, f), 0.0), "w_down": he(f, d),
                         "b_down": const((L, d), 0.0)}
        return layers

    vp = padded_vocab(cfg.vocab_size)
    embed = {"tok": normal((vp, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["unembed"] = normal((d, vp), 0.02)
    return {
        "embed": embed,
        "enc": {"layers": stack(cfg.encoder_layers or cfg.n_layers, False),
                "ln_post": {"scale": const((d,), 1.0), "bias": const((d,), 0.0)}},
        "dec": {"layers": stack(cfg.n_layers, True),
                "ln_f": {"scale": const((d,), 1.0), "bias": const((d,), 0.0)}},
    }


def _numpy_ffn(cfg: ModelConfig, he) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.arch_type != "moe":
        return {"w_gate": he(d, f), "w_up": he(d, f), "w_down": he(f, d)}
    e = (cfg.n_experts,)
    return {"router": he(d, cfg.n_experts), "w_gate": he(d, f, e), "w_up": he(d, f, e),
            "w_down": he(f, d, e)}


# The float32 leaves of a bf16 model, in the reference and here: the MoE
# router, RG-LRU's Λ, xLSTM's gate biases.
FLOAT32_LEAVES = ("router", "lam", "b_i", "b_f", "b_z", "b_o")


def _numpy_periodic(cfg: ModelConfig, seed: int) -> dict:
    """The hybrid's or the ssm's tree in the reference's periodic layout
    (``models/common.param_specs``), drawn in tree order: matrices and
    embeddings at their init scales, RG-LRU's Λ as the reference draws it,
    and every constant leaf (biases, norm scales, skips) at its init value
    plus N(0, 0.1²), so that a test exercises each of them."""
    from repro_torch.models import rglru, xlstm
    from repro_torch.models.common import lam_init, param_specs

    rng = np.random.default_rng(seed)
    mod = rglru if cfg.arch_type == "hybrid" else xlstm

    def draw(spec):
        if isinstance(spec, dict):
            return {k: draw(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [draw(v) for v in spec]
        if spec is None:
            return None
        if spec.kind == "lam":
            return lam_init(spec.shape, spec.arg)
        x = rng.standard_normal(spec.shape, dtype=np.float32)
        if spec.kind == "normal":
            return x * np.float32(spec.arg)
        return np.float32(spec.arg) + np.float32(0.1) * x

    return draw(param_specs(cfg, mod.layer_specs, mod.pattern(cfg)))


def params_from_numpy(tree: dict, cfg: ModelConfig, device, dtype=None) -> dict:
    """The port's parameters from a tree of numpy arrays (same leaf paths),
    cast to ``dtype`` (default: the config's) on ``device``; the
    ``FLOAT32_LEAVES`` stay float32."""
    dtype = dtype or getattr(torch, cfg.dtype)

    def conv(node, key=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if node is None:
            return None
        # a copy: the port updates tensors in place, and must never write
        # into the caller's arrays
        return torch.from_numpy(np.array(node, np.float32)).to(
            device=device, dtype=torch.float32 if key in FLOAT32_LEAVES else dtype)

    return conv(tree)


def numpy_from_params(params: dict) -> dict:
    """The inverse of ``params_from_numpy``: float32 numpy arrays."""
    if isinstance(params, dict):
        return {k: numpy_from_params(v) for k, v in params.items()}
    if isinstance(params, list):
        return [numpy_from_params(v) for v in params]
    if params is None:
        return None
    return params.detach().float().cpu().numpy()


def _stack_clouds(trees: list) -> dict:
    """Per-cloud trees → one numpy tree with a leading cloud axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_clouds([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack_clouds([t[i] for t in trees]) for i in range(len(trees[0]))]
    if trees[0] is None:
        return None
    return np.stack([numpy_from_params(t) for t in trees])


def _unstack_cloud(tree: dict, c: int) -> dict:
    if isinstance(tree, dict):
        return {k: _unstack_cloud(v, c) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unstack_cloud(v, c) for v in tree]
    if tree is None:
        return None
    return tree[c]


def trainer_state_from_numpy(tree: dict, cfg: ModelConfig, device, *,
                             noise_seed: int = 0xFED) -> dict:
    """The port's ``FederatedTrainer`` state from the reference trainer's
    state as numpy arrays (``jax.tree_util.tree_map(np.asarray, state)``):
    the stacked cloud params and AdamW m, v and count, the global params,
    the outer momentum, ``ef``, ``loss_accum``, ``step`` and
    ``sample_counts``. The reference's PRNG key is not carried: the DP noise
    generator is seeded with ``noise_seed``."""
    n = len(tree["sample_counts"])

    def f32(x):
        return params_from_numpy(x, cfg, device, torch.float32)

    opt = tree["clouds"]["opt"]
    state = {
        "clouds": [{
            "params": params_from_numpy(_unstack_cloud(tree["clouds"]["params"], c), cfg,
                                        device),
            "opt": {"m": f32(_unstack_cloud(opt["m"], c)), "v": f32(_unstack_cloud(opt["v"], c)),
                    "count": int(np.asarray(opt["count"])[c])},
        } for c in range(n)],
        "global": {"params": params_from_numpy(tree["global"]["params"], cfg, device),
                   "outer": f32(tree["global"]["outer"])},
        "sample_counts": f32(tree["sample_counts"]),
        "loss_accum": f32(tree["loss_accum"]),
        "step": int(np.asarray(tree["step"])),
        "rng": torch.Generator(device=device).manual_seed(noise_seed),
    }
    if "ef" in tree:
        state["ef"] = [f32(_unstack_cloud(tree["ef"], c)) for c in range(n)]
    return state


def numpy_from_trainer_state(state: dict) -> dict:
    """The inverse of ``trainer_state_from_numpy``: float32 numpy arrays in
    the reference trainer's layout (cloud axis leading), without ``rng``."""
    clouds = state["clouds"]
    out = {
        "clouds": {
            "params": _stack_clouds([c["params"] for c in clouds]),
            "opt": {"m": _stack_clouds([c["opt"]["m"] for c in clouds]),
                    "v": _stack_clouds([c["opt"]["v"] for c in clouds]),
                    "count": np.asarray([c["opt"]["count"] for c in clouds], np.int32)},
        },
        "global": {"params": numpy_from_params(state["global"]["params"]),
                   "outer": numpy_from_params(state["global"]["outer"])},
        "sample_counts": numpy_from_params(state["sample_counts"]),
        "loss_accum": numpy_from_params(state["loss_accum"]),
        "step": np.asarray(state["step"], np.int32),
    }
    if "ef" in state:
        out["ef"] = _stack_clouds(state["ef"])
    return out
