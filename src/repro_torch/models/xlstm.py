"""xLSTM: mLSTM (matrix memory, parallelizable) and sLSTM (scalar memory,
recurrent weights) blocks [arXiv:2405.04517]; the port of the reference's
``models/xlstm.py``.

* mLSTM trains and prefills in its stabilized parallel (quadratic) form,
  an attention-like product with the exponential-gate decay matrix D,
  query-chunked like attention; it decodes with the O(1) update of the
  matrix memory C ∈ R^{h×d×d}.
* sLSTM has block-diagonal recurrent weights, so it steps over time. In
  training the step loop is ``SlstmScan``, a ``torch.autograd.Function``
  (the reference's ``jax.custom_vjp``): the reverse-time loop computes only
  the per-step pre-activation deltas and the (dh, dc, dn) carry chain, and
  the recurrent-weight gradients are one batched product over (S, B) after
  the loop.
* Every ``cfg.slstm_every``-th block is sLSTM, the rest mLSTM, in the
  reference's periodic layout (``common.periodic_stack``).

The xLSTM recurrences reach no kernel in the reference and stay plain torch
here. A decode step writes every state of the cache in place (c, n, m, h,
the conv tails, ``pos``), so that a CUDA graph of the step replays on the
same tensors. ``select_rows`` and ``gather_snapshots`` serve the recurrent
speculative draft (``launch/spec_decode.XlstmDraft``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    const, embed_tokens, he, init_leaves, lm_logits, param_specs, periodic_layer,
    periodic_stack,
)
from repro_torch.models.layers import cross_entropy_loss, gelu, rms_norm
from repro_torch.models.rglru import causal_conv
from repro_torch.utils.tree import tree_map


def pattern(cfg: ModelConfig) -> tuple[str, ...]:
    if cfg.slstm_every and cfg.slstm_every > 0:
        return tuple(["mlstm"] * (cfg.slstm_every - 1) + ["slstm"])
    return ("mlstm",)


def _inner(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model  # mLSTM projection factor 2


# ------------------------------------------------------------------- params
def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    if kind == "mlstm":
        inner = _inner(cfg)
        blk = {
            "w_up": he(d, 2 * inner), "conv_w": he(4, inner), "conv_b": const((inner,)),
            "wq": he(inner, inner), "wk": he(inner, inner), "wv": he(inner, inner),
            "w_i": he(inner, h), "b_i": const((h,), 0.0, f32=True),
            "w_f": he(inner, h), "b_f": const((h,), 3.0, f32=True),   # keep memory
            "skip": const((inner,), 1.0), "gn": const((inner,), 1.0),
            "w_down": he(inner, d),
        }
    else:
        dh = d // h
        ff = max(1, int(d * 4 / 3) // 64 * 64) or 64
        blk = {
            "conv_w": he(4, d), "conv_b": const((d,)),
            **{f"w_{g}": he(d, d) for g in "zifo"},
            **{f"r_{g}": he(h, dh, dh) for g in "zifo"},
            "b_z": const((d,), 0.0, f32=True), "b_i": const((d,), 0.0, f32=True),
            "b_f": const((d,), 3.0, f32=True), "b_o": const((d,), 0.0, f32=True),
            "gn": const((d,), 1.0), "ff_up": he(d, 2 * ff), "ff_down": he(ff, d),
        }
    return {"ln": {"scale": const((d,))}, "blk": blk}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    return init_leaves(param_specs(cfg, layer_specs, pattern(cfg)), generator, device,
                       getattr(torch, cfg.dtype))


# ----------------------------------------------------------- mLSTM parallel
def _head_norm(x: torch.Tensor, scale: torch.Tensor, h: int, eps: float) -> torch.Tensor:
    """Per-head RMS norm of (..., inner) viewed as h heads."""
    shp = x.shape
    xs = x.reshape(*shp[:-1], h, shp[-1] // h).float()
    xs = xs * torch.rsqrt(xs.square().mean(dim=-1, keepdim=True) + eps)
    return (xs.reshape(shp) * scale.float()).to(x.dtype)


def mlstm_parallel(q, k, v, i_pre, f_pre, q_chunk: int = 1024) -> torch.Tensor:
    """Stabilized parallel mLSTM. q, k, v (B, S, H, dh); i_pre, f_pre (B,
    S, H) fp32 → h (B, S, H, dh) in q's dtype. Queries in chunks of
    ``q_chunk`` (the reference's ``lax.map`` over chunks)."""
    b, s, h, dh = q.shape
    lf_cum = torch.cumsum(F.logsigmoid(f_pre), dim=1)        # Σ_{r<=t} log f_r
    scale = dh**-0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    t_all = torch.arange(s, device=q.device)
    outs = []
    for c0 in range(0, s, q_chunk if s > q_chunk else s):
        c1 = min(c0 + q_chunk, s) if s > q_chunk else s
        # D̃[t, s] = lf_cum[t] - lf_cum[s] + ĩ_s  (decay over r = s+1..t)
        dtil = lf_cum[:, c0:c1, None, :] - lf_cum[:, None, :, :] + i_pre[:, None, :, :]
        causal = t_all[c0:c1, None] >= t_all[None, :]
        dtil = torch.where(causal[None, :, :, None], dtil, torch.full_like(dtil, -torch.inf))
        m = torch.clamp(dtil.amax(dim=2, keepdim=True), min=-1e30)   # all -inf rows
        d = torch.exp(dtil - m)
        sw = torch.einsum("bchd,bshd->bcsh", qf[:, c0:c1], kf) * scale * d
        n = torch.maximum(sw.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
        outs.append(torch.einsum("bcsh,bshd->bchd", sw, vf) / n[..., None])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.to(q.dtype)


def mlstm_final_state(k, v, i_pre, f_pre):
    """(C, n, m) after the whole sequence, from the empty state (prefill)."""
    lf_cum = torch.cumsum(F.logsigmoid(f_pre), dim=1)
    # weight of position s in the final state: Π_{r>s} f_r · exp(ĩ_s)
    w_log = lf_cum[:, -1:] - lf_cum + i_pre                  # (B, S, H)
    m = w_log.amax(dim=1)                                    # (B, H)
    w = torch.exp(w_log - m[:, None, :])
    kf, vf = k.float(), v.float()
    c = torch.einsum("bsh,bshd,bshe->bhde", w, kf, vf)
    n = torch.einsum("bsh,bshd->bhd", w, kf)
    return c, n, m


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """O(1) decode update. q, k, v (B, H, dh); i_pre, f_pre (B, H); state
    (C (B, H, dh, dh), n (B, H, dh), m (B, H)) fp32 in stabilized space (C
    and n scaled by exp(-m)). Returns (new state, out (B, H, dh))."""
    c, n, m = state
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    f_s = torch.exp(logf + m - m_new)
    i_s = torch.exp(i_pre - m_new)
    kf, vf = k.float(), v.float()
    c = f_s[..., None, None] * c + i_s[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = f_s[..., None] * n + i_s[..., None] * kf
    qf = q.float() * (q.shape[-1] ** -0.5)
    num = torch.einsum("bhde,bhd->bhe", c, qf)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs(), torch.exp(-m_new))
    return (c, n, m_new), (num / den[..., None]).to(q.dtype)


def _mlstm_qkvif(p: dict, x: torch.Tensor, h: int):
    inner = x.shape[-1]
    q, k, v = ((x @ p[w]).reshape(*x.shape[:-1], h, inner // h) for w in ("wq", "wk", "wv"))
    i_pre = (x @ p["w_i"]).float() + p["b_i"]
    f_pre = (x @ p["w_f"]).float() + p["b_f"]
    return q, k, v, i_pre, f_pre


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict | None):
    """x (B, S, d) → (out (B, S, d), new state or None); ``state`` is read,
    not written."""
    h = cfg.n_heads
    main, gate = (x @ p["w_up"]).chunk(2, dim=-1)
    conv_out, new_tail = causal_conv(p, main, None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(p, conv_out, h)
    new_state = None
    if x.shape[1] == 1 and state is not None:
        (c, n, m), cell = mlstm_step((state["c"], state["n"], state["m"]), q[:, 0], k[:, 0],
                                     v[:, 0], i_pre[:, 0], f_pre[:, 0])
        cell = cell[:, None]
        new_state = {"c": c, "n": n, "m": m, "conv": new_tail}
    else:
        cell = mlstm_parallel(q, k, v, i_pre, f_pre)
        if state is not None:
            c, n, m = mlstm_final_state(k, v, i_pre, f_pre)
            new_state = {"c": c, "n": n, "m": m, "conv": new_tail}
    cell = _head_norm(cell.reshape(*x.shape[:-1], -1), p["gn"], h, cfg.norm_eps)
    cell = cell + p["skip"] * conv_out
    return (cell * F.silu(gate)) @ p["w_down"], new_state


# ------------------------------------------------------------------- sLSTM
def _block_diag(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h, dh, _ = w.shape
    return torch.einsum("...hi,hij->...hj", x.reshape(*x.shape[:-1], h, dh), w).reshape(x.shape)


def slstm_cell(p: dict, xz, xi, xf, xo, state: dict) -> dict:
    """One sLSTM step. x*: (B, d) pre-activations from the input; state
    {"c", "n", "h", "m"} (B, d) fp32."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hf = h.to(xz.dtype)
    z = torch.tanh((xz + _block_diag(p["r_z"], hf)).float() + p["b_z"])
    i_pre = (xi + _block_diag(p["r_i"], hf)).float() + p["b_i"]
    f_pre = (xf + _block_diag(p["r_f"], hf)).float() + p["b_f"]
    o = torch.sigmoid((xo + _block_diag(p["r_o"], hf)).float() + p["b_o"])
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    return {"c": c_new, "n": n_new, "h": o * c_new / torch.clamp(n_new, min=1e-6), "m": m_new}


_SLSTM_EPS = 1e-6
REC = ("r_z", "r_i", "r_f", "r_o", "b_z", "b_i", "b_f", "b_o")


class SlstmScan(torch.autograd.Function):
    """Training-time sLSTM over (B, S, d) pre-projected inputs → hs (B, S,
    d) fp32 from the zero state; the reference's ``slstm_scan_train``.

    backward: the reverse-time loop computes only the per-step
    pre-activation deltas (dzpre, dipre, dfpre, dopre) and the (dh, dc, dn)
    carry chain; the recurrent-weight gradients are one batched product
    over (S, B) after the loop (dR = Σ_t h_{t-1} ⊗ δpre_t), and the bias
    gradients one sum. The stabilizer m is held constant: c and n both
    carry the factor exp(-m), which cancels in h = o·c / max(n, eps), so
    ∂h/∂m = 0 exactly."""

    @staticmethod
    def forward(ctx, xz, xi, xf, xo, r_z, r_i, r_f, r_o, b_z, b_i, b_f, b_o):
        b, s, d = xz.shape
        dt = xz.dtype
        zero = torch.zeros((b, d), dtype=torch.float32, device=xz.device)
        c, n, h = zero, zero, zero
        m = torch.full((b, d), -1e30, dtype=torch.float32, device=xz.device)
        saved = []
        for t in range(s):
            hf = h.to(dt)
            zpre = (xz[:, t] + _block_diag(r_z, hf)).float() + b_z
            ipre = (xi[:, t] + _block_diag(r_i, hf)).float() + b_i
            fpre = (xf[:, t] + _block_diag(r_f, hf)).float() + b_f
            opre = (xo[:, t] + _block_diag(r_o, hf)).float() + b_o
            z, o, f_sig = torch.tanh(zpre), torch.sigmoid(opre), torch.sigmoid(fpre)
            logf = F.logsigmoid(fpre)
            m_new = torch.maximum(logf + m, ipre)
            i_s = torch.exp(ipre - m_new)
            f_s = torch.exp(logf + m - m_new)
            c = f_s * c + i_s * z
            n = f_s * n + i_s
            h = o * c / torch.clamp(n, min=_SLSTM_EPS)
            m = m_new
            saved.append(torch.stack([z, i_s, f_s, o, f_sig, c, n, h]))
        saved = torch.stack(saved, dim=1)                    # (8, S, B, d)
        ctx.save_for_backward(saved, r_z, r_i, r_f, r_o)
        ctx.dtypes = (dt, r_z.dtype)
        return saved[7].transpose(0, 1)

    @staticmethod
    def backward(ctx, dhs):
        saved, *rec = ctx.saved_tensors
        dt, rdt = ctx.dtypes
        z, i_s, f_s, o, f_sig, c_seq, n_seq, h_seq = saved  # (S, B, d) fp32 each
        s, b, d = z.shape
        heads, dh_, _ = rec[0].shape
        zero = torch.zeros((1, b, d), dtype=torch.float32, device=z.device)
        c_prev = torch.cat([zero, c_seq[:-1]])
        n_prev = torch.cat([zero, n_seq[:-1]])
        h_prev = torch.cat([zero, h_seq[:-1]])
        rec32 = [w.float() for w in rec]
        dhs = dhs.float().transpose(0, 1)
        deltas = torch.empty((4, s, b, d), dtype=torch.float32, device=z.device)
        dh_rec = dc_next = dn_next = zero[0]

        def bd_t(w, g):   # the transposed block-diagonal product into h_{t-1}
            return torch.einsum("bhj,hij->bhi", g.reshape(b, heads, dh_), w).reshape(b, d)

        for t in range(s - 1, -1, -1):
            dh = dhs[t] + dh_rec
            nh = torch.clamp(n_seq[t], min=_SLSTM_EPS)
            dc = dh * o[t] / nh + dc_next
            dn_raw = -dh * o[t] * c_seq[t] / (nh * nh)
            dn = torch.where(n_seq[t] > _SLSTM_EPS, dn_raw, torch.zeros_like(dn_raw)) + dn_next
            do = dh * c_seq[t] / nh
            deltas[3, t] = do * o[t] * (1.0 - o[t])                           # dopre
            deltas[0, t] = dc * i_s[t] * (1.0 - z[t] * z[t])                  # dzpre
            deltas[1, t] = (dc * z[t] + dn) * i_s[t]                          # dipre
            deltas[2, t] = (dc * c_prev[t] + dn * n_prev[t]) * f_s[t] * (1.0 - f_sig[t])
            dh_rec = (bd_t(rec32[0], deltas[0, t]) + bd_t(rec32[1], deltas[1, t])
                      + bd_t(rec32[2], deltas[2, t]) + bd_t(rec32[3], deltas[3, t]))
            dc_next = dc * f_s[t]
            dn_next = dn * f_s[t]
        # weight gradients: one contraction over (S, B) per weight, after the loop
        hp = h_prev.reshape(s, b, heads, dh_)
        d_rec = [torch.einsum("sbhi,sbhj->hij", hp, deltas[j].reshape(s, b, heads, dh_)).to(rdt)
                 for j in range(4)]
        d_b = [deltas[j].sum(dim=(0, 1)) for j in range(4)]
        dx = [deltas[j].transpose(0, 1).to(dt) for j in range(4)]
        return (*dx, *d_rec, *d_b)


def slstm_scan_train(rec: dict, xz, xi, xf, xo) -> torch.Tensor:
    """``SlstmScan`` over rec = {r_z, r_i, r_f, r_o, b_z, b_i, b_f, b_o}."""
    return SlstmScan.apply(xz, xi, xf, xo, *(rec[k] for k in REC))


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict | None):
    """x (B, S, d) → (out, new state or None); ``state`` is read, not
    written. Training (no state) runs ``SlstmScan``; prefill and decode
    step ``slstm_cell`` from the state."""
    conv_out, new_tail = causal_conv(p, x, None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    xz, xi, xf = conv_out @ p["w_z"], conv_out @ p["w_i"], conv_out @ p["w_f"]
    xo = x @ p["w_o"]
    new_state = None
    if state is None:
        hs = slstm_scan_train({k: p[k] for k in REC}, xz, xi, xf, xo).to(x.dtype)
    else:
        carry = {k: state[k] for k in ("c", "n", "h", "m")}
        hs = []
        for t in range(x.shape[1]):
            carry = slstm_cell(p, xz[:, t], xi[:, t], xf[:, t], xo[:, t], carry)
            hs.append(carry["h"])
        hs = torch.stack(hs, dim=1).to(x.dtype)
        new_state = {**carry, "conv": new_tail}
    hs = _head_norm(hs, p["gn"], cfg.n_heads, cfg.norm_eps)
    ff_gate, ff_up = (hs @ p["ff_up"]).chunk(2, dim=-1)
    return (gelu(ff_gate) * ff_up) @ p["ff_down"], new_state


# ------------------------------------------------------------- entry points
def _block(kind: str):
    return mlstm_block if kind == "mlstm" else slstm_block


def _train_layer(cfg: ModelConfig, kind: str, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return x + _block(kind)(lp["blk"], rms_norm(x, lp["ln"]["scale"], cfg.norm_eps), cfg,
                            None)[0]


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Training forward: tokens (B, S) → (logits fp32 (B, S, Vp), aux 0).
    With ``cfg.remat`` each layer is recomputed in the backward pass."""
    pat = pattern(cfg)
    x = embed_tokens(params["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = periodic_layer(params, i, len(pat))
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_train_layer, cfg, pat[i % len(pat)], lp, x, use_reentrant=False)
        else:
            x = _train_layer(cfg, pat[i % len(pat)], lp, x)
    x = rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), torch.zeros((), device=tokens.device)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    logits, _ = forward(cfg, params, batch["tokens"])
    loss, acc = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss, "accuracy": acc}


def _empty_state(cfg: ModelConfig, kind: str, batch: int, device) -> dict:
    d, inner, h = cfg.d_model, _inner(cfg), cfg.n_heads
    dt = getattr(torch, cfg.dtype)

    def f32(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    if kind == "mlstm":
        dh = inner // h
        return {"c": f32(batch, h, dh, dh), "n": f32(batch, h, dh),
                "m": f32(batch, h, fill=-1e30),
                "conv": torch.zeros((batch, 3, inner), dtype=dt, device=device)}
    return {"c": f32(batch, d), "n": f32(batch, d), "h": f32(batch, d),
            "m": f32(batch, d, fill=-1e30),
            "conv": torch.zeros((batch, 3, d), dtype=dt, device=device)}


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int = 0, *, window: int = 0,
                      device) -> dict:
    """The reference's decode cache: per layer the mLSTM {"c" (B, H, dh,
    dh), "n" (B, H, dh), "m" (B, H)} or sLSTM {"c", "n", "h", "m" (B, d)}
    states (fp32, m at -1e30) and the conv tail (B, 3, width), in the
    periodic layout, and the step counter ``pos`` (); O(1) in max_seq."""
    pat = pattern(cfg)
    layers = [_empty_state(cfg, pat[i % len(pat)], batch, device) for i in range(cfg.n_layers)]
    periods, rest = periodic_stack(layers, len(pat))
    return {"periods": periods, "rest": rest,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _run_cached(cfg: ModelConfig, params: dict, cache: dict, x: torch.Tensor) -> torch.Tensor:
    """The blocks over x (B, S, D) from the cache's states, written back in
    place; S = 1 takes the decode updates, S > 1 the parallel mLSTM and the
    stepped sLSTM."""
    pat = pattern(cfg)
    for i in range(cfg.n_layers):
        lp = periodic_layer(params, i, len(pat))
        lc = periodic_layer(cache, i, len(pat))
        out, new = _block(pat[i % len(pat)])(lp["blk"], rms_norm(x, lp["ln"]["scale"],
                                                                 cfg.norm_eps), cfg, lc)
        for k, t in new.items():
            lc[k].copy_(t)
        x = x + out
    cache["pos"] += x.shape[1]
    return rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor, *,
                window: int = 0, paged: bool = True) -> tuple[dict, torch.Tensor]:
    """One token per row: tokens (B, 1) → (cache, logits (B, Vp)), the cache
    updated in place. ``window`` and ``paged`` are the decode API's and
    change nothing here (no attention)."""
    x = _run_cached(cfg, params, cache, embed_tokens(params["embed"], tokens))
    return cache, lm_logits(params["embed"], x, cfg)[:, 0]


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, window: int = 0,
            cache_window: int = 0) -> tuple[dict, torch.Tensor]:
    """Whole prompts (B, S) from the empty state → (cache at pos S, logits
    (B, Vp) of the last position)."""
    cache = init_decode_cache(cfg, tokens.shape[0], device=tokens.device)
    x = _run_cached(cfg, params, cache, embed_tokens(params["embed"], tokens))
    return cache, lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]


# ------------------------------------------------- speculative draft states
def state_tree(cache: dict) -> dict:
    """The per-row states of a decode cache: {"periods", "rest"} (no
    ``pos``)."""
    return {"periods": cache["periods"], "rest": cache["rest"]}


def _rows_shape(x: torch.Tensor, rows: int, axis: int) -> list:
    shape = [1] * x.dim()
    shape[axis] = rows
    return shape


def select_rows(cond: torch.Tensor, a: dict, b: dict) -> dict:
    """Per-row merge of two state trees (``state_tree``) of one structure:
    row r takes ``a``'s state where cond[r], else ``b``'s. Periods leaves
    hold the batch at axis 1 ((n_rep, B, ...)), rest leaves at axis 0."""
    def sel(axis):
        return lambda x, y: torch.where(cond.reshape(_rows_shape(x, cond.shape[0], axis)), x, y)

    return {"periods": tree_map(sel(1), a["periods"], b["periods"]),
            "rest": tree_map(sel(0), a["rest"], b["rest"])}


def gather_snapshots(snaps: dict, idx: torch.Tensor) -> dict:
    """One state per row from a stack of snapshots: ``snaps`` is a state
    tree whose leaves carry a leading snapshot axis (periods (K, n_rep, B,
    ...), rest (K, B, ...)); row r takes snapshot idx[r]."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    idx = idx.long()
    return {"periods": tree_map(lambda x: x[idx, :, rows].transpose(0, 1), snaps["periods"]),
            "rest": tree_map(lambda x: x[idx, rows], snaps["rest"])}
