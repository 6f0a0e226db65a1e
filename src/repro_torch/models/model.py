"""Model API of the port: ``build_model(cfg)`` returns a ``ModelAPI`` whose
members close over the config, for all six of the reference's arch types:
the transformer (``"dense"``; ``"moe"``: the MoE layer) with the slot-cache
API the serving engine uses; the recurrent families (``"hybrid"``:
recurrentgemma, ``models/rglru.py``; ``"ssm"``: xLSTM,
``models/xlstm.py``), pixtral (``"vlm"``, ``models/vlm.py``) and whisper
(``"audio"``, ``models/whisper.py``) with whole-prompt prefill and decode
and no slot-cache API, as in the reference. And ``localize_config``, the
per-shard config of tensor-parallel serving.

Batches are dicts, as in the reference: {"tokens" (B, S), "labels" (B, S)}
for training and prefill, plus "patch_embeds" (B, vision_seq, D) for vlm
and "audio_embeds" (B, encoder_seq, D) for audio; decode takes tokens (B,
1) against a cache that ``init_cache`` or ``prefill`` made."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, transformer, vlm, whisper, xlstm
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
    # init_cache(params, batch, max_seq, window=) -> lockstep decode cache (pos ()) for
    # the rows of batch["tokens"], on its device (audio: runs the encoder on
    # batch["audio_embeds"] and holds each layer's cross K/V)
    init_cache: Callable[..., dict]
    # The slot-cache API of continuous batching (None where the arch has none,
    # as in the reference: the recurrent, vlm and audio families):
    # prefill_slot(params, cache, tokens (1, S), slot, window=) -> (cache, logits (1, Vp)):
    #     one request's whole prompt into row ``slot`` of the per-slot rings
    #     (the engine's per-request admission, ``batch_prefill=False``)
    prefill_slot: Callable[..., tuple[dict, Any]] | None = None
    # prefill_slots(params, cache, tokens (n, S), lengths (n,), slots (n,),
    #               starts=None, prefix_pages=None, window=, return_all_logits=False)
    #     -> (cache, logits (n, Vp), or (n, S, Vp) with return_all_logits)
    prefill_slots: Callable[..., tuple[dict, Any]] | None = None
    # init_paged_cache(num_slots, num_pages, page_size, table_width, device=,
    #                  kv_dtype=) -> shared paged pool + per-slot page tables
    init_paged_cache: Callable[..., dict] | None = None
    # init_slot_cache(num_slots, max_seq, window=, device=) -> per-slot rings (pos (B,))
    init_slot_cache: Callable[..., dict] | None = None
    # prefill(params, batch, window=, cache_window=) -> (decode cache at pos S,
    # logits (B, Vp) of the last position): the whole-prompt prefill of every
    # family (vlm: image prefix + prompt; audio: encoder + prompt); the
    # transformer's attends within ``window`` or the config's
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


def _prefill_family_api(cfg: ModelConfig, mod) -> ModelAPI:
    """A family with whole-prompt prefill and decode and no slot-cache API,
    as in the reference: the hybrid (``rglru``), ssm (``xlstm``), vlm
    (``vlm``: forward and prefill take the batch with its
    ``patch_embeds``) or audio (``whisper``: forward and prefill take the
    batch with its ``audio_embeds``; ``init_cache`` runs the encoder on
    them). ``mod`` holds the family's init, loss, forward, decode cache,
    decode step and prefill."""
    inputs = cfg.arch_type in ("vlm", "audio")

    def arg(batch):
        return batch if inputs else batch["tokens"]

    def init(generator, device):
        return mod.init_params(cfg, generator, device)

    def loss(params, batch):
        return mod.loss_fn(cfg, params, batch)

    def forward(params, batch):
        return mod.forward(cfg, params, arg(batch))[0]

    def decode(params, cache, tokens, *, window=0, paged=True):
        return mod.decode_step(cfg, params, cache, tokens, window=window, paged=paged)

    def init_cache(params, batch, max_seq, *, window=0):
        if cfg.arch_type == "audio":
            return whisper.init_decode_cache(cfg, params, batch["audio_embeds"], max_seq,
                                             window=window)
        return mod.init_decode_cache(cfg, batch["tokens"].shape[0], max_seq, window=window,
                                     device=batch["tokens"].device)

    def prefill(params, batch, *, window=0, cache_window=0):
        return mod.prefill(cfg, params, arg(batch), window=window, cache_window=cache_window)

    return ModelAPI(cfg, init, loss, forward, decode, init_cache, prefill=prefill)


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.act not in ("silu", "gelu"):
        raise NotImplementedError(f"act {cfg.act!r}: the port's MLPs are SwiGLU and GeGLU "
                                  "(and whisper's plain GELU MLP)")
    family = {"hybrid": rglru, "ssm": xlstm, "vlm": vlm, "audio": whisper}
    if cfg.arch_type in family:
        return _prefill_family_api(cfg, family[cfg.arch_type])
    if cfg.arch_type not in ("dense", "moe"):
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")
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

    def init_cache(params, batch, max_seq, *, window=0):
        return transformer.init_decode_cache(cfg, batch["tokens"].shape[0], max_seq,
                                             window=window, device=batch["tokens"].device)

    def init_slot_cache(num_slots, max_seq, *, window=0, device):
        return transformer.init_decode_cache(cfg, num_slots, max_seq, window=window,
                                             per_slot=True, device=device)

    def prefill(params, batch, *, window=0, cache_window=0):
        return transformer.prefill(cfg, params, batch["tokens"], ffn=ffn,
                                   window=window or cfg.window, cache_window=cache_window)

    def prefill_slot(params, cache, tokens, slot, *, window=0):
        return transformer.prefill_into_slot(cfg, params, cache, tokens, slot, ffn=ffn,
                                             window=window)

    return ModelAPI(cfg, init, loss, forward, decode, init_cache, prefill_slot=prefill_slot,
                    prefill_slots=prefill_slots, init_paged_cache=init_paged_cache,
                    init_slot_cache=init_slot_cache, prefill=prefill)
