"""Input and state specs of every (architecture × input shape) pair, as
tensors on the ``meta`` device (the reference's ``launch/specs.py``, whose
``ShapeDtypeStruct``s they replace).

Nothing here allocates: a meta tensor has a shape and a dtype and no
storage, so the dry run (``launch/dryrun.py``) sizes the full configs on any
host. The model's own constructors build them (``model.init``,
``adamw_init``, ``init_cache``, ...) on ``device="meta"``; whisper's
``init_cache`` runs its encoder there, which computes nothing. Vision and
audio batches carry the stub frontends' embeddings; vision tokens count
against a training sequence, so its text is ``seq_len - vision_seq``."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import ModelAPI
from repro_torch.optim.adamw import adamw_init

META = torch.device("meta")

ACTIVATION_BUDGET = 4e9  # target bytes of saved residuals per device


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def meta_params(model: ModelAPI) -> dict:
    return model.init(torch.Generator(), META)


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.arch_type == "vlm" and shape.kind == "training":
        return shape.seq_len - cfg.vision_seq
    return shape.seq_len


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, n_pods: int = 1) -> dict:
    """A training batch {"tokens", "labels"[, "patch_embeds" |
    "audio_embeds"]}; with ``n_pods`` > 1 every leaf gets a leading cloud
    axis (the federated stack)."""
    b, s = shape.global_batch, text_len(cfg, shape)
    dt = getattr(torch, cfg.dtype)

    def shaped(*dims, dtype=torch.int32):
        if n_pods > 1:
            if dims[0] % n_pods:
                raise ValueError(f"batch {dims[0]} does not split over {n_pods} pods")
            dims = (n_pods, dims[0] // n_pods) + dims[1:]
        return meta(dims, dtype)

    batch = {"tokens": shaped(b, s), "labels": shaped(b, s)}
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = shaped(b, cfg.vision_seq, cfg.d_model, dtype=dt)
    if cfg.arch_type == "audio":
        batch["audio_embeds"] = shaped(b, cfg.encoder_seq, cfg.d_model, dtype=dt)
    return batch


def decode_token_specs(shape: ShapeConfig) -> torch.Tensor:
    return meta((shape.global_batch, 1), torch.int32)


def state_specs(model: ModelAPI) -> tuple[dict, dict]:
    """(params, AdamW state). The reference holds the step count as an
    int32 scalar; the port's trainer keeps it as a host int, which the spec
    counts as the reference's 4 bytes."""
    params = meta_params(model)
    opt = adamw_init(params)
    opt["count"] = meta((), torch.int32)
    return params, opt


def cache_specs(model: ModelAPI, cfg: ModelConfig, shape: ShapeConfig, window: int) -> dict:
    """The decode cache of a shape's batch at ``seq_len`` (whisper's holds
    every layer's cross K/V over its frames)."""
    batch = {"tokens": decode_token_specs(shape)}
    if cfg.arch_type == "audio":
        batch["audio_embeds"] = train_batch_specs(cfg, shape)["audio_embeds"]
    return model.init_cache(meta_params(model), batch, shape.seq_len, window=window)


def slot_cache_specs(model: ModelAPI, num_slots: int, max_seq: int, window: int = 0) -> dict:
    """The engine's per-slot rings (positions (num_slots,))."""
    if model.init_slot_cache is None:
        raise ValueError(f"{model.cfg.name}: no slot-cache API for this arch")
    return model.init_slot_cache(num_slots, max_seq, window=window, device=META)


def paged_cache_specs(model: ModelAPI, num_slots: int, num_pages: int, page_size: int,
                      table_width: int, kv_dtype: str = "fp") -> dict:
    """The engine's shared paged pool and page tables: KV bytes scale with
    ``num_pages``, not ``num_slots × max_seq``. ``kv_dtype="int8"`` adds
    the fp32 scale planes (1/hd of the page bytes)."""
    if model.init_paged_cache is None:
        raise ValueError(f"{model.cfg.name}: no paged-cache API for this arch")
    return model.init_paged_cache(num_slots, num_pages, page_size, table_width, device=META,
                                  kv_dtype=kv_dtype)


def draft_cache_specs(model: ModelAPI, num_slots: int, cap: int, spec_tokens: int) -> dict:
    """A speculative draft's state: a KV draft's per-slot rings of cap + k
    + 1 slots, or the xLSTM draft's O(1) recurrent state."""
    if model.init_slot_cache is not None:
        return model.init_slot_cache(num_slots, cap + spec_tokens + 1, device=META)
    if model.cfg.arch_type == "ssm":
        from repro_torch.models import xlstm

        return xlstm.init_decode_cache(model.cfg, num_slots, 1, device=META)
    raise ValueError(f"{model.cfg.name}: no draft state layout for this arch")


def layers_for_memory(cfg: ModelConfig) -> int:
    n = cfg.n_layers
    if cfg.arch_type == "audio":
        n += cfg.encoder_layers
    return n


def microbatch_policy(cfg: ModelConfig, shape: ShapeConfig, *, n_pods: int = 1,
                      data_axis: int = 16) -> int:
    """Gradient-accumulation chunks that keep the saved residuals (≈ L ·
    B_local · S · D · 2 bytes under remat) within ``ACTIVATION_BUDGET`` per
    device; a divisor of the local batch."""
    if shape.kind != "training":
        return 1
    b_local = shape.global_batch // (n_pods * data_axis)
    if b_local == 0:
        return 1
    saved = layers_for_memory(cfg) * b_local * shape.seq_len * cfg.d_model * 2
    k = max(1, math.ceil(saved / ACTIVATION_BUDGET))
    while b_local % k != 0:
        k += 1
    return min(k, b_local)
