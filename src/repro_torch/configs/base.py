"""Configs: the port's own copies of the reference ``ModelConfig`` (same
fields, same defaults, same derived quantities), ``FederatedConfig`` and
``TrainConfig``, so the two packages agree on every shape and knob without
the port importing the reference. ``FederatedConfig`` leaves out
``wire_int8`` (the in-program int8 sync of the reference's mesh, which the
port does not have yet). ``secure_agg`` and ``TrainConfig.eval_every``
are declared as in the reference, which reads neither; the port's
``FederatedTrainer`` refuses them when set (secure aggregation is called
directly, ``core/privacy.secure_aggregate``; there is no evaluation loop).
``log_every``, ``checkpoint_every`` and ``checkpoint_dir`` are what
``launch/train.run_training``'s loop reads."""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

ArchType = Literal["dense", "moe", "vlm", "hybrid", "ssm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 → d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- attention ---
    rope_theta: float = 10_000.0
    window: int = 0                    # 0 = full causal attention (training)
    decode_window: int = 8192          # SWA ring-buffer window for long-ctx decode
    # --- hybrid (recurrentgemma): repeating block pattern ---
    block_pattern: Sequence[str] = ()  # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0
    conv_width: int = 4
    local_attn_window: int = 2048
    # --- ssm (xlstm) ---
    slstm_every: int = 0               # every k-th block is sLSTM (0 = none)
    # --- audio (whisper) / vlm (pixtral) modality frontend stubs ---
    encoder_layers: int = 0            # whisper encoder depth
    encoder_seq: int = 0               # whisper: 1500 mel frames (post-conv)
    vision_seq: int = 0                # pixtral: number of patch embeddings
    # --- numerics / misc ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    act: str = "silu"                  # mlp activation family: silu→SwiGLU, gelu→GeGLU/MLP
    # --- distribution hints ---
    fsdp: bool = False                 # shard params/opt-state over the data axis too
    pure_dp: bool = False              # no tensor parallelism: replicate params
    remat: bool = True                 # activation checkpointing per layer
    source: str = ""                   # citation bracket from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_enc_dec(self) -> bool:
        return self.arch_type == "audio"

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params)."""
        hd = self.resolved_head_dim
        d = self.d_model
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.arch_type == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        elif self.arch_type == "ssm":
            ffn = 0  # xlstm blocks count their own projections below
        else:
            ffn = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        if self.arch_type == "hybrid":
            pat = list(self.block_pattern) or ["rglru", "rglru", "attn"]
            n_rec = sum(
                1 for i in range(self.n_layers) if pat[i % len(pat)] != "attn"
            )
            n_att = self.n_layers - n_rec
            w = self.lru_width or d
            rec = 2 * d * w + w * d + self.conv_width * w + 3 * w + 2 * d
            ffn_l = 3 * d * self.d_ff + 2 * d
            return (
                n_att * (attn + ffn_l + 2 * d)
                + n_rec * (rec + ffn_l)
                + self.vocab_size * d
                + d
            )
        if self.arch_type == "ssm":
            inner = 2 * d
            per_layer = (
                d * 2 * inner
                + 3 * inner * inner // 2
                + inner * d
                + 4 * inner
                + 2 * d
            )
        total = self.n_layers * per_layer
        if self.is_enc_dec:
            total += self.n_layers * attn
            total += self.encoder_layers * (attn + ffn + 2 * d)
            total += self.encoder_seq * d
            total += 448 * d
        emb = self.vocab_size * d
        unemb = 0 if self.tie_embeddings else self.vocab_size * d
        return total + emb + unemb + d


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """The paper's knobs (§3.1-§3.3)."""
    n_clouds: int = 3
    local_steps: int = 4                  # H local steps between sync rounds (§3.2)
    aggregation: str = "fedavg"           # fedavg | dynamic | gradient | async
    # dynamic weighting temperature for softmax(-L_i/τ) (formula 2; τ=1 in paper)
    dynamic_temp: float = 1.0
    async_alpha: float = 0.5              # α in formula 4
    # sample counts per cloud (n_i in formula 1); None → uniform
    cloud_sample_counts: tuple[int, ...] | None = None
    # --- §3.2 communication optimization ---
    compression: str = "none"             # none | topk | int8 | topk+int8
    topk_ratio: float = 0.01              # keep-fraction for top-k sparsification
    error_feedback: bool = True
    # --- privacy (§3.1 "Ensure Data Security") ---
    dp_clip: float = 0.0                  # 0 disables DP
    dp_noise_mult: float = 0.0
    secure_agg: bool = False              # must stay False: the trainer raises
    # --- outer optimizer applied to the aggregated delta (beyond-paper) ---
    outer_optimizer: str = "none"         # none | sgd | nesterov
    outer_lr: float = 1.0
    outer_momentum: float = 0.9


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 256
    global_batch: int = 8
    steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10                   # steps between logged losses
    eval_every: int = 0                   # must stay 0: the trainer raises
    checkpoint_every: int = 0             # steps between saves; 0 saves nothing
    checkpoint_dir: str = ""              # where the saves go
