"""Model architecture config: the port's own copy of the reference
``ModelConfig`` (same fields, same defaults, same derived quantities), so
the two packages agree on every shape without the port importing the
reference."""
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
