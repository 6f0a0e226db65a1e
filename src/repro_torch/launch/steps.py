"""Step functions of the launcher (the reference's ``launch/steps.py``): the
single-pod train, prefill and decode steps the dry run sizes
(``launch/dryrun.py``), the decode window it picks per shape, and the
multi-pod federated step."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import FederatedConfig, ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.federated import FederatedTrainer
from repro_torch.models.model import ModelAPI
from repro_torch.optim.adamw import adamw_update
from repro_torch.utils.grad import microbatched_value_and_grad


def decode_window_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The sliding window of a shape's decode: the config's decode window
    past 32k tokens on the attention families, else 0 (the full cache); the
    recurrent families keep their own state everywhere."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return 0
    if shape.seq_len > 32_768:
        return cfg.decode_window
    return 0


def make_train_step(model: ModelAPI, train_cfg: TrainConfig,
                    microbatches: int = 1) -> Callable:
    """``train_step(params, opt, batch) -> (params, opt, metrics)``: the
    loss's fp32 gradients over ``microbatches`` chunks, then one AdamW step
    (in place)."""
    def train_step(params, opt, batch):
        (_, metrics), grads = microbatched_value_and_grad(model.loss, params, batch,
                                                          microbatches)
        params, opt = adamw_update(train_cfg, grads, opt, params)
        return params, opt, metrics

    return train_step


def make_prefill_step(model: ModelAPI, shape: ShapeConfig) -> Callable:
    """``prefill_step(params, batch) -> (cache, logits)``: the whole-prompt
    prefill of the model's family."""
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: ModelAPI, window: int) -> Callable:
    """``decode_step(params, cache, tokens) -> (cache, logits)`` at
    ``window``."""
    def decode_step(params, cache, tokens):
        return model.decode(params, cache, tokens, window=window)

    return decode_step


def make_federated_step(
    model: ModelAPI,
    fed_cfg: FederatedConfig,
    train_cfg: TrainConfig,
    microbatches: int = 1,
    mesh=None,
) -> tuple[FederatedTrainer, Callable]:
    """Multi-pod federated train step: the trainer in pod mode over ``mesh``
    (``launch/mesh.make_sim_mesh``: one device per cloud), and its step
    ``fed_step(state, batch_stack) -> (state, metrics)``. The reference's
    ``grad_shardings`` (intra-pod specs) has no counterpart: the port's
    pods are one device each."""
    trainer = FederatedTrainer(
        model, fed_cfg, train_cfg, spmd_axis="pod", microbatches=microbatches, mesh=mesh,
    )

    def fed_step(state, batch_stack):
        return trainer.train_step(state, batch_stack)

    return trainer, fed_step
