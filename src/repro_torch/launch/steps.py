"""Step functions of the launcher (the reference's ``launch/steps.py``): the
multi-pod federated step. The single-pod train, prefill and decode steps
and the dry run that lowers them come with the port's dry run."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core.federated import FederatedTrainer
from repro_torch.models.model import ModelAPI


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
