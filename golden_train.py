"""The replay of the reference trainer's float32 golden training traces
(``src/repro_torch/testdata/golden_train_smoke.json``) through the port, and
the errors it is judged by. ``chip_smoke.py`` (phase 4f, on the card) and
``tests/test_torch_train_golden.py`` (on the CPU) share them; the port
itself never imports this module."""
from __future__ import annotations

import dataclasses
import pathlib

import torch

from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core.federated import FederatedTrainer
from repro_torch.launch.mesh import make_sim_mesh
from repro_torch.launch.steps import make_federated_step
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN_TRAIN = ROOT / "src/repro_torch/testdata/golden_train_smoke.json"
# Replay vs the reference's golden training traces. Losses: the CPU test's
# rtol (tests/test_torch_train.py: the same math summed in another order,
# carried through Adam). Checksums (``golden_train_errors``, in units of a
# leaf's RMS): the port on the CPU read at most 1.0e-3 and the planted fault
# (the sample counts ignored) at least 0.88.
GOLDEN_TRAIN_RTOL = 1e-4
GOLDEN_TRAIN_SUM_TOL = 1e-2
# the cases whose aggregate weighs the clouds by their sample counts
GOLDEN_TRAIN_FAULTED = ("fedavg", "gradient")


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """"embed/tok", ... of a parameter tree, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                                             else k)]
    return [prefix]


def leaf_sums(tree) -> dict:
    """{"embed/tok": [Σx, Σx²], ...} of a parameter tree, in float64."""
    return {p: [x.double().sum().item(), x.double().square().sum().item()]
            for p, x in zip(leaf_paths(tree), tree_leaves(tree))}


def golden_train_replay(g: dict, name: str, device, *, uniform_weights: bool = False) -> dict:
    """One case of the reference's golden training file
    (``golden_train_smoke.json``) through the port's ``FederatedTrainer`` on
    ``device``: the smoke config in float32 on the bridged weights, the
    file's batches and async masks; a ``pod`` case runs the pod-mode step
    (``launch/steps.make_federated_step``) on a pod mesh naming ``device``
    once per cloud, with the case's compression, ``wire_int8`` and step
    count. Returns {"losses": per step [cloud 0, cloud 1], "sums":
    ``leaf_sums`` of the final global params}. ``uniform_weights`` drops
    the sample counts: a planted fault."""
    case = g["cases"][name]
    cfg = dataclasses.replace(get_smoke_config(g["arch"]), dtype="float32")
    fed = case_fed(g, case)
    if uniform_weights:
        fed["cloud_sample_counts"] = None
    tokens = g["tokens"][: case.get("steps", len(g["tokens"]))]
    # the model's init returns the bridged weights, which init_state copies
    # to every cloud
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, device)
    model = dataclasses.replace(build_model(cfg), init=lambda generator, dev: params)
    train = TrainConfig(**dict(g["train"], steps=len(tokens)))
    if case.get("pod"):
        mesh = make_sim_mesh(g["fed"]["n_clouds"], devices=[device] * g["fed"]["n_clouds"])
        trainer, step = make_federated_step(model, FederatedConfig(**fed), train,
                                            microbatches=case["microbatches"], mesh=mesh)
    else:
        trainer = FederatedTrainer(model, FederatedConfig(**fed), train,
                                   microbatches=case["microbatches"])
        step = trainer.train_step
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0), device)
    losses = []
    for i, toks in enumerate(tokens):
        t = torch.tensor(toks, dtype=torch.int32, device=device)
        r = i // fed["local_steps"]
        batch = {"tokens": t[..., :-1], "labels": t[..., 1:]}
        if case.get("pod"):
            state, m = step(state, batch)
        else:
            state, m = step(state, batch, torch.tensor(g["arrived"][r], device=device),
                            torch.tensor(g["alphas"][r], dtype=torch.float32, device=device))
        losses.append(m["per_cloud_loss"].tolist())
    return {"losses": losses, "sums": leaf_sums(state["global"]["params"])}


def case_fed(g: dict, case: dict) -> dict:
    """The ``FederatedConfig`` fields of one golden case: the file's, with
    the case's aggregation and outer optimizer and, where the case names
    them, its compression and ``wire_int8``."""
    return dict(g["fed"], aggregation=case["aggregation"],
                outer_optimizer=case["outer_optimizer"],
                compression=case.get("compression", g["fed"]["compression"]),
                wire_int8=case.get("wire_int8", False),
                cloud_sample_counts=tuple(g["fed"]["cloud_sample_counts"]))


def golden_train_errors(want: dict, got: dict) -> tuple[float, float]:
    """(largest relative loss error, largest checksum error) of a replay
    against a golden case. A leaf's checksum error is |ΔΣx| and |ΔΣx²|
    over what n independent errors of one unit in each element would give
    (√n, and 2·√(Σx²)), in units of the elements' typical size."""
    loss = max(abs(a - b) / abs(b) for ga, wa in zip(got["losses"], want["losses"])
               for a, b in zip(ga, wa))
    worst = 0.0
    for key, (s, s2) in want["sums"].items():
        gs, gs2 = got["sums"][key]
        n = want["numel"][key]
        rms = max((s2 / n) ** 0.5, 1e-30)
        worst = max(worst, abs(gs - s) / (n ** 0.5 * rms), abs(gs2 - s2) / (2 * (s2 ** 0.5) * rms))
    return loss, worst
