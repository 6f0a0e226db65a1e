"""The recurrent families' federated training (xlstm-125m, its sLSTM scan
through ``SlstmScan``; recurrentgemma-2b) through the port's
``FederatedTrainer`` against the reference trainer, at the smoke configs in
float32 on the same numpy-drawn weights: a 2-cloud FedAvg run with
topk+int8, error feedback and DP clipping (``train_inputs``). Losses within
rtol 1e-4 (``golden_train.GOLDEN_TRAIN_RTOL``: the same math in another
order, carried through Adam), the final global params' checksums within
``golden_train.GOLDEN_TRAIN_SUM_TOL``.

The golden file the card replays (``golden_train_recurrent_smoke.json``),
rewritten by ``PYTHONPATH=src:. python tests/test_torch_recurrent_train.py``;
the reference trainer is rerun here for xlstm-125m's case alone."""
import dataclasses
import functools
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FederatedConfig as RefFed
from repro.configs.base import TrainConfig as RefTrain
from repro.core.federated import FederatedTrainer as RefTrainer
from tests.test_torch_rglru import both_models

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import golden_train  # noqa: E402  (beside chip_smoke.py, outside the package)

GOLDEN_TRAIN = ROOT / "src" / "repro_torch" / "testdata" / "golden_train_recurrent_smoke.json"
ARCH = "xlstm-125m"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRAIN_ARCHS = (ARCH, "recurrentgemma-2b")


def train_inputs(arch: str) -> dict:
    """golden_train's layout: 2 clouds with sample counts (30, 10), H = 2,
    4 steps of batch 2 x 16 per cloud, topk+int8 with error feedback, DP
    clip 0.5 and no noise (the packages' noise streams differ by design)."""
    tokens = [np.random.default_rng(200 + i).integers(0, 512, (2, 2, 17), dtype=np.int32)
              for i in range(4)]
    return {
        "arch": arch, "seed": 0,
        "fed": dict(n_clouds=2, local_steps=2, compression="topk+int8", error_feedback=True,
                    dp_clip=0.5, dp_noise_mult=0.0, cloud_sample_counts=[30, 10]),
        "train": dict(seq_len=16, global_batch=4, steps=4, lr=1e-3, warmup_steps=1),
        "tokens": [t.tolist() for t in tokens],
        "arrived": [[True, True]] * 2, "alphas": [[0.5, 0.5]] * 2,
    }


def _ref_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


@functools.lru_cache(maxsize=None)
def _reference_train(arch: str) -> str:
    """The reference trainer, fedavg, on ``train_inputs(arch)``: per-step
    per-cloud losses and the final global params' float64 sums."""
    g = train_inputs(arch)
    g["cases"] = {"fedavg": dict(aggregation="fedavg", outer_optimizer="none", microbatches=1)}
    _, _, ref_model, ref_params = both_models(arch, g["seed"])
    model = dataclasses.replace(ref_model, init=lambda key: ref_params)
    fed = golden_train.case_fed(g, g["cases"]["fedavg"])
    trainer = RefTrainer(model, RefFed(**fed), RefTrain(**g["train"]), microbatches=1)
    step = jax.jit(trainer.train_step)
    state = trainer.init_state(jax.random.PRNGKey(0))
    losses = []
    for i, toks in enumerate(g["tokens"]):
        t = jnp.asarray(np.asarray(toks, np.int32))
        r = i // g["fed"]["local_steps"]
        state, m = step(state, {"tokens": t[..., :-1], "labels": t[..., 1:]},
                        jnp.asarray(g["arrived"][r]), jnp.asarray(g["alphas"][r], jnp.float32))
        losses.append(np.asarray(m["per_cloud_loss"]).tolist())
    flat = {_ref_path(path): np.asarray(x, np.float64)
            for path, x in jax.tree_util.tree_flatten_with_path(state["global"]["params"])[0]}
    g["cases"]["fedavg"].update(
        losses=losses,
        sums={k: [float(x.sum()), float(np.square(x).sum())] for k, x in flat.items()},
        numel={k: int(x.size) for k, x in flat.items()})
    return json.dumps(g)


def make_golden_train() -> dict:
    return {arch: json.loads(_reference_train(arch)) for arch in TRAIN_ARCHS}


def test_golden_train_file_matches_reference():
    """xlstm-125m's case (its sLSTM through the reference's custom-VJP scan)
    is still what the reference trainer gives. recurrentgemma-2b's is not
    rerun here (its trainer's compile alone takes ~16 s of the suite's
    budget): ``test_golden_train_inputs_are_pinned`` pins its inputs and
    ``python tests/test_torch_recurrent_train.py`` rewrites both."""
    assert json.loads(GOLDEN_TRAIN.read_text())[ARCH] == json.loads(_reference_train(ARCH))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_golden_train_inputs_are_pinned(arch):
    """The file's batches, settings and case are ``train_inputs(arch)``'s,
    with the reference's losses at every step and the checksums of every
    leaf of the port's tree."""
    g = json.loads(GOLDEN_TRAIN.read_text())[arch]
    want = train_inputs(arch)
    assert {k: g[k] for k in want} == want
    case = g["cases"]["fedavg"]
    assert len(case["losses"]) == len(want["tokens"]) and set(case["sums"]) == set(case["numel"])
    _, params, _, _ = both_models(arch, g["seed"])
    assert set(case["sums"]) == set(golden_train.leaf_paths(params))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_federated_training_matches_reference(arch):
    """The port's ``FederatedTrainer`` (local steps under autograd, the
    sLSTM Function included; the sync through topk+int8 with DP clipping)
    on the golden case: per-step per-cloud losses within rtol 1e-4, the
    final global params' checksums within golden_train's gate. The sync
    meets float32 leaves (Λ, the gate biases), leaves of 4 elements
    (mLSTM's b_i/b_f: one edge block) and 3-d block-diagonal leaves."""
    g = json.loads(GOLDEN_TRAIN.read_text())[arch]
    got = golden_train.golden_train_replay(g, "fedavg", "cpu")
    loss, sums = golden_train.golden_train_errors(g["cases"]["fedavg"], got)
    assert loss <= golden_train.GOLDEN_TRAIN_RTOL, loss
    assert sums <= golden_train.GOLDEN_TRAIN_SUM_TOL, sums
    assert set(got["sums"]) == set(g["cases"]["fedavg"]["sums"])


if __name__ == "__main__":
    GOLDEN_TRAIN.write_text(json.dumps(make_golden_train(), indent=1) + "\n")
    print(f"wrote {GOLDEN_TRAIN}")
