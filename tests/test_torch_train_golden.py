"""The reference trainer's float32 golden training traces
(``src/repro_torch/testdata/golden_train_smoke.json``), replayed by the port
on the CPU; ``chip_smoke.py`` phase 4f replays them on the card.

The cases: the stablelm-1.6b smoke config in float32 on the bridged
``numpy_params``, 2 clouds with sample counts (30, 10), H = 2, 6 steps of
batch 2 x 16 per cloud, ``int8`` compression with error feedback, DP clip
0.5 and no noise (the two packages' noise streams differ by design), under
fedavg, dynamic, gradient, async (the scheduler's masks of
``tests/test_torch_train.py``), fedavg with the nesterov outer optimizer and
fedavg with 2 microbatches. The file holds the batches and masks, each
step's per-cloud losses and the final global params' per-leaf sum and sum
of squares in float64.

Tolerances, as ``tests/test_torch_train.py`` sets them: losses rtol 1e-4
(the same math summed in another order, carried through Adam); the
checksums (``golden_train.golden_train_errors``: a leaf's |ΔΣx| over √n and
|ΔΣx²| over 2·√Σx², in units of the leaf's RMS) within ``SUM_TOL``, 1e-2:
the port read at most 1.0e-3 here and the planted fault at least 0.88. The
planted fault, the sample counts ignored (uniform weights for 0.75/0.25),
must land outside them in the cases that read the counts (fedavg and
gradient). Regenerate the file with

    PYTHONPATH=src:. python tests/test_torch_train_golden.py
"""
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import FederatedConfig as RefFed
from repro.configs.base import TrainConfig as RefTrain
from repro.core import scheduler as ref_sched
from repro.core.federated import FederatedTrainer as RefTrainer
from repro.models import build_model as ref_build_model
import torch

from repro_torch.bridge import numpy_params
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.utils.grad import microbatched_value_and_grad
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import golden_train  # noqa: E402  (beside chip_smoke.py, outside the package)

GOLDEN = golden_train.GOLDEN_TRAIN
ARCH = "stablelm-1.6b"
CASES = {
    "fedavg": dict(aggregation="fedavg", outer_optimizer="none", microbatches=1),
    "dynamic": dict(aggregation="dynamic", outer_optimizer="none", microbatches=1),
    "gradient": dict(aggregation="gradient", outer_optimizer="none", microbatches=1),
    "async": dict(aggregation="async", outer_optimizer="none", microbatches=1),
    "nesterov": dict(aggregation="fedavg", outer_optimizer="nesterov", microbatches=1),
    "microbatches2": dict(aggregation="fedavg", outer_optimizer="none", microbatches=2),
}
LOSS_RTOL = golden_train.GOLDEN_TRAIN_RTOL
SUM_TOL = golden_train.GOLDEN_TRAIN_SUM_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores (a 100-step smoke run went from seconds to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden_inputs() -> dict:
    """Everything but the reference's outputs."""
    steps, h = 6, 2
    clouds = [ref_sched.CloudSpec(f"c{i}", speed=1.0 + 0.5 * i) for i in range(2)]
    ev = ref_sched.simulate_async_schedule(clouds, h, steps // h, base_alpha=0.5)
    arrived, alphas = ref_sched.events_to_round_masks(ev, 2, steps // h)
    vocab = get_smoke_config(ARCH).vocab_size
    tokens = [np.random.default_rng(100 + i).integers(0, vocab, (2, 2, 17), dtype=np.int32)
              for i in range(steps)]
    return {
        "arch": ARCH, "seed": 0,
        "fed": dict(n_clouds=2, local_steps=h, compression="int8", error_feedback=True,
                    dp_clip=0.5, dp_noise_mult=0.0, cloud_sample_counts=[30, 10]),
        "train": dict(seq_len=16, global_batch=4, steps=steps, lr=1e-3, warmup_steps=1),
        "tokens": [t.tolist() for t in tokens],
        "arrived": arrived.tolist(), "alphas": alphas.astype(float).tolist(),
    }


def reference_case(g: dict, name: str) -> dict:
    """The reference trainer on one case: per-step per-cloud losses and
    the final global params' per-leaf float64 sums."""
    case = CASES[name]
    cfg = dataclasses.replace(ref_smoke_config(ARCH), dtype="float32")
    fed = dict(g["fed"], aggregation=case["aggregation"],
               outer_optimizer=case["outer_optimizer"],
               cloud_sample_counts=tuple(g["fed"]["cloud_sample_counts"]))
    # the model's init returns the bridged weights: init_state then lays out
    # the clouds, optimizer and error feedback itself, without the seconds
    # its random init takes
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, g["seed"]))
    model = dataclasses.replace(ref_build_model(cfg), init=lambda key: params)
    trainer = RefTrainer(model, RefFed(**fed), RefTrain(**g["train"]),
                         microbatches=case["microbatches"])
    state = trainer.init_state(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_step)
    losses = []
    for i, toks in enumerate(g["tokens"]):
        t = jnp.asarray(np.asarray(toks, np.int32))
        r = i // g["fed"]["local_steps"]
        state, m = step(state, {"tokens": t[..., :-1], "labels": t[..., 1:]},
                        jnp.asarray(g["arrived"][r]), jnp.asarray(g["alphas"][r], jnp.float32))
        losses.append(np.asarray(m["per_cloud_loss"]).tolist())
    flat = {"/".join(str(p.key) for p in path): np.asarray(x, np.float64)
            for path, x in jax.tree_util.tree_flatten_with_path(state["global"]["params"])[0]}
    return {"losses": losses,
            "sums": {k: [float(x.sum()), float(np.square(x).sum())] for k, x in flat.items()},
            "numel": {k: int(x.size) for k, x in flat.items()}}


def make_golden_train() -> dict:
    g = golden_inputs()
    g["cases"] = {name: dict(CASES[name], **reference_case(g, name)) for name in CASES}
    return g


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_inputs_are_pinned(golden):
    """The file's batches, masks and settings are ``golden_inputs()``; the
    async masks hold a cloud that did not arrive."""
    want = golden_inputs()
    assert {k: golden[k] for k in want} == want
    assert set(golden["cases"]) == set(CASES)
    assert not all(all(a) for a in golden["arrived"])


def test_golden_file_is_the_reference_output(golden):
    """The reference trainer, run again on one case (gradient: the one
    whose step compiles fastest), gives the file's numbers (to the last
    bits; a tolerance far below the port's)."""
    want = reference_case(golden, "gradient")
    loss, sums = golden_train.golden_train_errors(golden["cases"]["gradient"], want)
    assert loss <= 1e-6 and sums <= 1e-5, (loss, sums)
    assert want["numel"] == golden["cases"]["gradient"]["numel"]


@pytest.mark.parametrize("name", list(CASES))
def test_port_replays_golden_training_on_cpu(golden, name):
    got = golden_train.golden_train_replay(golden, name, "cpu")
    loss, sums = golden_train.golden_train_errors(golden["cases"][name], got)
    assert loss <= LOSS_RTOL and sums <= SUM_TOL, (name, loss, sums)


@pytest.mark.parametrize("name", golden_train.GOLDEN_TRAIN_FAULTED)
def test_sample_counts_ignored_is_caught(golden, name):
    """The planted fault of phase 4f: uniform weights for 0.75/0.25."""
    bad = golden_train.golden_train_replay(golden, name, "cpu", uniform_weights=True)
    loss, sums = golden_train.golden_train_errors(golden["cases"][name], bad)
    assert loss > LOSS_RTOL and sums > SUM_TOL, (name, loss, sums)


def test_config_fields_match_reference():
    """Field names and defaults of the port's federated and training configs
    equal the reference's; ``wire_int8`` is the one field left out."""
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    ref_fed, port_fed = fields(RefFed), fields(FederatedConfig)
    assert set(ref_fed) - set(port_fed) == {"wire_int8"}
    assert set(port_fed) <= set(ref_fed)
    assert all(port_fed[k] == ref_fed[k] for k in port_fed)
    assert fields(TrainConfig) == fields(RefTrain)
    assert FederatedConfig().secure_agg is False and TrainConfig().checkpoint_dir == ""


def test_microbatch_accumulation_in_place_is_bitwise_the_functional_form():
    """k = 3 microbatches: the in-place sum and division give the bits of
    ``tree_map(a + x)`` then ``tree_map(a / k)`` over the same microbatch
    gradients, and the loss is the microbatch mean."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    params = params_from_numpy(numpy_params(cfg, 1), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 9),
                                                               dtype=np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_fn(p, b):
        return transformer.loss_fn(cfg, p, b)

    (loss, _), grads = microbatched_value_and_grad(loss_fn, params, batch, 3)
    parts = [microbatched_value_and_grad(loss_fn, params,
                                         {k: v[j:j + 1] for k, v in batch.items()}, 1)
             for j in range(3)]
    acc = parts[0][1]
    for _, g in parts[1:]:
        acc = tree_map(lambda a, x: a + x, acc, g)
    want = tree_map(lambda a: a / 3, acc)
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        assert torch.equal(a, b)
    assert loss.item() == ((parts[0][0][0] + parts[1][0][0] + parts[2][0][0]) / 3).item()


def test_outer_nesterov_in_place_is_bitwise_the_functional_form():
    """Three rounds of the in-place nesterov outer update (leaf by leaf,
    the momentum updated in place) against the functional form it
    replaced, on bf16 params: the same bits, momentum and params."""
    from repro_torch.optim import outer

    rng = np.random.default_rng(5)
    fed = FederatedConfig(outer_optimizer="nesterov")
    shapes = {"a": (7, 33), "b": {"c": (300,)}}
    g = tree_map(lambda sh: torch.from_numpy(rng.standard_normal(sh, np.float32)).bfloat16(),
                 shapes)
    state = outer.outer_init(fed, g)
    g_f, mom_f = g, state["momentum"]
    mom_f = tree_map(torch.clone, mom_f)
    for _ in range(3):
        agg = tree_map(lambda x: (x.float() - torch.from_numpy(
            rng.standard_normal(tuple(x.shape), np.float32)) * 1e-2).bfloat16(), g_f)
        delta = tree_map(lambda a, b: a.float() - b.float(), g_f, agg)
        mom_f = tree_map(lambda m, d: fed.outer_momentum * m + d, mom_f, delta)
        want = tree_map(lambda x, m, d: (x.float() - fed.outer_lr * (fed.outer_momentum * m + d))
                        .to(x.dtype), g_f, mom_f, delta)
        g, state = outer.outer_update(fed, g, agg, state)
        for a, b in zip(tree_leaves(g) + tree_leaves(state["momentum"]),
                        tree_leaves(want) + tree_leaves(mom_f)):
            assert torch.equal(a, b)
        g_f = want


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden_train(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
