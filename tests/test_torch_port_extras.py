"""The port's last public functions and examples against the reference, on
the CPU.

* ``kernels/ops.dp_transmit``: at stddev 0 equal to the reference's
  ``ops.dp_transmit`` (plain path) on the same bridged leaves within 1e-6 of
  each leaf's scale; its global norm at most ``clip_norm``, as the
  reference's ``tests/test_kernels.py`` checks; with noise, the noise's law
  (mean 0, standard deviation ``stddev``) and the same output from the same
  generator.
* ``data/pipeline.batch_iterator``: shapes, next-token labels, and the
  same stream from the same seed (another from another).
* ``utils/tree.tree_bytes`` against the reference's on bridged real trees
  and on meta trees (the reference's ``jax.eval_shape`` trees).
* The four torch examples, each run in process at its smallest size on
  the CPU; the continuous-serving example's tokens equal the single-batch
  oracle's for every request."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops as ref_ops
from repro.launch import specs as rspecs
from repro.models import build_model as ref_build_model
from repro.utils.tree import tree_bytes as ref_tree_bytes
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticCorpus, batch_iterator
from repro_torch.kernels import ops
from repro_torch.launch import specs as pspecs
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_bytes, tree_leaves

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged(arch="stablelm-1.6b"):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tree = numpy_params(cfg, 0)
    return (params_from_numpy(tree, cfg, "cpu"),
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree))


# ---------------------------------------------------------------- dp_transmit
def test_dp_transmit_matches_reference_at_stddev_zero():
    params, ref_params = _bridged()
    clip = 1.0
    got = ops.dp_transmit(params, torch.Generator().manual_seed(0), clip, 0.0)
    want = jax.tree_util.tree_leaves(ref_ops.dp_transmit(ref_params, jax.random.PRNGKey(0),
                                                         clip, 0.0))
    assert len(tree_leaves(got)) == len(want)
    for g, w in zip(tree_leaves(got), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30))
    norm = torch.sqrt(sum(x.double().square().sum() for x in tree_leaves(got)))
    assert float(norm) <= clip * (1 + 1e-4)


def test_dp_transmit_noise_follows_its_law():
    params, _ = _bridged()
    clip, std = 1.0, 0.25
    clipped = ops.dp_transmit(params, torch.Generator().manual_seed(1), clip, 0.0)
    noisy = ops.dp_transmit(params, torch.Generator().manual_seed(1), clip, std)
    again = ops.dp_transmit(params, torch.Generator().manual_seed(1), clip, std)
    z = torch.cat([((n - c) / std).reshape(-1) for n, c in
                   zip(tree_leaves(noisy), tree_leaves(clipped))]).double()
    assert z.numel() > 100_000
    assert abs(float(z.mean())) < 5 / z.numel() ** 0.5          # 5 standard errors
    assert abs(float(z.std()) - 1.0) < 0.01
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(noisy), tree_leaves(again)))


# -------------------------------------------------------------- batch_iterator
def test_batch_iterator_is_deterministic_with_next_token_labels():
    corpus = SyntheticCorpus(vocab_size=512, n_domains=4, noise=0.1)
    mix = torch.ones(4) / 4

    def take(seed, n=3):
        it = batch_iterator(corpus, seed, mix, 4, 16)
        return [next(it) for _ in range(n)]

    a, b, c = take(7), take(7), take(8)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["tokens"], c[0]["tokens"])
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])      # a stream, not one batch
    for batch in a:
        assert batch["tokens"].shape == batch["labels"].shape == (4, 16)
        assert batch["tokens"].dtype == torch.int32 and batch["domain"].shape == (4,)
        assert torch.equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])


# ----------------------------------------------------------------- tree_bytes
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "xlstm-125m", "whisper-medium"])
def test_tree_bytes_matches_reference(arch):
    params, ref_params = _bridged(arch)
    assert tree_bytes(params) == ref_tree_bytes(ref_params)
    meta_params, meta_opt = pspecs.state_specs(build_model(get_smoke_config(arch)))
    ref_meta, ref_opt = rspecs.state_specs(ref_build_model(ref_smoke_config(arch)))
    assert tree_bytes(meta_params) == ref_tree_bytes(ref_meta)
    assert tree_bytes(meta_opt) == ref_tree_bytes(ref_opt)


# ------------------------------------------------------------------- examples
def _example(name: str):
    sys.path.insert(0, str(EXAMPLES))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(EXAMPLES))


def test_quickstart_example_trains():
    out = _example("torch_quickstart").main(["--device", "cpu", "--steps", "4", "--seq", "16"])
    assert out["params"] > 0 and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))


def test_federated_lm_example_runs_every_aggregator(tmp_path):
    out = _example("torch_federated_lm").main(
        ["--device", "cpu", "--steps", "4", "--d-model", "64", "--layers", "2", "--batch", "2",
         "--seq", "16", "--checkpoint", "--checkpoint-dir", str(tmp_path)])
    assert set(out) == {"fedavg", "dynamic", "gradient"}
    assert all(np.isfinite(v["eval_loss"]) for v in out.values())
    assert all((tmp_path / a / "step_00000004").is_dir() for a in out)


def test_serve_longcontext_example_keeps_its_state_constant():
    out = _example("torch_serve_longcontext").main(
        ["--device", "cpu", "--decode-steps", "12", "--window", "4"])
    assert set(out["state_bytes"]) == {"mistral-nemo-12b", "recurrentgemma-2b", "xlstm-125m"}
    assert out["rel_err"] == 0.0     # plain against plain on the CPU


def test_continuous_serving_example_matches_the_oracle():
    out = _example("torch_continuous_serving").main(["--device", "cpu", "--stagger", "0.01"])
    assert out["oracle_agree"], "engine tokens differ from the single-batch oracle's"
    for k in ("kernel_agree", "paged_agree", "oversubscribed_agree", "prefix_agree",
              "mesh_agree"):
        assert out[k], k
    assert out["slice_rejects"] == "exceeds_pool" and out["mesh_long_tokens"] > 0
