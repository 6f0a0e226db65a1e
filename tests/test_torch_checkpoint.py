"""The port's checkpointer (``repro_torch.checkpoint``) against the
reference's, on the CPU: one on-disk format, so a checkpoint either package
writes restores in the other bit for bit (float32 and bfloat16 smoke params);
keep/GC, ``latest_step``, the two errors; the train CLI's periodic save
(``run_training(checkpoint_dir=)``, ``--checkpoint-dir``), which the loop
takes from ``TrainConfig``; and the trainer's refusal of the two config
fields it does not honour."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train
from repro_torch.launch.train import run_training
from repro_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores (a 100-step smoke run went from seconds to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(dtype, arch="stablelm-1.6b"):
    """The same smoke params in both packages, each leaf in the port's
    dtype (xlstm's gate biases stay float32 in a bf16 tree, in both)."""
    cfg = get_smoke_config(arch)
    tree = numpy_params(cfg, 4)
    port = params_from_numpy(tree, cfg, "cpu", getattr(torch, dtype))
    ref = jax.tree_util.tree_map(
        lambda a, p: jnp.asarray(a).astype(jnp.bfloat16 if p.dtype == torch.bfloat16
                                          else jnp.float32), tree, port)
    return port, ref


def _port_bits(tree):
    return [(x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
            for x in tree_leaves(tree)]


def _ref_bits(tree):
    return [np.asarray(x).view(np.int16) if x.dtype == jnp.bfloat16 else np.asarray(x)
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch,key", [("stablelm-1.6b", "['layers']/['attn']/['wq']"),
                                      ("xlstm-125m", "['periods']/['pos1']/['blk']/['r_z']")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages_bitwise(tmp_path, dtype, arch, key):
    """Also the recurrent families' periodic trees (lists and None walked
    as ``jax.tree_util`` walks them)."""
    port, ref = _trees(dtype, arch)
    Checkpointer(str(tmp_path / "p")).save(7, port)
    RefCheckpointer(str(tmp_path / "r")).save(7, ref)
    # the same manifest, key for key
    manifests = [json.loads((tmp_path / d / "step_00000007" / "manifest.json").read_text())
                 for d in ("p", "r")]
    assert manifests[0] == manifests[1]
    assert key in manifests[0]["leaves"]
    # port → reference, reference → port, each bit for bit
    from_port = RefCheckpointer(str(tmp_path / "p")).restore(7, ref)
    from_ref = Checkpointer(str(tmp_path / "r")).restore(7, port)
    for a, b in zip(_ref_bits(from_port), _ref_bits(ref)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_port_bits(from_ref), _port_bits(port)):
        np.testing.assert_array_equal(a, b)
    assert [x.dtype for x in tree_leaves(from_ref)] == [x.dtype for x in tree_leaves(port)]
    assert getattr(torch, dtype) in {x.dtype for x in tree_leaves(from_ref)}
    # the payloads hold the same arrays under the same names
    with np.load(tmp_path / "p" / "step_00000007" / "arrays.npz") as a, \
            np.load(tmp_path / "r" / "step_00000007" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_keep_latest_and_errors(tmp_path):
    port, ref = _trees("float32")
    for mod, d, tree in ((Checkpointer, "p", port), (RefCheckpointer, "r", ref)):
        ck = mod(str(tmp_path / d), keep=3)
        assert ck.latest_step() is None and ck.all_steps() == []
        for step in (1, 5, 3, 9, 12):
            ck.save(step, tree)
        assert ck.all_steps() == [5, 9, 12] and ck.latest_step() == 12
        assert sorted(os.listdir(tmp_path / d)) == ["step_00000005", "step_00000009",
                                                    "step_00000012"]
    ck, rck = Checkpointer(str(tmp_path / "p")), RefCheckpointer(str(tmp_path / "r"))
    extra = dict(port, extra={"w": torch.zeros(3)})
    with pytest.raises(KeyError, match="extra"):
        ck.restore(12, extra)
    with pytest.raises(KeyError, match="extra"):
        rck.restore(12, dict(ref, extra={"w": jnp.zeros(3)}))
    bad = dict(port, ln_f={"scale": torch.zeros(5)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(12, bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        rck.restore(12, dict(ref, ln_f={"scale": jnp.zeros(5)}))


def test_train_cli_checkpoint_dir_saves_the_final_global_params(tmp_path, monkeypatch):
    """``--checkpoint-dir`` through the CLI's ``main``: 100 steps save step
    100, which restores to the run's final global params bit for bit."""
    runs = []

    def keep(*a, **kw):
        runs.append(run_training(*a, **kw))
        return runs[-1]

    monkeypatch.setattr(train, "run_training", keep)
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--steps", "100", "--clouds", "1", "--local-steps", "2",
        "--seq-len", "8", "--batch", "1",
        "--checkpoint-dir", str(tmp_path)])
    train.main()
    final = runs[0]["state"]["global"]["params"]
    ck = Checkpointer(str(tmp_path))
    assert ck.all_steps() == [100]
    for a, b in zip(tree_leaves(ck.restore(100, final)), tree_leaves(final)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_run_training_reads_the_config_fields(tmp_path):
    """The loop takes ``log_every``, ``checkpoint_dir`` and
    ``checkpoint_every`` from its ``TrainConfig``: a loss logged every 2 of
    4 steps, saves every 100 steps into the directory given (too few steps
    here to reach one), and no saves without a directory."""
    res = run_training(device="cpu", steps=4, n_clouds=1, local_steps=2, seq_len=8,
                       per_cloud_batch=1, log_every=2, checkpoint_dir=str(tmp_path),
                       log_fn=lambda *_: None)
    tcfg = res["trainer"].train
    assert (tcfg.log_every, tcfg.checkpoint_dir, tcfg.checkpoint_every) == (
        2, str(tmp_path), train.CHECKPOINT_EVERY)
    assert [h["step"] for h in res["history"]] == [2, 4]
    assert Checkpointer(str(tmp_path)).all_steps() == []
    res = run_training(device="cpu", steps=2, n_clouds=1, local_steps=2, seq_len=8,
                       per_cloud_batch=1, log_fn=lambda *_: None)
    assert res["trainer"].train.checkpoint_every == 0


@pytest.mark.parametrize("field", ["secure_agg", "eval_every"])
def test_trainer_refuses_the_fields_it_does_not_honour(field):
    """``FederatedConfig.secure_agg`` and ``TrainConfig.eval_every``, which
    the reference declares and never reads, raise when set rather than
    train without the masking or evaluation they ask for."""
    from repro_torch.configs.base import FederatedConfig, TrainConfig
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.models.model import build_model

    fed = FederatedConfig(secure_agg=field == "secure_agg")
    tcfg = TrainConfig(eval_every=int(field == "eval_every"))
    with pytest.raises(ValueError, match=field):
        FederatedTrainer(build_model(get_smoke_config("stablelm-1.6b")), fed, tcfg)
