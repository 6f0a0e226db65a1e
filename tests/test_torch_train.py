"""The port's federated training stack against the reference, on the CPU.

Both packages run the stablelm-1.6b smoke config in float32 on the same
weights (the reference's init, carried by ``repro_torch.bridge``) and the
same numpy batches. Tolerances, each from what differs between the two:

- loss and fp32 gradients: the same math summed in another order (XLA vs
  PyTorch CPU kernels): loss rtol 1e-5, gradients atol 1e-5 × the largest
  gradient magnitude;
- AdamW / outer optimizer after 3 steps on identical inputs: the bias
  corrections and the schedule's cosine come from two libraries' fp32
  ``pow``/``cos`` (one ulp apart at most): rtol 1e-5;
- aggregators: sums over clouds in the same order: 1e-6;
- ``Compressor.roundtrip``: the same fp32 operations on the same inputs:
  bitwise;
- ``FederatedTrainer``, 4 steps with H = 2: the gradient differences above,
  carried through Adam's normalisation: atol 1e-4 on parameters of O(0.1-1)
  for all but 1e-4 of the elements, which stay within 2·lr·steps (an Adam
  step is about lr whatever the gradient's size, so a gradient that nearly
  cancels may step the other way); losses rtol 1e-4. The int8 error
  feedback (the parameter or gradient differences, quantized): within
  1e-4 + 1e-3 × the leaf's largest magnitude for all but 2 % of the
  elements, the others within one quantization step (at most twice the
  largest error feedback) plus the parameter bound: an input that differs
  by 1e-5 of its scale crosses a rounding boundary of the int8 grid
  (1/127 of the block's largest magnitude) with probability ~2.5e-3 per
  step, and a crossing stays in the error feedback;
- one sync round from a bridged reference state (``topk+int8``, error
  feedback, DP clip): the clip scale comes from a norm summed in another
  order and may differ in its last ulps (held to 2**-21 relative); with it,
  the top-k selection is identical and the transmitted deltas and the new
  error feedback agree to 4 ulps of each leaf's largest magnitude.

DP noise cannot replay the reference's threefry bits: it is held by its
statistics. Runs in well under a minute."""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import FederatedConfig as RefFed
from repro.configs.base import TrainConfig as RefTrain
from repro.core import aggregation as ref_agg
from repro.core import scheduler as ref_sched
from repro.core.compression import Compressor as RefCompressor
from repro.core.federated import FederatedTrainer as RefTrainer
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro.optim import adamw as ref_adamw
from repro.optim import outer as ref_outer
from repro_torch.bridge import (
    numpy_from_params, numpy_from_trainer_state, numpy_params, params_from_numpy,
    trainer_state_from_numpy,
)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core import aggregation, privacy, scheduler
from repro_torch.core.compression import Compressor
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data import SyntheticCorpus, dirichlet_mixtures, federated_batch
from repro_torch.data.federated_data import cloud_sample_counts
from repro_torch.models.model import build_model
from repro_torch.models import transformer
from repro_torch.optim import adamw, outer
from repro_torch.utils.grad import microbatched_value_and_grad
from repro_torch.utils.tree import tree_leaves

ARCH = "stablelm-1.6b"
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores (this module took 558 s of worker time in the full suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **kw),
            dataclasses.replace(ref_smoke_config(ARCH), dtype="float32", **kw))


def _jnp_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(port, ref, *, rtol=0.0, atol=0.0, what=""):
    ref = _np(ref)
    assert sorted(port) == sorted(ref), what
    for k in port:
        if isinstance(port[k], dict):
            _assert_tree_close(port[k], ref[k], rtol=rtol, atol=atol, what=f"{what}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(port[k], np.float32),
                                       np.asarray(ref[k], np.float32),
                                       rtol=rtol, atol=atol, err_msg=f"{what}/{k}")


def _batch(seed, shape, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (*shape[:-1], shape[-1] + 1), dtype=np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


# ------------------------------------------------------------- loss, grads
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    cfg, ref_cfg = _cfgs(remat=remat)
    tree = numpy_params(cfg, 3)
    batch = _batch(0, (2, 16), cfg.vocab_size)
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        lambda p: ref_transformer.loss_fn(ref_cfg, p, {k: jnp.asarray(v) for k, v in
                                                      batch.items()}), has_aux=True,
    )(_jnp_tree(tree))
    params = params_from_numpy(tree, cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, m), grads = microbatched_value_and_grad(
        lambda p, b: transformer.loss_fn(cfg, p, b), params, tb, 1)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(m["accuracy"].item(), float(ref_m["accuracy"]), rtol=1e-6)
    logits = build_model(cfg).forward(params, tb)
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(ref_transformer.forward(ref_cfg, _jnp_tree(tree),
                                           jnp.asarray(batch["tokens"]))[0]),
        rtol=1e-5, atol=1e-5)
    scale = max(float(jnp.max(jnp.abs(x))) for x in jax.tree_util.tree_leaves(ref_g))
    _assert_tree_close(numpy_from_params(grads), ref_g, atol=1e-5 * scale, what="grad")
    # two microbatches: the mean of the halves' gradients
    (loss2, _), grads2 = microbatched_value_and_grad(
        lambda p, b: transformer.loss_fn(cfg, p, b), params, tb, 2)
    np.testing.assert_allclose(loss2.item(), float(ref_loss), rtol=1e-5)
    _assert_tree_close(numpy_from_params(grads2), ref_g, atol=1e-5 * scale, what="grad mb2")


# --------------------------------------------------------------- optimizers
@pytest.mark.parametrize("outer_opt", ["none", "sgd", "nesterov"])
def test_adamw_and_outer_update_match_reference(outer_opt):
    cfg, _ = _cfgs()
    rng = np.random.default_rng(5)
    tree = numpy_params(cfg, 1)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree) for _ in range(3)]
    tcfg = TrainConfig(steps=10, lr=1e-2, warmup_steps=2, grad_clip=1.0)
    rcfg = RefTrain(steps=10, lr=1e-2, warmup_steps=2, grad_clip=1.0)
    p_ref, s_ref = _jnp_tree(tree), ref_adamw.adamw_init(_jnp_tree(tree))
    params = params_from_numpy(tree, cfg, "cpu")
    state = adamw.adamw_init(params)
    for g in grads:
        p_ref, s_ref = ref_adamw.adamw_update(rcfg, _jnp_tree(g), s_ref, p_ref)
        adamw.adamw_update(tcfg, params_from_numpy(g, cfg, "cpu"), state, params)
    _assert_tree_close(numpy_from_params(params), p_ref, rtol=1e-5, atol=1e-7, what="params")
    _assert_tree_close(numpy_from_params(state["m"]), s_ref["m"], rtol=1e-5, atol=1e-7)
    _assert_tree_close(numpy_from_params(state["v"]), s_ref["v"], rtol=1e-5, atol=1e-9)
    assert state["count"] == int(s_ref["count"]) == 3
    clipped, norm = adamw.clip_by_global_norm(params_from_numpy(grads[0], cfg, "cpu"), 1.0)
    ref_clipped, ref_norm = ref_adamw.clip_by_global_norm(_jnp_tree(grads[0]), 1.0)
    np.testing.assert_allclose(norm.item(), float(ref_norm), rtol=1e-6)
    _assert_tree_close(numpy_from_params(clipped), ref_clipped, rtol=1e-6, atol=1e-9)
    for step in (1, 2, 5, 10):
        np.testing.assert_allclose(adamw.lr_schedule(tcfg, step),
                                   float(ref_adamw.lr_schedule(rcfg, jnp.int32(step))), rtol=1e-6)
    # outer optimizer: 3 rounds toward moving aggregates
    fed, rfed = FederatedConfig(outer_optimizer=outer_opt), RefFed(outer_optimizer=outer_opt)
    g_ref = _jnp_tree(tree)
    g_port = params_from_numpy(tree, cfg, "cpu")
    o_ref, o_port = ref_outer.outer_init(rfed, g_ref), outer.outer_init(fed, g_port)
    for g in grads:
        aggd = jax.tree_util.tree_map(lambda p, d: p - 1e-2 * d, tree, g)
        g_ref, o_ref = ref_outer.outer_update(rfed, g_ref, _jnp_tree(aggd), o_ref)
        g_port, o_port = outer.outer_update(fed, g_port, params_from_numpy(aggd, cfg, "cpu"),
                                            o_port)
    _assert_tree_close(numpy_from_params(g_port), g_ref, rtol=1e-5, atol=1e-7, what="outer")


# --------------------------------------------------------------- aggregators
def test_aggregators_match_reference():
    rng = np.random.default_rng(2)
    stacked = {"a": rng.standard_normal((3, 5, 7)).astype(np.float32),
               "b": {"c": rng.standard_normal((3, 11)).astype(np.float32)}}
    glob = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    counts = np.array([100, 300, 50], np.float32)
    losses = np.array([2.0, 1.5, 3.0], np.float32)
    arrived = np.array([True, False, True])
    alphas = np.array([0.5, 0.25, 0.125], np.float32)
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tt = lambda t: {k: tt(v) if isinstance(v, dict) else T(v) for k, v in t.items()}  # noqa: E731
    w_ref = ref_agg.fedavg_weights(jnp.asarray(counts))
    w = aggregation.fedavg_weights(T(counts))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6)
    np.testing.assert_allclose(aggregation.dynamic_weights(T(losses), 0.7).numpy(),
                               np.asarray(ref_agg.dynamic_weights(jnp.asarray(losses), 0.7)),
                               rtol=1e-6)
    _assert_tree_close(numpy_from_params(aggregation.weighted_average(tt(stacked), w)),
                       ref_agg.weighted_average(_jnp_tree(stacked), w_ref), rtol=1e-6,
                       atol=1e-7)
    _assert_tree_close(numpy_from_params(aggregation.gradient_aggregate(None, tt(stacked), w)),
                       ref_agg.gradient_aggregate(None, _jnp_tree(stacked), w_ref),
                       rtol=1e-6, atol=1e-7)
    one = jax.tree_util.tree_map(lambda x: x[1], stacked)
    _assert_tree_close(numpy_from_params(aggregation.async_update(tt(glob), tt(one), 0.3)),
                       ref_agg.async_update(_jnp_tree(glob), _jnp_tree(one), 0.3),
                       rtol=1e-6, atol=1e-7)
    _assert_tree_close(
        numpy_from_params(aggregation.masked_async_update(tt(glob), tt(stacked), T(alphas),
                                                          T(arrived))),
        ref_agg.masked_async_update(_jnp_tree(glob), _jnp_tree(stacked), jnp.asarray(alphas),
                                    jnp.asarray(arrived)), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- compressor
@pytest.mark.parametrize("method", ["none", "topk", "int8", "topk+int8"])
def test_compressor_roundtrip_bitwise(method):
    rng = np.random.default_rng(4)
    tree = {"w": (rng.standard_normal((7, 300)) * 0.01).astype(np.float32),
            "b": rng.standard_normal(1000).astype(np.float32),
            "z": np.zeros(256, np.float32)}
    tree["w"][0, :40] = 0.02   # ties at the threshold
    for ratio in (0.01, 0.1):
        port = Compressor(method, ratio)
        ref = RefCompressor(method, ratio)
        out = port.roundtrip({k: torch.from_numpy(v) for k, v in tree.items()})
        want = _np(ref.roundtrip(_jnp_tree(tree)))
        for k in tree:
            np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=f"{method} {k}")
        assert port.bytes_per_sync(out) == ref.bytes_per_sync(_jnp_tree(tree))
        assert port.compression_ratio(out) == pytest.approx(ref.compression_ratio(
            _jnp_tree(tree)))


# ------------------------------------------------------------------ trainer
def _trainers(aggregation_, compression, *, dp_clip=0.0, steps=4, counts=None):
    cfg, ref_cfg = _cfgs()
    kw = dict(n_clouds=2, local_steps=2, aggregation=aggregation_, compression=compression,
              topk_ratio=0.05, dp_clip=dp_clip, cloud_sample_counts=counts)
    tkw = dict(seq_len=16, global_batch=4, steps=steps, lr=1e-3, warmup_steps=1)
    port = FederatedTrainer(build_model(cfg), FederatedConfig(**kw), TrainConfig(**tkw))
    ref = RefTrainer(ref_build_model(ref_cfg), RefFed(**kw), RefTrain(**tkw))
    return cfg, port, ref


def _round_masks(n_rounds):
    clouds = [ref_sched.CloudSpec(f"c{i}", speed=1.0 + 0.5 * i) for i in range(2)]
    ev = ref_sched.simulate_async_schedule(clouds, 2, n_rounds, base_alpha=0.5)
    return ref_sched.events_to_round_masks(ev, 2, n_rounds)


def _assert_mostly_close(port, ref, *, atol, bound, frac, what=""):
    """Every element within ``bound``, and all but ``frac`` of them within
    ``atol`` (see the module docstring for why)."""
    ref = _np(ref)
    for k in port:
        if isinstance(port[k], dict):
            _assert_mostly_close(port[k], ref[k], atol=atol, bound=bound, frac=frac,
                                 what=f"{what}/{k}")
            continue
        want = np.asarray(ref[k], np.float32)
        d = np.abs(np.asarray(port[k], np.float32) - want)
        b = bound(want) if callable(bound) else bound
        assert d.max() <= b, f"{what}/{k}: {d.max()} > {b}"
        a = atol(want) if callable(atol) else atol
        assert (d > a).mean() <= frac, f"{what}/{k}: {(d > a).sum()} of {d.size} > {a}"


def _compare_states(port_state, ref_state, *, atol):
    got = numpy_from_trainer_state(port_state)
    want = _np(ref_state)
    _assert_tree_close(got["global"]["params"], want["global"]["params"], atol=atol,
                       what="global")
    _assert_tree_close(got["clouds"]["params"], want["clouds"]["params"], atol=atol,
                       what="clouds")
    if "ef" in want:
        _assert_tree_close(got["ef"], want["ef"], atol=atol, what="ef")
    np.testing.assert_array_equal(got["step"], want["step"])


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("aggregation_", ["fedavg", "dynamic", "gradient", "async"])
def test_federated_trainer_matches_reference(aggregation_, compression):
    cfg, port, ref = _trainers(aggregation_, compression, counts=(30, 10))
    ref_state = ref.init_state(jax.random.PRNGKey(0))
    state = trainer_state_from_numpy(_np(ref_state), cfg, "cpu")
    arrived, alphas = _round_masks(3)
    step = jax.jit(ref.train_step)
    for i in range(4):
        b = _batch(10 + i, (2, 2, 16), cfg.vocab_size)
        r = i // 2
        ref_state, rm = step(ref_state, {k: jnp.asarray(v) for k, v in b.items()},
                             jnp.asarray(arrived[r]), jnp.asarray(alphas[r]))
        state, m = port.train_step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                                   torch.from_numpy(arrived[r]), torch.from_numpy(alphas[r]))
        np.testing.assert_allclose(m["per_cloud_loss"].numpy(),
                                   np.asarray(rm["per_cloud_loss"]), rtol=1e-4)
        assert float(m["synced"]) == float(rm["synced"])
    got, want = numpy_from_trainer_state(state), _np(ref_state)
    for part in ("global", "clouds"):
        _assert_mostly_close(got[part]["params"], want[part]["params"], atol=1e-4,
                             bound=2 * 1e-3 * 4, frac=1e-4, what=part)
    if "ef" in want:
        _assert_mostly_close(got["ef"], want["ef"], frac=2e-2, what="ef",
                             atol=lambda w: 1e-4 + 1e-3 * np.abs(w).max(),
                             bound=lambda w: 2 * np.abs(w).max() + 2 * 1e-3 * 4)
    np.testing.assert_array_equal(got["step"], want["step"])


def test_sync_round_from_bridged_state_matches_reference():
    """topk+int8 with error feedback and DP clip, from a reference state
    whose clouds have moved away from the global model and whose error
    feedback is live (drawn with numpy): the port and the reference each run
    the channel and the sync round from the same bridged state."""
    cfg, port, ref = _trainers("fedavg", "topk+int8", dp_clip=0.05)
    ref_state = ref.init_state(jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    moved = lambda x, s: x + jnp.asarray(rng.standard_normal(x.shape, np.float32) * s)  # noqa
    ref_state["clouds"]["params"] = jax.tree_util.tree_map(
        lambda x: moved(x, 1e-3), ref_state["clouds"]["params"])
    ref_state["ef"] = jax.tree_util.tree_map(lambda x: moved(x, 1e-4), ref_state["ef"])
    state = trainer_state_from_numpy(_np(ref_state), cfg, "cpu")
    _compare_states(state, ref_state, atol=0.0)    # the bridge carries the state exactly
    assert any(np.abs(x).max() > 0 for x in jax.tree_util.tree_leaves(_np(ref_state["ef"])))

    # the channel: transmitted deltas and new error feedback
    g = ref_state["global"]["params"]
    delta = jax.tree_util.tree_map(lambda p, gp: p - gp[None], ref_state["clouds"]["params"], g)
    ref_sent, ref_ef = jax.jit(ref._channel)(delta, ref_state["ef"])
    ref_sent, ref_ef = _np(ref_sent), _np(ref_ef)
    g_leaves = tree_leaves(state["global"]["params"])
    clouds = [tree_leaves(c["params"]) for c in state["clouds"]]
    ef = [tree_leaves(e) for e in state["ef"]]
    deltas = [lambda i, c=c: clouds[c][i] - g_leaves[i] for c in range(2)]
    sent = list(port._channel(deltas, ef, len(g_leaves)))
    ref_sent_leaves = jax.tree_util.tree_leaves(ref_sent)
    ref_ef_leaves = jax.tree_util.tree_leaves(ref_ef)
    assert len(sent) == len(ref_sent_leaves)
    for i, (per_cloud, want) in enumerate(zip(sent, ref_sent_leaves)):
        for c in range(2):
            got = per_cloud[c].numpy()
            ulp = 4 * np.float32(2.0**-23) * np.abs(want[c]).max()
            np.testing.assert_array_equal(got != 0, want[c] != 0, err_msg=f"top-k leaf {i}")
            np.testing.assert_allclose(got, want[c], rtol=0, atol=ulp, err_msg=f"sent {i}")
            np.testing.assert_allclose(ef[c][i].numpy(), ref_ef_leaves[i][c], rtol=0,
                                       atol=ulp + 4 * 2.0**-23 * np.abs(ref_ef_leaves[i][c]).max())
    # the clip scale itself: the reference's and the port's norms
    sq = float(sum(jnp.sum(jnp.square(x[0] + e[0])) for x, e in zip(
        jax.tree_util.tree_leaves(delta), jax.tree_util.tree_leaves(ref_state["ef"]))))
    assert sq > 0.05**2      # the clip is active

    # the whole sync round from the bridged state
    state = trainer_state_from_numpy(_np(ref_state), cfg, "cpu")
    new_ref = jax.jit(ref._sync)(ref_state, jnp.ones(2, bool), jnp.full(2, 0.5))
    port._sync(state, torch.ones(2, dtype=torch.bool), torch.full((2,), 0.5))
    _compare_states(state, new_ref, atol=1e-6)


def test_dp_noise_statistics():
    """σ·C/n_clouds noise on the aggregate: mean ≈ 0, std within 5%."""
    std = privacy.dp_noise_stddev(1.0, 0.3, 3)
    gen = torch.Generator().manual_seed(0)
    out = privacy.add_gaussian_noise({"x": torch.zeros(100_000), "y": torch.ones(7)}, gen, std)
    x = out["x"].double()
    assert abs(x.mean().item()) < 5 * std / np.sqrt(x.numel())
    assert abs(x.std().item() / std - 1) < 0.05
    assert out["y"].shape == (7,) and out["y"].dtype == torch.float32
    # clip_update: the norm comes out at the clip bound
    tree = {"a": torch.full((10,), 3.0), "b": torch.full((6,), 4.0)}
    clipped, norm = privacy.clip_update(tree, 1.0)
    assert norm.item() == pytest.approx(np.sqrt(90 + 96))
    total = sum(x.square().sum() for x in clipped.values()).sqrt().item()
    assert total == pytest.approx(1.0, rel=1e-6)


# ---------------------------------------------------------------------- data
def test_data_and_scheduler_properties():
    gen = torch.Generator().manual_seed(0)
    corpus = SyntheticCorpus(vocab_size=512, n_domains=4, noise=0.1)
    mix = dirichlet_mixtures(gen, 3, 4, 0.3)
    assert mix.shape == (3, 4) and torch.allclose(mix.sum(1), torch.ones(3))
    assert torch.equal(dirichlet_mixtures(gen, 5, 4, 0.0).argmax(1),
                       torch.tensor([0, 1, 2, 3, 0]))
    b = federated_batch(corpus, gen, mix, 64, 32)
    assert b["tokens"].shape == (3, 64, 32) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    a, c = corpus.domain_params()
    dom = b["domain"].long()
    pred = (a[dom][..., None] * b["tokens"].long() + c[dom][..., None]) % 512
    follow = (pred == b["labels"]).float().mean().item()
    assert abs(follow - corpus.oracle_accuracy()) < 0.03
    ra, rc = ref_corpus_params(4, 512)
    assert a.tolist() == ra and c.tolist() == rc
    assert torch.equal(cloud_sample_counts(gen, 3), torch.full((3,), 10_000, dtype=torch.int32))
    assert (cloud_sample_counts(gen, 3, skew=0.5) >= 1).all()
    # the scheduler is a numpy copy: identical to the reference
    specs = [scheduler.CloudSpec(f"c{i}", speed=1.0 + 0.5 * i) for i in range(3)]
    rspecs = [ref_sched.CloudSpec(f"c{i}", speed=1.0 + 0.5 * i) for i in range(3)]
    ev = scheduler.simulate_async_schedule(specs, 4, 9, sync_bytes=1e8)
    rev = ref_sched.simulate_async_schedule(rspecs, 4, 9, sync_bytes=1e8)
    assert [dataclasses.astuple(e) for e in ev] == [dataclasses.astuple(e) for e in rev]
    for x, y in zip(scheduler.events_to_round_masks(ev, 3, 9),
                    ref_sched.events_to_round_masks(rev, 3, 9)):
        np.testing.assert_array_equal(x, y)
    assert scheduler.sync_round_time(specs, 4, 1.0, 1e8) == ref_sched.sync_round_time(
        rspecs, 4, 1.0, 1e8)


def ref_corpus_params(n_domains, vocab):
    from repro.data.pipeline import SyntheticCorpus as RefCorpus

    a, c = RefCorpus(vocab_size=vocab, n_domains=n_domains).domain_params()
    return np.asarray(a).tolist(), np.asarray(c).tolist()


# ----------------------------------------------------------------------- CLI
def test_train_cli_on_cpu_imports_no_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['train', '--device', 'cpu', '--steps', '4', '--clouds', '2',"
        " '--local-steps', '2', '--compression', 'topk+int8', '--dp-clip', '1.0',"
        " '--dp-noise', '0.1']\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
    )
    # one intra-op thread, as the other subprocess CLI tests run: under the
    # suite's 6 workers a team of threads per core stalled this smoke run
    # past its 120 s (it takes ~5 s alone)
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "HOME": str(pathlib.Path.home()), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert "step     4" in out and "final: loss=" in out
    loss = float(out.split("final: loss=")[1].split()[0])
    assert np.isfinite(loss)
