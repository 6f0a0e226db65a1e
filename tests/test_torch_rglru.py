"""The port's recurrentgemma family (``repro_torch.models.rglru``: RG-LRU
blocks and local attention) against the reference's ``models/rglru.py``,
at the smoke config in float32 on the same numpy-drawn weights
(``repro_torch.bridge.numpy_params``), the reference jitted once per
function in this module.

Tolerances. The RG-LRU scan is a Hillis-Steele scan in the port and
``jax.lax.associative_scan`` in the reference: the same products and sums
grouped otherwise, so the two agree to fp32 rounding (1e-5 relative, and
against a sequential loop too). Logits: within ``LOGIT_RTOL`` = 1e-5 of
their scale at every step (the scan order, XLA's and torch's matmul
orders). Greedy tokens: equal. The caches after prefill: within 1e-5.

Also here: the plain ring decodes and flash prefill at recurrentgemma-2b's
head dim 256 and G 10 against the reference's plain versions, the engine's
refusal, and the golden file the card replays
(``src/repro_torch/testdata/golden_recurrent_serve_smoke.json``: the
single-batch tokens of both recurrent families; rewrite it with
``PYTHONPATH=src:. python tests/test_torch_rglru.py``)."""
import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ref as jref
from repro.models import build_model as ref_build_model
from repro.models import rglru as ref_rglru
from repro_torch.bridge import numpy_from_params, numpy_params, params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ref
from repro_torch.launch import engine as port_engine
from repro_torch.launch.serve import generate_batch
from repro_torch.models import rglru
from repro_torch.models.model import build_model

ARCH = "recurrentgemma-2b"
TESTDATA = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "testdata"
GOLDEN_SERVE = TESTDATA / "golden_recurrent_serve_smoke.json"
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_models(arch: str, seed: int = 0):
    """(port model, port params, reference model, reference params) at the
    smoke config in float32 on ``numpy_params(cfg, seed)``."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    tree = numpy_params(cfg, seed)
    return (build_model(cfg), params_from_numpy(tree, cfg, "cpu"), ref_build_model(ref_cfg),
            jax.tree_util.tree_map(jnp.asarray, tree))


@pytest.fixture(scope="module")
def hybrid():
    return both_models(ARCH)


@functools.lru_cache(maxsize=None)
def _ref_decode(arch: str, window: int):
    _, _, ref_model, _ = both_models(arch)
    return jax.jit(lambda p, c, t: ref_model.decode(p, c, t, window=window))


def close(got: torch.Tensor, want, rtol=LOGIT_RTOL) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def close_trees(got, want, rtol=LOGIT_RTOL) -> None:
    """Two cache trees (the port's tensors, the reference's arrays) leaf for
    leaf: same structure and shapes, values within ``rtol`` of each leaf's
    largest magnitude."""
    g = jax.tree_util.tree_leaves(numpy_from_params(got))
    w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want))
    assert [x.shape for x in g] == [x.shape for x in w]
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(float(np.abs(b).max()), 1.0))


def test_configs_are_the_references():
    for get, ref_get in ((get_smoke_config, ref_smoke_config), (get_config, ref_get_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(ref_get(ARCH))


def test_params_tree_is_the_references(hybrid):
    """The port's own init lays its tree out as the reference's (periods
    and rest, shapes, float32 Λ drawn as the reference draws it)."""
    model, params, ref_model, ref_params = hybrid
    mine = numpy_from_params(model.init(torch.Generator().manual_seed(0), "cpu"))
    want = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    assert ([x.shape for x in jax.tree_util.tree_leaves(mine)]
            == [x.shape for x in jax.tree_util.tree_leaves(want)])
    lam = ref_rglru._init_rec_mixing(jax.random.PRNGKey(0), ref_model.cfg)["lam"]
    np.testing.assert_array_equal(mine["periods"]["pos0"]["mix"]["lam"][0], np.asarray(lam))


def test_forward_and_loss_match_reference(hybrid):
    model, params, ref_model, ref_params = hybrid
    toks = np.random.default_rng(1).integers(0, 512, (2, 20)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    # one compile for both
    want, want_loss = jax.jit(lambda p, b: (ref_model.forward(p, b), ref_model.loss(p, b)[0]))(
        ref_params, jax.tree_util.tree_map(jnp.asarray, batch))
    close(model.forward(params, {"tokens": torch.from_numpy(batch["tokens"])}), want)
    got_loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


def test_teacher_forced_decode_matches_reference(hybrid):
    """24 decode steps over a ring of 8 slots (window 8: it wraps twice),
    logits at every step within 1e-5 of their scale; the caches then equal
    leaf for leaf."""
    model, params, ref_model, ref_params = hybrid
    toks = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    cache = model.init_cache(2, 24, window=8, device="cpu")
    jc = ref_model.init_cache(ref_params, {"tokens": jnp.asarray(toks)}, 24, window=8)
    dec = _ref_decode(ARCH, 8)
    for t in range(24):
        cache, got = model.decode(params, cache, torch.from_numpy(toks[:, t:t + 1]), window=8)
        jc, want = dec(ref_params, jc, jnp.asarray(toks[:, t:t + 1]))
        close(got, want)
    close_trees(cache, jc)


def test_prefill_across_a_ring_wrap_then_decode(hybrid):
    """A 20-token prompt through ``prefill`` with window 8 (the ring wraps
    twice), then 6 decode steps: the logits equal teacher-forcing the
    prompt through the decode step (port) and the reference's prefill and
    decode, and the cache after prefill is the reference's."""
    model, params, ref_model, ref_params = hybrid
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 512, (2, 20)).astype(np.int32)
    feed = rng.integers(0, 512, (2, 6)).astype(np.int32)
    cache, got = model.prefill(params, torch.from_numpy(prompt), window=8)
    jc, want = jax.jit(lambda p, t: ref_model.prefill(p, {"tokens": t}, window=8))(
        ref_params, jnp.asarray(prompt))
    close(got, want)
    close_trees(cache, jc)
    tf = model.init_cache(2, 20, window=8, device="cpu")
    for t in range(20):
        tf, tf_logits = model.decode(params, tf, torch.from_numpy(prompt[:, t:t + 1]), window=8)
    close(got, tf_logits.numpy())
    dec = _ref_decode(ARCH, 8)
    for t in range(6):
        x = feed[:, t:t + 1]
        cache, got = model.decode(params, cache, torch.from_numpy(x), window=8)
        tf, tf_logits = model.decode(params, tf, torch.from_numpy(x), window=8)
        jc, want = dec(ref_params, jc, jnp.asarray(x))
        close(got, want)
        close(got, tf_logits.numpy())


def test_decode_state_stays_bounded_past_three_rings(hybrid):
    """Greedy decode of 3x the ring's capacity (window 8, 24 tokens): no
    leaf changes shape or address (the decode writes in place, as a CUDA
    graph replays it), the logits stay finite."""
    model, params, _, _ = hybrid
    cache = model.init_cache(1, 24, window=8, device="cpu")
    leaves = jax.tree_util.tree_leaves(cache)
    before = [(x.shape, x.data_ptr()) for x in leaves]
    tok = torch.zeros((1, 1), dtype=torch.long)
    for _ in range(24):
        cache, logits = model.decode(params, cache, tok, window=8)
        assert torch.isfinite(logits[:, :512]).all()
        tok = logits[:, :512].argmax(-1, keepdim=True)
    assert [(x.shape, x.data_ptr()) for x in jax.tree_util.tree_leaves(cache)] == before
    assert int(cache["pos"]) == 24


def test_rg_lru_scan_matches_loop_and_reference(hybrid):
    """``rg_lru_scan`` (and its gradient) against the sequential recurrence
    and the reference's associative scan, with a carried h0, over a
    length that is no power of two."""
    _, params, _, ref_params = hybrid
    p = params["periods"]["pos0"]["mix"]
    p = {k: v[0] for k, v in p.items()}
    jp = jax.tree_util.tree_map(lambda a: a[0], ref_params["periods"]["pos0"]["mix"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 37, 128)).astype(np.float32)
    h0 = rng.standard_normal((2, 128)).astype(np.float32)
    y, h_last = rglru.rg_lru_scan(p, torch.from_numpy(x), torch.from_numpy(h0))
    jy, jh = jax.jit(ref_rglru.rg_lru_scan)(jp, jnp.asarray(x), jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    h = torch.from_numpy(h0)
    loop = []
    for t in range(x.shape[1]):
        out, h = rglru.rg_lru_step(p, torch.from_numpy(x[:, t:t + 1]), h)
        loop.append(out)
    torch.testing.assert_close(y, torch.cat(loop, 1), rtol=1e-5, atol=1e-5)
    a = torch.rand(1, 13, 3, dtype=torch.float64, requires_grad=True)
    b = torch.randn(1, 13, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(rglru.linear_scan, (a, b))


def test_causal_conv_matches_reference(hybrid):
    _, params, _, ref_params = hybrid
    p = {k: params["periods"]["pos1"]["mix"][k][0] for k in ("conv_w", "conv_b")}
    jp = {k: ref_params["periods"]["pos1"]["mix"][k][0] for k in ("conv_w", "conv_b")}
    rng = np.random.default_rng(5)
    x, tail = (rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 128), (2, 3, 128)))
    for t in (None, tail):
        y, nt = rglru.causal_conv(p, torch.from_numpy(x), None if t is None else
                                  torch.from_numpy(t))
        jy, jt = jax.jit(ref_rglru.causal_conv)(jp, jnp.asarray(x),
                                                 None if t is None else jnp.asarray(t))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(jt))


def test_gelu_is_the_tanh_form():
    """GeGLU's GELU is jax.nn.gelu's default, the tanh approximation."""
    from repro_torch.models.layers import gelu

    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# --------------------------------------------- the kernels' plain versions
def test_plain_attention_at_hd256_g10_matches_reference():
    """``kernels/ref.py``'s ring decodes (both) and flash prefill at
    recurrentgemma-2b's shape (hd 256, 10 query heads over 1 kv head,
    window) against the reference's plain versions."""
    rng = np.random.default_rng(6)
    b, cap, hkv, g, hd = 3, 16, 1, 10, 256
    q = rng.standard_normal((b, hkv, g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, cap, hkv, hd)).astype(np.float32) for _ in range(2))
    pos = np.array([5, 15, 40], np.int32)
    T = torch.from_numpy
    want = jref.swa_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), 12)
    for fn in (ref.swa_decode_ref, ref.ring_paged_decode_ref):
        np.testing.assert_allclose(fn(T(q), T(k), T(v), T(pos), 12).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    s = 24
    qs = rng.standard_normal((2, s, hkv, g, hd)).astype(np.float32)
    ks, vs = (rng.standard_normal((2, s, hkv, hd)).astype(np.float32) for _ in range(2))
    want = jref.flash_prefill_ref(jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs),
                                  causal=True, window=7)
    np.testing.assert_allclose(ref.flash_prefill_ref(T(qs), T(ks), T(vs), window=7).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_take_hd256():
    """The ring decode and flash-prefill wrappers take hd 256 (and G 10);
    the kernels the hybrid never reaches keep refusing it."""
    from repro_torch.kernels.flash_prefill import check_group
    from repro_torch.kernels.paged_decode import HEAD_DIMS, WIDE_HEAD_DIMS, kernel_head_dim

    assert kernel_head_dim(256) == 256 and 256 in WIDE_HEAD_DIMS and 256 not in HEAD_DIMS
    check_group("flash_prefill", 256, 10, WIDE_HEAD_DIMS)
    with pytest.raises(ValueError, match="group"):
        check_group("flash_prefill", 256, 40, WIDE_HEAD_DIMS)
    with pytest.raises(ValueError, match="head dim"):
        check_group("suffix_prefill", 256, 10)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", [ARCH, "xlstm-125m"])
def test_engine_refuses_the_recurrent_families(arch):
    model = build_model(get_smoke_config(arch))
    assert model.init_slot_cache is None and model.prefill_slots is None
    with pytest.raises(ValueError, match="slot-cache API"):
        port_engine.ServeEngine(model, {}, device="cpu")
    with pytest.raises(ValueError, match="slot-cache API"):
        port_engine.serve_continuous(arch, device="cpu", n_requests=1, gen_tokens=1)


# ------------------------------------------------------------------ golden
SERVE_CASES = (("xlstm-125m", 0, 10, 8), (ARCH, 8, 12, 8))   # arch, window, prompt, gen


def serve_prompts(arch: str, prompt_len: int) -> np.ndarray:
    return np.random.default_rng(7).integers(1, 512, (3, prompt_len)).astype(np.int32)


def reference_serve(arch: str, window: int, prompt_len: int, gen: int) -> list:
    """The reference's single-batch path (``launch/serve.serve_batch``'s
    loop: the prompt teacher-forced through the jitted decode step in
    lockstep, then greedy tokens) on the bridged float32 weights."""
    _, _, ref_model, ref_params = both_models(arch)
    prompts = jnp.asarray(serve_prompts(arch, prompt_len))
    cache = ref_model.init_cache(ref_params, {"tokens": prompts}, prompt_len + gen,
                                 window=window)
    dec = _ref_decode(arch, window)
    for i in range(prompt_len):
        cache, logits = dec(ref_params, cache, prompts[:, i:i + 1])
    out = []
    tok = jnp.argmax(logits[:, :512], axis=-1)[:, None]
    for _ in range(gen):
        out.append(tok)
        cache, logits = dec(ref_params, cache, tok)
        tok = jnp.argmax(logits[:, :512], axis=-1)[:, None]
    return np.asarray(jnp.concatenate(out, 1)).tolist()


@functools.lru_cache(maxsize=None)
def _golden_serve() -> str:
    return json.dumps({
        "config": "smoke, dtype float32, numpy_params seed 0",
        "seed": 0,
        "cases": [dict(arch=a, window=w, prompts=serve_prompts(a, p).tolist(), gen=n,
                       tokens=reference_serve(a, w, p, n)) for a, w, p, n in SERVE_CASES],
    })


def make_golden_serve() -> dict:
    return json.loads(_golden_serve())


def test_golden_serve_file_matches_reference():
    assert json.loads(GOLDEN_SERVE.read_text()) == make_golden_serve()


def test_port_single_batch_matches_golden():
    """``generate_batch`` (the serve CLI's single-batch path, its decode
    step one GraphCache specialization) gives the reference's tokens."""
    g = json.loads(GOLDEN_SERVE.read_text())
    for case in g["cases"]:
        model, params, _, _ = both_models(case["arch"], g["seed"])
        gen, _, _ = generate_batch(model, params, torch.tensor(case["prompts"]), case["gen"],
                                   window=case["window"])
        assert gen.tolist() == case["tokens"], case["arch"]


if __name__ == "__main__":
    GOLDEN_SERVE.write_text(json.dumps(make_golden_serve(), indent=1) + "\n")
    print(f"wrote {GOLDEN_SERVE}")
