"""The port's whisper family (``repro_torch.models.whisper``: the
encoder-decoder, LayerNorm with a bias, the plain GELU MLP, sinusoidal
positions, cross-attention, the decode cache holding every layer's cross
K/V) against the reference's ``models/whisper.py``, at the smoke config in
float32 on the same numpy-drawn weights (``repro_torch.bridge.numpy_params``)
and audio embeddings, on one intra-op thread.

Tolerances: LayerNorm, the MLP, the sinusoid and the encoder within 1e-5
relative (fp32 sums in other orders; XLA's and torch's exp, sin and cos may
differ in the last ulp); logits within ``LOGIT_RTOL`` = 1e-5 of their scale
at every step; the loss within 1e-5; every gradient leaf within 1e-5 of
the largest gradient magnitude (as ``tests/test_torch_train.py``); caches
within 1e-5 of each leaf's scale; greedy tokens equal.

Also here: the golden file the card replays
(``src/repro_torch/testdata/golden_vlm_audio_smoke.json``: whisper's
single-batch loop and its prefill then decode, pixtral's multimodal prefill
then decode and its single batch, all the reference's fp32 greedy tokens on
numpy-seeded weights, audio and patches; rewrite it with
``PYTHONPATH=src:. python tests/test_torch_whisper.py``), the port's
``generate_batch`` and prefill on its inputs, and the refusals (the engine:
no slot-cache API; the trainer: no audio in the federated corpus)."""
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
from repro.models import layers as ref_layers
from repro.models import whisper as ref_whisper
from repro_torch.bridge import numpy_from_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch.serve import generate_batch
from repro_torch.models import layers, whisper
from tests.test_torch_rglru import both_models, close, close_trees

ARCH = "whisper-medium"
VLM = "pixtral-12b"
TESTDATA = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "testdata"
GOLDEN = TESTDATA / "golden_vlm_audio_smoke.json"
W = 6                      # a ring smaller than most prompts below (as the reference's test)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def audio_model():
    return both_models(ARCH)


def audio_embeds(cfg, b: int, seed: int) -> np.ndarray:
    """(b, encoder_seq, D) float32 frame embeddings from numpy's seed."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)


def patch_embeds(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.vision_seq, cfg.d_model), dtype=np.float32)


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_decode(arch: str, window: int):
    _, _, ref_model, _ = both_models(arch)
    return jax.jit(lambda p, c, t: ref_model.decode(p, c, t, window=window))


def _batch(cfg, seed: int, b: int = 2, s: int = 10) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "audio_embeds": audio_embeds(cfg, b, seed + 100)}


# ------------------------------------------------------------------ pieces
@pytest.mark.parametrize("arch", [ARCH, VLM])
def test_configs_are_the_references(arch):
    for get, ref_get in ((get_smoke_config, ref_smoke_config), (get_config, ref_get_config)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(ref_get(arch))


def test_params_tree_is_the_references(audio_model):
    """The port's own init lays its tree out as the reference's (every
    leaf path, shape and dtype), LayerNorm scales one and biases zero."""
    model, _, ref_model, _ = audio_model
    mine = numpy_from_params(model.init(torch.Generator().manual_seed(0), "cpu"))
    want = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    assert ([x.shape for x in jax.tree_util.tree_leaves(mine)]
            == [x.shape for x in jax.tree_util.tree_leaves(want)])
    assert (mine["enc"]["ln_post"]["scale"] == 1).all()
    assert not mine["dec"]["layers"]["mlp"]["b_up"].any()


def test_layer_norm_and_plain_mlp_match_reference(audio_model):
    _, params, _, ref_params = audio_model
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 7, 128)) * 3 + 1).astype(np.float32)
    ln = params["dec"]["layers"]["ln_x"]
    jln = ref_params["dec"]["layers"]["ln_x"]
    got = layers.layer_norm(torch.from_numpy(x), ln["scale"][1], ln["bias"][1], 1e-5)
    want = ref_layers.layer_norm(jnp.asarray(x), jln["scale"][1], jln["bias"][1], 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    mlp = {k: v[0] for k, v in params["enc"]["layers"]["mlp"].items()}
    jmlp = {k: v[0] for k, v in ref_params["enc"]["layers"]["mlp"].items()}
    got = layers.apply_mlp(mlp, torch.from_numpy(x))
    want = jax.jit(lambda p, x: ref_layers.apply_mlp(p, x, "gelu"))(jmlp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sinusoid_positions_match_reference():
    """At offset 0 and at decode offsets (a device tensor, as the decode
    step passes its position), against the reference's and its dense rows
    (reference ``tests/test_ring_wraparound.py``)."""
    d = 128
    dense = whisper.sinusoid_positions(40, d)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref_whisper.sinusoid_positions(40, d)),
                               rtol=1e-5, atol=1e-5)
    for pos in (0, 3, 9, 39):
        step = whisper.sinusoid_positions(1, d, offset=torch.tensor(pos, dtype=torch.int32))
        want = ref_whisper.sinusoid_positions(1, d, offset=jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(step.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(step[0].numpy(), dense[pos].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel", [False, True])
def test_encode_matches_reference(audio_model, kernel):
    """The encoder, plain (training) and through the flash-prefill route
    (serving; its plain version on the CPU)."""
    _, params, ref_model, ref_params = audio_model
    audio = audio_embeds(ref_model.cfg, 2, 3)
    got = whisper.encode(get_cfg32(), params, torch.from_numpy(audio), kernel=kernel)
    want = jax.jit(lambda p, a: ref_whisper.encode(ref_model.cfg, p, a))(
        ref_params, jnp.asarray(audio))
    close(got, want)


def get_cfg32():
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32")


# ------------------------------------------------------------------- model
def test_forward_loss_and_gradients_match_reference(audio_model):
    """``forward`` and ``loss``, and the gradient of every leaf against
    ``jax.value_and_grad(model.loss)``."""
    model, params, ref_model, ref_params = audio_model
    batch = _batch(model.cfg, 4)
    want_logits = jax.jit(ref_model.forward)(ref_params, _jnp(batch))
    (want_loss, _), want_g = jax.jit(jax.value_and_grad(ref_model.loss, has_aux=True))(
        ref_params, _jnp(batch))
    close(model.forward(params, _torch(batch)), want_logits)
    p = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss, _ = model.loss(p, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got_g = jax.tree_util.tree_map(lambda t: t.grad.numpy(), p)
    scale = max(float(jnp.abs(x).max()) for x in jax.tree_util.tree_leaves(want_g))
    g, w = jax.tree_util.tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)
    assert len(g) == len(w) == 35
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5 * scale)


def test_teacher_forced_decode_matches_forward_and_reference(audio_model):
    """``init_cache`` (the encoder, the cross K/V) then 10 decode steps:
    logits at every step equal the reference's decode and the port's own
    training forward at that position; the cache then equals the
    reference's leaf for leaf."""
    model, params, ref_model, ref_params = audio_model
    batch = _batch(model.cfg, 5)
    toks = batch["tokens"]
    fwd = model.forward(params, _torch(batch))
    cache = model.init_cache(params, _torch(batch), 10)
    jc = ref_model.init_cache(ref_params, _jnp(batch), 10)
    dec = _ref_decode(ARCH, 0)
    for t in range(toks.shape[1]):
        cache, got = model.decode(params, cache, torch.from_numpy(toks[:, t:t + 1]))
        jc, want = dec(ref_params, jc, jnp.asarray(toks[:, t:t + 1]))
        close(got, want)
        close(got, fwd[:, t].numpy())
    close_trees({k: cache[k] for k in ("k", "v", "xk", "xv", "pos")},
                {k: jc[k] for k in ("k", "v", "xk", "xv", "pos")})


@pytest.mark.parametrize("s", [5, 6, 7, 15])
def test_prefill_across_a_ring_wrap_then_decode(audio_model, s):
    """A prompt through ``prefill`` into a ring of W = 6 slots (no wrap,
    exact fit, wrap by one, several wraps; window W), then 3 decode steps:
    the logits and the cache after prefill are the reference's, the decode
    steps' too, and equal teacher-forcing the prompt through the decode
    step (reference ``tests/test_ring_wraparound.py``)."""
    model, params, ref_model, ref_params = audio_model
    rng = np.random.default_rng(6 + s)
    toks = rng.integers(0, 512, (2, s + 3)).astype(np.int32)
    audio = audio_embeds(model.cfg, 2, 7)
    batch = {"tokens": toks[:, :s], "audio_embeds": audio}
    cache, got = model.prefill(params, _torch(batch), window=W, cache_window=W)
    jc, want = jax.jit(lambda p, b: ref_model.prefill(p, b, window=W, cache_window=W))(
        ref_params, _jnp(batch))
    close(got, want)
    close_trees({k: cache[k] for k in ("k", "v", "xk", "xv", "pos")},
                {k: jc[k] for k in ("k", "v", "xk", "xv", "pos")})
    tf = model.init_cache(params, _torch(batch), s + 3, window=W)
    for t in range(s):
        tf, tf_logits = model.decode(params, tf, torch.from_numpy(toks[:, t:t + 1]), window=W)
    close(got, tf_logits.numpy())
    dec = _ref_decode(ARCH, W)
    for t in range(s, s + 3):
        x = toks[:, t:t + 1]
        cache, got = model.decode(params, cache, torch.from_numpy(x), window=W)
        tf, tf_logits = model.decode(params, tf, torch.from_numpy(x), window=W)
        jc, want = dec(ref_params, jc, jnp.asarray(x))
        close(got, want)
        close(got, tf_logits.numpy())


def test_decode_writes_in_place_at_a_device_position(audio_model):
    """The decode step writes every cache leaf in place (a CUDA graph
    replays it) and reads its position only on the device; the paged and
    the streaming ring kernels' plain versions give the same logits."""
    model, params, _, _ = audio_model
    batch = _batch(model.cfg, 8, b=1, s=4)
    caches = [model.init_cache(params, _torch(batch), 8, window=4) for _ in range(2)]
    before = [(x.shape, x.data_ptr()) for x in jax.tree_util.tree_leaves(caches[0])]
    tok = torch.zeros((1, 1), dtype=torch.long)
    for _ in range(8):
        (c0, l0), (c1, l1) = (model.decode(params, c, tok, window=4, paged=p)
                              for c, p in zip(caches, (True, False)))
        torch.testing.assert_close(l0, l1, rtol=0, atol=0)
        tok = l0[:, :512].argmax(-1, keepdim=True)
    assert [(x.shape, x.data_ptr()) for x in jax.tree_util.tree_leaves(caches[0])] == before
    assert int(caches[0]["pos"]) == 8


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", [ARCH, VLM])
def test_engine_and_trainer_refuse_the_family(arch):
    from repro_torch.configs.base import FederatedConfig, TrainConfig
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.models.model import build_model

    model = build_model(get_smoke_config(arch))
    assert model.init_slot_cache is None and model.prefill_slots is None
    assert model.prefill is not None
    with pytest.raises(ValueError, match="slot-cache API"):
        port_engine.ServeEngine(model, {}, device="cpu")
    with pytest.raises(ValueError, match="slot-cache API"):
        port_engine.serve_continuous(arch, device="cpu", n_requests=1, gen_tokens=1)
    with pytest.raises(ValueError, match="embeds"):
        FederatedTrainer(model, FederatedConfig(), TrainConfig())


# ------------------------------------------------------------------ golden
SERVE_CASES = ((ARCH, 0, 8, 8), (ARCH, W, 10, 8), (VLM, 0, 8, 6))   # arch, window, prompt, gen
PREFILL_CASES = ((ARCH, 8, 8), (VLM, 8, 8))                         # arch, prompt, gen
B = 3


def golden_prompts(arch: str, prompt_len: int) -> np.ndarray:
    return np.random.default_rng(11).integers(1, 512, (B, prompt_len)).astype(np.int32)


def golden_inputs(cfg) -> dict:
    """The batch's inputs beyond tokens, from numpy's seed 12."""
    if cfg.arch_type == "audio":
        return {"audio_embeds": audio_embeds(cfg, B, 12)}
    return {"patch_embeds": patch_embeds(cfg, B, 12)}


def _greedy(logits) -> jax.Array:
    return jnp.argmax(logits[:, :512], axis=-1)[:, None]


def reference_serve(arch: str, window: int, prompt_len: int, gen: int) -> list:
    """The reference's single-batch loop (``launch/serve.serve_batch``:
    ``init_cache``, whose audio branch runs the encoder, the prompt
    teacher-forced through the jitted decode step, greedy tokens; a vlm
    decodes from the tokens alone) on the bridged float32 weights."""
    _, _, ref_model, ref_params = both_models(arch)
    prompts = jnp.asarray(golden_prompts(arch, prompt_len))
    inputs = golden_inputs(ref_model.cfg) if arch == ARCH else {}
    cache = ref_model.init_cache(ref_params, {"tokens": prompts, **_jnp(inputs)},
                                 prompt_len + gen, window=window)
    dec = _ref_decode(arch, window)
    for i in range(prompt_len):
        cache, logits = dec(ref_params, cache, prompts[:, i:i + 1])
    out, tok = [], _greedy(logits)
    for _ in range(gen):
        out.append(tok)
        cache, logits = dec(ref_params, cache, tok)
        tok = _greedy(logits)
    return np.asarray(jnp.concatenate(out, 1)).tolist()


def reference_prefill(arch: str, prompt_len: int, gen: int) -> list:
    """The reference's ``prefill`` (whisper: the encoder and the prompt;
    pixtral: the image prefix and the prompt) into rings with room for
    ``gen`` more tokens, then greedy decode steps."""
    _, _, ref_model, ref_params = both_models(arch)
    cfg = ref_model.cfg
    batch = {"tokens": jnp.asarray(golden_prompts(arch, prompt_len)),
             **_jnp(golden_inputs(cfg))}
    prefix = cfg.vision_seq if cfg.arch_type == "vlm" else 0
    cache, logits = ref_model.prefill(ref_params, batch,
                                      cache_window=prefix + prompt_len + gen)
    dec = _ref_decode(arch, 0)
    out, tok = [], _greedy(logits)
    for _ in range(gen):
        out.append(tok)
        cache, logits = dec(ref_params, cache, tok)
        tok = _greedy(logits)
    return np.asarray(jnp.concatenate(out, 1)).tolist()


@functools.lru_cache(maxsize=None)
def _golden() -> str:
    return json.dumps({
        "config": "smoke, dtype float32, numpy_params seed 0; prompts from numpy seed 11; "
                  "audio and patch embeddings N(0, 1) from numpy seed 12, shape (3, "
                  "encoder_seq or vision_seq, d_model)",
        "seed": 0, "inputs_seed": 12,
        "serve": [dict(arch=a, window=w, prompts=golden_prompts(a, p).tolist(), gen=n,
                       tokens=reference_serve(a, w, p, n)) for a, w, p, n in SERVE_CASES],
        "prefill": [dict(arch=a, prompts=golden_prompts(a, p).tolist(), gen=n,
                         tokens=reference_prefill(a, p, n)) for a, p, n in PREFILL_CASES],
    })


def make_golden() -> dict:
    return json.loads(_golden())


def test_golden_file_matches_reference():
    assert json.loads(GOLDEN.read_text()) == make_golden()


def port_prefill_tokens(model, params, prompts: torch.Tensor, inputs: dict, gen: int) -> list:
    """The port's counterpart of ``reference_prefill`` (also what the card
    replays)."""
    cfg = model.cfg
    prefix = cfg.vision_seq if cfg.arch_type == "vlm" else 0
    cache, logits = model.prefill(params, {"tokens": prompts, **inputs},
                                  cache_window=prefix + prompts.shape[1] + gen)
    out = []
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(gen):
        out.append(tok)
        cache, logits = model.decode(params, cache, tok)
        tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    return torch.cat(out, 1).tolist()


def test_port_matches_golden():
    """``generate_batch`` (the serve CLI's single-batch path; whisper's
    audio passed as its input) and prefill-then-decode give the
    reference's tokens on the golden file's inputs."""
    g = json.loads(GOLDEN.read_text())
    for case in g["serve"]:
        model, params, _, _ = both_models(case["arch"], g["seed"])
        inputs = ({} if case["arch"] == VLM else
                  _torch(golden_inputs(model.cfg)))
        gen, _, _ = generate_batch(model, params, torch.tensor(case["prompts"]), case["gen"],
                                   window=case["window"], inputs=inputs)
        assert gen.tolist() == case["tokens"], case["arch"]
    for case in g["prefill"]:
        model, params, _, _ = both_models(case["arch"], g["seed"])
        got = port_prefill_tokens(model, params, torch.tensor(case["prompts"]),
                                  _torch(golden_inputs(model.cfg)), case["gen"])
        assert got == case["tokens"], case["arch"]


def test_serve_batch_draws_audio_and_decodes():
    """``serve_batch`` on the CPU at the smoke config: the audio from its
    own ``torch.Generator``, every family's tokens in range, the decode
    step one graph specialization."""
    from repro_torch.launch.serve import serve_batch

    for arch in (ARCH, VLM):
        res = serve_batch(arch, batch=2, prompt_len=4, gen_tokens=3, device="cpu",
                          log_fn=lambda _: None)
        toks = np.asarray(res["generated"])
        assert toks.shape == (2, 3) and ((toks >= 0) & (toks < 512)).all()
        assert res["compiles"] == {"decode": 1}


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
