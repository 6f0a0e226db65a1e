"""The port's pixtral family (``repro_torch.models.vlm``: the dense decoder
over a projected image prefix, ``transformer.forward_embeds`` and
``transformer.prefill_embeds``) against the reference's ``models/vlm.py``,
at the smoke config in float32 on the same numpy-drawn weights
(``repro_torch.bridge.numpy_params``, the projector included) and patch
embeddings, on one intra-op thread.

Tolerances as in ``tests/test_torch_whisper.py``: logits within 1e-5 of
their scale, the loss within 1e-5, every gradient leaf within 1e-5 of the
largest gradient magnitude, caches within 1e-5 of each leaf's scale. The
golden trace the card replays (pixtral's prefill with patches, then
decode, and its single batch) is written and held there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import numpy_from_params
from repro_torch.models import transformer
from tests.test_torch_rglru import both_models, close, close_trees
from tests.test_torch_whisper import _jnp, _ref_decode, _torch, patch_embeds

ARCH = "pixtral-12b"


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
def vlm_model():
    return both_models(ARCH)


def _batch(cfg, seed: int, b: int = 2, s: int = 10) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "patch_embeds": patch_embeds(cfg, b, seed + 100)}


def test_params_tree_is_the_references(vlm_model):
    """The dense decoder's tree plus ``projector/{w, b}``, as the
    reference's."""
    model, _, ref_model, _ = vlm_model
    mine = numpy_from_params(model.init(torch.Generator().manual_seed(0), "cpu"))
    want = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    assert ([x.shape for x in jax.tree_util.tree_leaves(mine)]
            == [x.shape for x in jax.tree_util.tree_leaves(want)])
    assert mine["projector"]["w"].shape == (128, 128) and not mine["projector"]["b"].any()


def test_forward_loss_and_gradients_match_reference(vlm_model):
    """``forward`` over the image prefix and the text, the text-region
    ``loss``, and the gradient of every leaf (the projector's included)
    against ``jax.value_and_grad(model.loss)``."""
    model, params, ref_model, ref_params = vlm_model
    batch = _batch(model.cfg, 1)
    want_logits = jax.jit(ref_model.forward)(ref_params, _jnp(batch))
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(ref_model.loss, has_aux=True))(
        ref_params, _jnp(batch))
    got_logits = model.forward(params, _torch(batch))
    assert got_logits.shape == (2, 16 + 10, 512)
    close(got_logits, want_logits)
    p = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss, m = model.loss(p, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), float(want_m["accuracy"]), rtol=1e-6)
    got_g = jax.tree_util.tree_map(lambda t: t.grad.numpy(), p)
    scale = max(float(jnp.abs(x).max()) for x in jax.tree_util.tree_leaves(want_g))
    g, w = jax.tree_util.tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)
    assert len(g) == len(w) == 14
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5 * scale)


def test_forward_embeds_keeps_the_dense_forward(vlm_model):
    """``transformer.forward`` goes through ``forward_embeds``: on tokens
    alone it is bitwise the stack run on the token embeddings."""
    model, params, _, _ = vlm_model
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 9)))
    logits, _ = transformer.forward(model.cfg, params, toks)
    h, _ = transformer.forward_embeds(model.cfg, params, params["embed"]["tok"][toks],
                                      torch.arange(9)[None].expand(2, 9))
    from repro_torch.models.common import lm_logits
    torch.testing.assert_close(logits, lm_logits(params["embed"], h, model.cfg), rtol=0, atol=0)


@pytest.mark.parametrize("cache_window", [0, 12, 40])
def test_prefill_with_patches_then_decode_matches_reference(vlm_model, cache_window):
    """The multimodal ``prefill`` (16 patches + 10 tokens) into rings of
    ``cache_window`` slots (0: the 26 positions exactly, so the decode
    wraps at once; 12: smaller than the prefix, the ring keeps its last 12;
    40: headroom), then 4 decode steps: the logits and the cache are the
    reference's, and the prefill's logits are the forward's last
    position."""
    model, params, ref_model, ref_params = vlm_model
    batch = _batch(model.cfg, 3)
    del batch["labels"]
    cache, got = model.prefill(params, _torch(batch), cache_window=cache_window)
    jc, want = jax.jit(lambda p, b: ref_model.prefill(p, b, cache_window=cache_window))(
        ref_params, _jnp(batch))
    close(got, want)
    close(got, model.forward(params, _torch(batch))[:, -1].numpy())
    close_trees({k: cache[k] for k in ("k", "v", "pos")}, {k: jc[k] for k in ("k", "v", "pos")})
    feed = np.random.default_rng(4).integers(0, 512, (2, 4)).astype(np.int32)
    dec = _ref_decode(ARCH, 0)
    for t in range(4):
        cache, got = model.decode(params, cache, torch.from_numpy(feed[:, t:t + 1]))
        jc, want = dec(ref_params, jc, jnp.asarray(feed[:, t:t + 1]))
        close(got, want)


def test_prefill_window_matches_reference(vlm_model):
    """A sliding window (8) in the prefill's attention and the decode's,
    over a ring of 8 slots: the reference's logits."""
    model, params, ref_model, ref_params = vlm_model
    batch = _batch(model.cfg, 5)
    del batch["labels"]
    cache, got = model.prefill(params, _torch(batch), window=8, cache_window=8)
    jc, want = jax.jit(lambda p, b: ref_model.prefill(p, b, window=8, cache_window=8))(
        ref_params, _jnp(batch))
    close(got, want)
    dec = _ref_decode(ARCH, 8)
    tok = np.full((2, 1), 7, np.int32)
    for _ in range(3):
        cache, got = model.decode(params, cache, torch.from_numpy(tok), window=8)
        jc, want = dec(ref_params, jc, jnp.asarray(tok))
        close(got, want)
