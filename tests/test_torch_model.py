"""The port's model against the reference on the stablelm-1.6b smoke config.

Weights come from ``repro_torch.bridge.numpy_params`` and load into both
packages. Under float32 the two compute the same math in another order:
logits allclose at rtol = atol = 1e-5 (observed ~1e-6) and identical greedy
argmax. Under bfloat16 the packages round activations at different points
(XLA fuses, PyTorch rounds every op, and the port's attention softmax stays
fp32 where the reference casts probabilities to bf16), each rounding worth
up to 2**-8 relative: logits are held within atol 5e-2 on logits of O(1).

Also: the bridge, the layer functions, the port's batched prefill against
its own one-row-at-a-time path, and that the port never loads JAX or the
reference package."""
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
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import layers as ref_layers
from repro_torch.bridge import numpy_from_params, numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import common, layers
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16_LOGIT_ATOL = 5e-2


def _configs(dtype):
    return (dataclasses.replace(get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(ref_smoke_config(ARCH), dtype=dtype))


def _both(dtype, seed=0):
    cfg, ref_cfg = _configs(dtype)
    tree = numpy_params(cfg, seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
    return (cfg, build_model(cfg), params_from_numpy(tree, cfg, "cpu"),
            ref_build_model(ref_cfg), ref_params)


# ------------------------------------------------------------------ bridge
def test_bridge_round_trips_and_matches_reference_tree():
    cfg, _ = _configs("float32")
    tree = numpy_params(cfg, 3)
    back = numpy_from_params(params_from_numpy(tree, cfg, "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)
    # the same leaf paths, shapes and dtype as the reference's own init
    ref_cfg = _configs("bfloat16")[1]
    ref_tree = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    ref_shapes = {jax.tree_util.keystr(p): x.shape
                  for p, x in jax.tree_util.tree_leaves_with_path(ref_tree)}
    port = build_model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(0), "cpu")
    port_shapes = {jax.tree_util.keystr(p): tuple(x.shape)
                   for p, x in jax.tree_util.tree_leaves_with_path(port)}
    assert port_shapes == ref_shapes
    assert all(x.dtype == torch.bfloat16 for x in jax.tree_util.tree_leaves(port))
    # bf16 casts agree bit for bit
    bf = params_from_numpy(tree, cfg, "cpu", torch.bfloat16)
    np.testing.assert_array_equal(
        bf["layers"]["attn"]["wq"].float().numpy(),
        np.asarray(jnp.asarray(tree["layers"]["attn"]["wq"], jnp.bfloat16), np.float32))


# ------------------------------------------------------------------ layers
def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32), np.float32) * 3
    w = rng.standard_normal((32,), np.float32) * 0.1
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        layers.rms_norm(tx, torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-5, atol=1e-5)
    # positions up to 500 rad: fp32 sin/cos of large angles differ by ~ulp(angle)
    np.testing.assert_allclose(
        layers.apply_rope(tx, torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=1e-4, atol=1e-4)
    mlp = {k: rng.standard_normal(s, np.float32) * 0.2
           for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    xm = rng.standard_normal((3, 32), np.float32)
    np.testing.assert_allclose(
        layers.apply_mlp({k: torch.from_numpy(v) for k, v in mlp.items()},
                         torch.from_numpy(xm)).numpy(),
        np.asarray(ref_layers.apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                                        jnp.asarray(xm), "silu")),
        rtol=1e-5, atol=1e-5)


def test_lm_logits_masks_padded_vocab_like_reference():
    cfg, ref_cfg = _configs("float32")
    cfg = dataclasses.replace(cfg, vocab_size=500)
    ref_cfg = dataclasses.replace(ref_cfg, vocab_size=500)
    assert common.padded_vocab(500) == ref_common.padded_vocab(500) == 512
    rng = np.random.default_rng(1)
    emb = {"tok": rng.standard_normal((512, 128), np.float32),
           "unembed": rng.standard_normal((128, 512), np.float32)}
    x = rng.standard_normal((2, 3, 128), np.float32)
    got = common.lm_logits({k: torch.from_numpy(v) for k, v in emb.items()},
                           torch.from_numpy(x), cfg).numpy()
    want = np.asarray(ref_common.lm_logits({k: jnp.asarray(v) for k, v in emb.items()},
                                           jnp.asarray(x), ref_cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got[..., 500:] == -(2.0**30)).all()


# --------------------------------------------------------------- transformer
NS, NPAGES, PS, TW = 3, 14, 4, 6
TABLE = np.array([[3, 1, 5, 12, 10, 0], [2, 7, 0, 0, 0, 0], [9, 4, 6, 8, 11, 13]], np.int32)


def _run_rounds(dtype):
    """Cold round → decode step → suffix round → decode step, on both
    packages; returns the four pairs of logits and the final pools."""
    cfg, model, params, ref_model, ref_params = _both(dtype)
    jc = ref_model.init_paged_cache(ref_params, NS, NPAGES, PS, TW)
    tc = model.init_paged_cache(NS, NPAGES, PS, TW, device="cpu")
    jc["table"] = jnp.asarray(TABLE)
    tc["table"] = torch.from_numpy(TABLE.copy())
    rng = np.random.default_rng(1)
    pairs = []

    def both(fn_j, fn_t):
        nonlocal jc, tc
        jc, jl = fn_j(jc)
        tc, tl = fn_t(tc)
        pairs.append((tl.float().numpy(), np.asarray(jl, np.float32)))

    toks = rng.integers(1, 500, (2, 16)).astype(np.int32)
    lens, slots = np.array([11, 6], np.int32), np.array([0, 2], np.int32)
    T = torch.from_numpy
    both(lambda c: ref_model.prefill_slots(ref_params, c, jnp.asarray(toks), jnp.asarray(lens),
                                           jnp.asarray(slots)),
         lambda c: model.prefill_slots(params, c, T(toks), T(lens), T(slots)))
    feed = rng.integers(1, 500, (NS, 1)).astype(np.int32)
    both(lambda c: ref_model.decode(ref_params, c, jnp.asarray(feed)),
         lambda c: model.decode(params, c, T(feed)))
    # suffix round: row 0 continues slot 0 behind its 12 cached tokens (3
    # pages, prefix width bucket 4), row 1 starts slot 1 cold (starts 0)
    stoks = rng.integers(1, 500, (2, 8)).astype(np.int32)
    starts, slens, sslots = (np.array([12, 0], np.int32), np.array([7, 5], np.int32),
                             np.array([0, 1], np.int32))
    both(lambda c: ref_model.prefill_slots(ref_params, c, jnp.asarray(stoks), jnp.asarray(slens),
                                           jnp.asarray(sslots), starts=jnp.asarray(starts),
                                           prefix_pages=4),
         lambda c: model.prefill_slots(params, c, T(stoks), T(slens), T(sslots), starts=T(starts),
                                       prefix_pages=4))
    feed = rng.integers(1, 500, (NS, 1)).astype(np.int32)
    both(lambda c: ref_model.decode(ref_params, c, jnp.asarray(feed)),
         lambda c: model.decode(params, c, T(feed)))
    return cfg, pairs, (tc, jc)


def test_rounds_match_reference_float32():
    cfg, pairs, (tc, jc) = _run_rounds("float32")
    for port, want in pairs:
        np.testing.assert_allclose(port, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(port[:, : cfg.vocab_size].argmax(-1),
                                      want[:, : cfg.vocab_size].argmax(-1))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    # every pool slot the rows own holds the same k/v (scratch page 0 and
    # unowned pages aside)
    owned = np.unique(TABLE[TABLE > 0])
    np.testing.assert_allclose(tc["k"].numpy()[:, owned], np.asarray(jc["k"])[:, owned],
                               rtol=1e-5, atol=1e-5)


def test_rounds_match_reference_bfloat16():
    _, pairs, _ = _run_rounds("bfloat16")
    for port, want in pairs:
        np.testing.assert_allclose(port, want, rtol=0, atol=BF16_LOGIT_ATOL)


def test_batched_prefill_matches_own_looped_prefill():
    """One batched cold dispatch (with a length-0 padding row) against one
    dispatch per row: same logits, same pools outside scratch page 0 (the
    fp write sends dead tokens there), same positions. Not a bitwise
    contract: batch shape changes the matmul blocking, so fp32 allclose."""
    cfg, model, params, _, _ = _both("float32")
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 500, (3, 16)).astype(np.int32)
    lens = np.array([13, 4, 0], np.int32)
    caches = []
    for _ in range(2):
        c = model.init_paged_cache(NS, NPAGES, PS, TW, device="cpu")
        c["table"] = torch.from_numpy(TABLE.copy())
        caches.append(c)
    T = torch.from_numpy
    _, batched = model.prefill_slots(params, caches[0], T(toks), T(lens),
                                     T(np.array([0, 2, 1], np.int32)))
    looped = []
    for r, slot in ((0, 0), (1, 2)):
        _, lg = model.prefill_slots(params, caches[1], T(toks[r:r + 1, : lens[r]]),
                                    T(lens[r:r + 1]), T(np.array([slot], np.int32)))
        looped.append(lg[0])
    torch.testing.assert_close(batched[:2], torch.stack(looped), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(caches[0]["k"][:, 1:], caches[1]["k"][:, 1:], rtol=1e-5,
                               atol=1e-5)
    assert caches[0]["pos"].tolist() == caches[1]["pos"].tolist() == [13, 0, 4]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b", "pixtral-12b",
                                  "recurrentgemma-2b", "xlstm-125m", "whisper-medium"])
def test_build_model_takes_every_arch_type(arch):
    """All six of the reference's arch types build, each with the
    whole-prompt prefill, the transformer family also with the slot-cache
    API; an unknown one raises."""
    model = build_model(get_smoke_config(arch))
    assert (model.prefill_slots is not None) == (model.cfg.arch_type in ("dense", "moe"))
    assert (model.prefill_slot is not None) == (model.prefill_slots is not None)
    assert model.prefill is not None
    with pytest.raises(ValueError, match="arch_type"):
        build_model(dataclasses.replace(get_smoke_config(arch), arch_type="cnn"))


# ---------------------------------------------------------- import isolation
def test_port_imports_neither_jax_nor_the_reference():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"sys.path.insert(0, {str(ROOT)!r}); import chip_smoke, channel_cases\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " or m == 'repro']\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "HOME": str(pathlib.Path.home()), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, cwd=ROOT)
    for path in [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py",
                 ROOT / "channel_cases.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import repro.", "from repro.", "import repro ",
                                     "import jax", "from jax")), f"{path}: {s}"
