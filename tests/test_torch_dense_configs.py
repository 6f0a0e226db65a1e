"""The port's other dense configs (stablelm-12b, mistral-nemo-12b,
phi4-mini-3.8b) against the reference, at their smoke configs in float32 on
the same numpy-drawn weights (``repro_torch.bridge.numpy_params``).

The three smoke configs differ from stablelm-1.6b's where the port's
attention has to follow: G 2 (4 query heads over 2 kv heads), rope theta
1e6 (mistral-nemo) and, for phi4-mini (d 120 over 4 heads, tied
embeddings), head dim 30, which the caches and the kernels hold padded to 32
(``kernel_head_dim``). At fp32 the two packages' logits differ only in
summation order: 1e-5 of the logit scale. Engine traces must give identical
greedy tokens and counters.

Also here: the golden files the card replays
(``src/repro_torch/testdata/golden_{stablelm12b,mistral_nemo,phi4_mini}_smoke.json``;
rewrite them with ``PYTHONPATH=src:. python tests/test_torch_dense_configs.py``),
the padded pool against an unpadded plain computation, and the head-dim
rules."""
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
from repro.launch import engine as ref_engine
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_decode import HEAD_DIMS, kernel_head_dim, split_len
from repro_torch.launch import engine as port_engine
from repro_torch.models.model import build_model

ARCHS = ("stablelm-12b", "mistral-nemo-12b", "phi4-mini-3.8b")
TESTDATA = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "testdata"
GOLDEN = {
    "stablelm-12b": TESTDATA / "golden_stablelm12b_smoke.json",
    "mistral-nemo-12b": TESTDATA / "golden_mistral_nemo_smoke.json",
    "phi4-mini-3.8b": TESTDATA / "golden_phi4_mini_smoke.json",
}
COUNTERS = ("prefill_tokens", "prefix_hit_pages", "cow_copies", "suffix_dispatches",
            "cold_dispatches", "preemptions")
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


def _both(arch, seed=0):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    tree = numpy_params(cfg, seed)
    return (build_model(cfg), params_from_numpy(tree, cfg, "cpu"), ref_build_model(ref_cfg),
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree))


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_RTOL * scale)


def test_configs_are_the_references():
    for arch in (*ARCHS, "olmoe-1b-7b", "qwen3-moe-235b-a22b"):
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(ref_smoke_config(arch)), arch
    assert get_smoke_config("phi4-mini-3.8b").resolved_head_dim == 30
    assert set(ARCH_IDS) == {"stablelm-1.6b", *ARCHS, "olmoe-1b-7b", "qwen3-moe-235b-a22b",
                             "xlstm-125m", "recurrentgemma-2b", "pixtral-12b",
                             "whisper-medium"}


@pytest.mark.parametrize("arch", (*ARCHS, "olmoe-1b-7b", "qwen3-moe-235b-a22b"))
def test_full_configs_are_the_references(arch):
    """The published widths the card serves are the reference's, field for
    field."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    model, params, ref_model, ref_params = _both(arch)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)
    want = jax.jit(ref_model.forward)(ref_params, {"tokens": jnp.asarray(tokens)})
    _close(model.forward(params, {"tokens": torch.from_numpy(tokens)}), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_logits_match_reference(arch):
    """Cold prefill (two rows, right-padded), a decode step, a suffix
    prefill over the cached first page, another decode step: logits within
    1e-5 of their scale at each dispatch, and the pools equal outside
    scratch page 0 (the port's padded head dims zero)."""
    model, params, ref_model, ref_params = _both(arch)
    slots, pages, page, width = 2, 9, 4, 4
    table = np.arange(1, 9, dtype=np.int32).reshape(slots, width)
    cache = model.init_paged_cache(slots, pages, page, width, device="cpu")
    cache["table"][:] = torch.from_numpy(table)
    ref_cache = ref_model.init_paged_cache(ref_params, slots, pages, page, width)
    ref_cache["table"] = jnp.asarray(table)
    rng = np.random.default_rng(2)
    t, j = torch.from_numpy, jnp.asarray

    def both(port_fn, ref_fn, *args, starts=None, prefix_pages=None):
        nonlocal cache, ref_cache
        kw = {} if starts is None else dict(prefix_pages=prefix_pages)
        if starts is not None:
            kw["starts"] = t(starts)
        cache, got = port_fn(params, cache, *map(t, args), **kw)
        if starts is not None:
            kw["starts"] = j(starts)
        ref_cache, want = ref_fn(ref_params, ref_cache, *map(j, args), **kw)
        _close(got, want)

    toks = rng.integers(1, 512, (2, 8)).astype(np.int32)
    both(model.prefill_slots, ref_model.prefill_slots, toks, np.array([6, 3], np.int32),
         np.array([0, 1], np.int32))
    both(model.decode, ref_model.decode, rng.integers(1, 512, (2, 1)).astype(np.int32))
    assert cache["pos"].tolist() == [7, 4]     # slot 1 holds 4 tokens: its first page
    both(model.prefill_slots, ref_model.prefill_slots,
         rng.integers(1, 512, (1, 4)).astype(np.int32), np.array([3], np.int32),
         np.array([1], np.int32), starts=np.array([4], np.int32), prefix_pages=2)
    both(model.decode, ref_model.decode, rng.integers(1, 512, (2, 1)).astype(np.int32))
    hd = model.cfg.resolved_head_dim
    for plane in ("k", "v"):   # outside scratch page 0, where dead tokens land
        np.testing.assert_allclose(cache[plane][:, 1:, ..., :hd].numpy(),
                                   np.asarray(ref_cache[plane])[:, 1:], rtol=1e-5, atol=1e-5)
        assert not cache[plane][..., hd:].any()
    assert cache["pos"].tolist() == np.asarray(ref_cache["pos"]).tolist()


# ------------------------------------------------------------------ golden
def _shared_prefix_prompts(seed=3, page=4):
    rng = np.random.default_rng(seed)
    common = rng.integers(1, 512, 3 * page)
    cold = [rng.integers(1, 512, n) for n in (5, 9, 13)]
    shared = [np.concatenate([common, rng.integers(1, 512, k)]) for k in (0, 3, 6)]
    return cold + shared + [common.copy()]


def golden_trace(arch) -> dict:
    """The trace the card replays: the shared-prefix trace with a
    copy-on-write hit, so cold prefill, suffix prefill and decode all run."""
    return {
        "config": f"{arch} smoke, dtype float32",
        "seed": 0,
        "engine": dict(num_slots=3, max_seq=32, page_size=4, prefix_cache=True,
                       paged_cache=True),
        "max_new_tokens": 6,
        "prompts": [p.tolist() for p in _shared_prefix_prompts()],
    }


@functools.lru_cache(maxsize=None)
def _reference_golden(arch) -> str:
    g = golden_trace(arch)
    _, _, ref_model, ref_params = _both(arch, g["seed"])
    eng = ref_engine.ServeEngine(ref_model, ref_params, **g["engine"])
    outs = eng.run([ref_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                       max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    g["tokens"] = [[int(t) for t in o.tokens] for o in outs]
    g["counters"] = {key: int(eng.pool_stats[key]) for key in COUNTERS}
    return json.dumps(g)


def make_golden(arch) -> dict:
    """Run the reference engine on ``golden_trace(arch)``; add its tokens
    and pool counters."""
    return json.loads(_reference_golden(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_file_matches_reference(arch):
    assert json.loads(GOLDEN[arch].read_text()) == make_golden(arch)


def replay_golden(g: dict, model, params, device) -> tuple[list, dict]:
    """The port's engine on a golden trace: (tokens, counters)."""
    eng = port_engine.ServeEngine(model, params, device=device, **g["engine"])
    outs = eng.run([port_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                        max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    return [o.tokens for o in outs], {key: eng.pool_stats[key] for key in g["counters"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_engine_matches_reference(arch):
    g = make_golden(arch)
    model, params, _, _ = _both(arch, g["seed"])
    tokens, counters = replay_golden(g, model, params, "cpu")
    assert tokens == g["tokens"]
    assert counters == g["counters"] and counters["suffix_dispatches"] > 0
    assert counters["cow_copies"] > 0


# ------------------------------------------------------ padded head dims
def test_head_dim_rules():
    assert HEAD_DIMS == (32, 64, 128, 160)
    assert [kernel_head_dim(hd) for hd in (30, 32, 64, 128, 160, 256)] == \
        [32, 32, 64, 128, 160, 256]
    for hd in (16, 31, 96, 512):
        with pytest.raises(ValueError, match="head dim"):
            kernel_head_dim(hd)
    # hd 160: ranges of at least 16384 / 160 keys, rounded up to the 64-key tile
    assert [split_len(cap, 160) for cap in (16, 2048, 4096, 8192)] == [128, 128, 256, 512]


def _pad(x, to=32):
    return torch.nn.functional.pad(x, (0, to - x.shape[-1]))


def test_padded_pool_matches_unpadded_plain():
    """Head dim 30 at the kernels' 32: every attention entry point over
    zero-filled operands with the scale 30**-0.5, cut back to 30, equals the
    plain version at 30; the int8 pool quantizes the padded rows to the
    same q and scales."""
    gen = torch.Generator().manual_seed(30)
    b, hkv, g, hd, page, pages, t_w = 3, 2, 2, 30, 4, 10, 3
    scale = hd**-0.5

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    q, kp, vp = rnd(b, hkv, g, hd), rnd(pages, page, hkv, hd), rnd(pages, page, hkv, hd)
    table = torch.tensor([[1, 2, 3], [4, 5, 0], [6, 7, 8]], dtype=torch.int32)
    pos = torch.tensor([9, 5, 11], dtype=torch.int32)
    got = ops.paged_decode_attention(_pad(q), _pad(kp), _pad(vp), pos, table, scale=scale)
    torch.testing.assert_close(got[..., :hd], ref.paged_decode_ref(q, kp, vp, pos, table),
                               rtol=1e-6, atol=1e-6)
    assert not got[..., hd:].any()
    (kq, ks), (vq, vs) = ref.kv_quant_ref(kp), ref.kv_quant_ref(vp)
    (kq32, ks32), (vq32, vs32) = ref.kv_quant_ref(_pad(kp)), ref.kv_quant_ref(_pad(vp))
    assert torch.equal(kq32[..., :hd], kq) and torch.equal(ks32, ks) and not kq32[..., hd:].any()
    torch.testing.assert_close(
        ops.paged_decode_attention(_pad(q), kq32, vq32, pos, table, k_scale=ks32, v_scale=vs32,
                                   scale=scale)[..., :hd],
        ref.paged_decode_int8_ref(q, kq, vq, ks, vs, pos, table), rtol=1e-6, atol=1e-6)
    rings = ref.gather_pages_ref(kp, table), ref.gather_pages_ref(vp, table)
    for paged in (True, False):
        torch.testing.assert_close(
            ops.swa_decode_attention(_pad(q), *map(_pad, rings), pos, 5, paged=paged,
                                     scale=scale)[..., :hd],
            ref.swa_decode_ref(q, *rings, pos, 5), rtol=1e-6, atol=1e-6)
    s = 7
    qs, ks_, vs_ = rnd(b, s, hkv, g, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    torch.testing.assert_close(
        ops.flash_prefill_attention(_pad(qs), _pad(ks_), _pad(vs_), window=4,
                                    scale=scale)[..., :hd],
        ref.flash_prefill_ref(qs, ks_, vs_, window=4), rtol=1e-6, atol=1e-6)
    starts = torch.tensor([0, 5, 9], dtype=torch.int32)
    torch.testing.assert_close(
        ops.suffix_prefill_attention(_pad(qs), _pad(ks_), _pad(vs_), _pad(kp), _pad(vp), table,
                                     starts, prefix_width=3, scale=scale)[..., :hd],
        ref.suffix_prefill_ref(qs, ks_, vs_, kp, vp, table, starts, prefix_width=3),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv_dtype,row", [("fp", 32 * 2), ("int8", 32 + 4)])
def test_padded_engine_reports_the_padded_pool(kv_dtype, row):
    cfg = get_smoke_config("phi4-mini-3.8b")
    model = build_model(cfg)
    eng = port_engine.ServeEngine(model, model.init(torch.Generator().manual_seed(0), "cpu"),
                                  device="cpu", num_slots=2, max_seq=16, paged_cache=True,
                                  page_size=4, kv_dtype=kv_dtype)
    assert eng.cache["k"].shape[-1] == 32
    assert eng.pool_stats["kv_bytes_per_token"] == cfg.n_layers * cfg.n_kv_heads * 2 * row


def test_serve_cli_takes_every_registered_arch(capsys):
    from repro_torch.launch.serve import main

    for arch in ARCH_IDS:
        res = main(["--arch", arch, "--device", "cpu", "--batch", "1", "--gen", "2",
                    "--prompt-len", "4"])
        assert res["arch"] == f"{arch}-smoke" and len(res["generated"][0]) == 2
    with pytest.raises(SystemExit):
        main(["--arch", "gpt-2", "--device", "cpu"])
    capsys.readouterr()


if __name__ == "__main__":
    for arch, path in GOLDEN.items():
        path.write_text(json.dumps(make_golden(arch), indent=1) + "\n")
        print(f"wrote {path}")
