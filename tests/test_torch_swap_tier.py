"""The port's host tier (``HostTier``, swap-in resume, prefix demote and
promote) against the reference, mirroring ``tests/test_swap_tier.py``.

The contract is the reference's: the tier is a pure performance layer.
Swap-resume restores the pages a preempted slot held bit for bit, so every
trace is token-identical to the ample-pool run and to the re-prefill resume,
and a tier that is too small or that dropped an entry falls back to the
re-prefill. What the tier buys shows only in the counters: a swap-resume
adds no prefill tokens. Each engine trace runs the port and the reference
engine on the same bridged float32 smoke weights and holds tokens and
counters equal (at float32 the two packages' logits agree to ~1e-6, far
inside the top-two gaps of these traces).

Also here: the golden file of the int8 + host-tier trace the card replays
(``src/repro_torch/testdata/golden_stablelm_smoke_int8_swap.json``; rewrite
it with ``PYTHONPATH=src:. python tests/test_torch_swap_tier.py``)."""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import engine as ref_engine
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch.engine import HostTier
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
P, G = 8, 6
GOLDEN = (pathlib.Path(__file__).resolve().parents[1]
          / "src" / "repro_torch" / "testdata" / "golden_stablelm_smoke_int8_swap.json")
COUNTERS = ("preemptions", "swapped_out_pages", "swapped_in_pages", "host_demoted_pages",
            "host_promote_hits", "prefill_tokens", "cow_copies", "prefix_hit_pages",
            "suffix_dispatches", "cold_dispatches")


# --------------------------------------------------------- HostTier (unit)
def _arrays(n):
    return {"k": torch.ones((2, n, 3), dtype=torch.int8)}


def test_host_tier_capacity_must_be_positive():
    with pytest.raises(ValueError, match="capacity"):
        HostTier(0)


def test_host_tier_put_get_pop_accounting():
    host = HostTier(4)
    assert host.put(("swap", 1), _arrays(2), 2)
    assert host.pages == 2 and host.n_pages(("swap", 1)) == 2
    got = host.get(("swap", 1))
    assert got is not None and got["k"].shape[1] == 2
    assert host.get(("swap", 9)) is None
    popped = host.pop(("swap", 1))
    assert popped is not None and popped["k"].shape[1] == 2
    assert host.pages == 0 and host.n_pages(("swap", 1)) == 0
    assert host.pop(("swap", 1)) is None


def test_host_tier_lru_eviction_order_and_touch():
    host = HostTier(4)
    host.put(("swap", 1), _arrays(2), 2)
    host.put(("swap", 2), _arrays(2), 2)
    host.get(("swap", 1))                    # touch: 2 becomes the LRU entry
    assert host.put(("swap", 3), _arrays(2), 2)
    assert host.evictions == 1
    assert host.n_pages(("swap", 2)) == 0 and host.n_pages(("swap", 1)) == 2
    assert host.pages == 4


def test_host_tier_refuses_oversized_entry_without_eviction():
    host = HostTier(4)
    host.put(("swap", 1), _arrays(3), 3)
    assert not host.put(("swap", 2), _arrays(5), 5)
    assert host.evictions == 0 and host.n_pages(("swap", 1)) == 3


def test_host_tier_reput_replaces_and_clear_empties():
    host = HostTier(4)
    host.put(("swap", 1), _arrays(3), 3)
    host.put(("swap", 1), _arrays(2), 2)
    assert host.pages == 2 and host.n_pages(("swap", 1)) == 2
    host.clear()
    assert host.pages == 0 and host.get(("swap", 1)) is None


# ------------------------------------------------------------ engine layer
def _f32_configs():
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(ref_smoke_config(ARCH), dtype="float32"))


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed + 1)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _port(**kw):
    cfg, _ = _f32_configs()
    kw = {"num_slots": 2, "max_seq": P + G, "page_size": 4, "paged_cache": True, **kw}
    return port_engine.ServeEngine(
        build_model(cfg), params_from_numpy(numpy_params(cfg, 0), cfg, "cpu"), device="cpu",
        **kw)


def _ref(**kw):
    _, ref_cfg = _f32_configs()
    cfg, _ = _f32_configs()
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), numpy_params(cfg, 0))
    kw = {"num_slots": 2, "max_seq": P + G, "page_size": 4, "paged_cache": True, **kw}
    return ref_engine.ServeEngine(ref_build_model(ref_cfg), params, **kw)


def _run(eng, prompts, gen=G, mod=port_engine, uid0=0):
    return eng.run([mod.Request(uid=uid0 + u, prompt=p, max_new_tokens=gen)
                    for u, p in enumerate(prompts)])


def _tokens(outs):
    return {o.uid: o.tokens for o in outs}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_swap_resume_token_identical_and_prefill_free(kv_dtype):
    """A tight pool preempts; the swap engine resumes from the host tier and
    emits the ample-pool run's tokens, with prefill_tokens at the
    no-preemption minimum where the re-prefill resume pays again; the
    reference engine shows the same tokens and counters."""
    lens = [P, P, 7]
    prompts = _prompts(lens)
    ample = _port(kv_dtype=kv_dtype)
    want = _tokens(_run(ample, prompts))
    assert ample.preemptions == 0
    recompute = _port(kv_dtype=kv_dtype, num_pages=6)
    swap = _port(kv_dtype=kv_dtype, num_pages=6, host_pages=16)
    assert _tokens(_run(recompute, prompts)) == want
    assert _tokens(_run(swap, prompts)) == want
    sw, rc = swap.pool_stats, recompute.pool_stats
    assert swap.preemptions > 0 and recompute.preemptions > 0
    assert sw["prefill_tokens"] == sum(lens) < rc["prefill_tokens"]
    assert sw["swapped_in_pages"] == sw["swapped_out_pages"] > 0
    assert rc["swapped_out_pages"] == 0
    assert swap.host.pages == 0 and sw["host_tier_pages"] == 0   # the tier drained
    assert sw["swap_enabled"] and not rc["swap_enabled"] and sw["host_capacity_pages"] == 16
    assert swap.pool.in_use == 0
    ref = _ref(kv_dtype=kv_dtype, num_pages=6, host_pages=16)
    assert _tokens(_run(ref, prompts, mod=ref_engine)) == want
    for key in COUNTERS:
        assert sw[key] == ref.pool_stats[key], key


def test_swap_disabled_keeps_the_tier_for_prefix_pages_only():
    swap = _port(num_pages=6, host_pages=16, swap=False)
    _run(swap, _prompts([P, P, 7]))
    assert swap.preemptions > 0 and swap.swapped_out_pages == 0
    assert not swap.pool_stats["swap_enabled"]


def test_host_tier_too_small_falls_back_to_recompute():
    lens = [P, P, 7]
    want = _tokens(_run(_port(), _prompts(lens)))
    swap = _port(num_pages=6, host_pages=1)
    assert _tokens(_run(swap, _prompts(lens))) == want
    assert swap.preemptions > 0
    assert swap.swapped_out_pages == 0 and swap.swapped_in_pages == 0   # every victim > 1 page


def test_dropped_host_entry_falls_back_to_recompute():
    """Entries dropped while their requests queue (forced with clear(), the
    LRU worst case) resume through the re-prefill, token-identically."""
    lens = [P, P, 7]
    want = _tokens(_run(_port(), _prompts(lens)))
    swap = _port(num_pages=6, host_pages=16)
    for u, p in enumerate(_prompts(lens)):
        swap.submit(port_engine.Request(uid=u, prompt=p, max_new_tokens=G))
    outs = []
    while swap.has_work:
        outs.extend(swap.step())
        if swap.swapped_out_pages > 0 and swap.host.pages > 0:
            swap.host.clear()
    assert swap.swapped_out_pages > 0
    assert swap.swapped_in_pages < swap.swapped_out_pages
    assert _tokens(outs) == want
    assert not swap._resume and swap.pool.in_use == 0


def test_swap_entry_pushed_out_by_its_own_eviction_falls_back_to_recompute():
    """A tier exactly the victim's size, with the prefix cache on: at
    swap-in the pool is short, evicting a retired prompt's prefix pages
    demotes them into the tier, and that pushes the swap entry out. The
    resume falls back to the re-prefill, token-identically. (The reference
    engine restores from the missing entry here and raises: ROADMAP
    Queue 3.)"""
    prompts = _prompts([P] * 4, seed=1)
    gens = [2, G, G, G]          # the oldest slot retires right after the preemption

    def run(**kw):
        eng = _port(num_slots=4, prefix_cache=True, **kw)
        outs = eng.run([port_engine.Request(uid=u, prompt=p, max_new_tokens=g)
                        for u, (p, g) in enumerate(zip(prompts, gens))])
        return eng, _tokens(outs)

    _, want = run()
    eng, got = run(num_pages=10, host_pages=2)
    assert got == want
    assert eng.preemptions > 0 and eng.host.evictions > 0 and eng.host_demoted_pages > 0
    assert eng.swapped_in_pages < eng.swapped_out_pages
    assert not eng._resume and all(k[0] == "prefix" for k in eng.host.keys())


def test_prefix_demote_promote_round_trip():
    """A tight pool evicts a retired prompt's prefix pages, which are
    demoted to the host tier; a later run of that prompt promotes both back
    and is served as a prefix hit, token-identically to its first run; the
    reference's engine counts the same."""
    kw = dict(max_seq=16, num_slots=1, num_pages=5, prefix_cache=True, host_pages=8)
    a, b = _prompts([8], seed=0)[0], _prompts([4], seed=7)[0]
    outs = {}
    for name, eng, mod in (("port", _port(**kw), port_engine),
                           ("ref", _ref(**kw), ref_engine)):
        first = _run(eng, [a], gen=4, mod=mod)
        _run(eng, [b], gen=12, mod=mod, uid0=1)    # b's pages fill the pool: a's demote
        assert eng.host_demoted_pages >= 2 and eng.host.pages > 0
        again = _run(eng, [a], gen=4, mod=mod, uid0=10)
        assert eng.host_promote_hits == 2 and eng.prefix_hit_pages >= 2
        assert again[0].tokens == first[0].tokens
        outs[name] = (first[0].tokens, {k: eng.pool_stats[k] for k in COUNTERS})
    assert outs["port"] == outs["ref"]


def test_clear_does_not_demote_and_warm_clears_the_tier():
    eng = _port(num_pages=8, prefix_cache=True, host_pages=8)
    _run(eng, _prompts([P]))
    assert eng.prefix.size > 0
    eng.prefix.clear()
    assert eng.host_demoted_pages == 0 and eng.host.pages == 0
    eng.host.put(("swap", 99), _arrays(1), 1)
    eng.warm([4], gen_tokens=2)
    assert eng.host.pages == 0 and eng.swapped_out_pages == 0


def test_engine_rejects_bad_kv_settings():
    with pytest.raises(ValueError, match="kv_dtype"):
        _port(kv_dtype="int4")
    with pytest.raises(ValueError, match="host_pages"):
        _port(host_pages=-1)


def test_serve_cli_int8_host_tier_on_cpu(capsys):
    from repro_torch.launch.serve import main

    res = main(["--continuous", "--device", "cpu", "--requests", "3", "--gen", "6",
                "--prompt-len", "8", "--slots", "2", "--page-size", "4", "--num-pages", "6",
                "--kv-dtype", "int8", "--host-pages", "16"])
    assert res["kv_dtype"] == "int8" and res["host_pages"] == 16
    assert all(len(t) == 6 for t in res["generated"])
    pool = res["pool"]
    assert pool["kv_dtype"] == "int8" and pool["preemptions"] > 0
    assert pool["swapped_in_pages"] == pool["swapped_out_pages"] > 0
    assert "int8 pages, host tier" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--continuous", "--device", "cpu", "--host-pages", "-1"])
    with pytest.raises(SystemExit):
        main(["--continuous", "--device", "cpu", "--kv-dtype", "int4"])
    with pytest.raises(SystemExit):
        main(["--continuous", "--device", "cpu", "--no-swap"])


def test_serve_cli_no_swap_keeps_the_tier_for_prefix_pages_only():
    from repro_torch.launch.serve import main

    res = main(["--continuous", "--device", "cpu", "--requests", "3", "--gen", "6",
                "--prompt-len", "8", "--slots", "2", "--page-size", "4", "--num-pages", "6",
                "--kv-dtype", "int8", "--host-pages", "16", "--no-swap"])
    pool = res["pool"]
    assert pool["preemptions"] > 0 and not pool["swap_enabled"]
    assert pool["swapped_out_pages"] == pool["swapped_in_pages"] == 0


# ------------------------------------------------------------- golden
def _golden_prompts(seed=3, page=4):
    """Three cold prompts, three that share a 3-page prefix, and the prefix
    alone (a fully cached prompt: copy-on-write)."""
    rng = np.random.default_rng(seed)
    common = rng.integers(1, 512, 3 * page)
    cold = [rng.integers(1, 512, n) for n in (5, 9, 13)]
    shared = [np.concatenate([common, rng.integers(1, 512, k)]) for k in (0, 3, 6)]
    return cold + shared + [common.copy()]


def golden_trace() -> dict:
    """The int8 + host-tier trace the card replays: a pool of 8 allocatable
    pages under 3 slots preempts (and swaps), evicts prefix pages (and
    demotes them), and later prompts promote them back; every counter of
    ``COUNTERS`` is > 0 on it."""
    return {
        "config": f"{ARCH} smoke, dtype float32",
        "seed": 0,
        "engine": dict(num_slots=3, max_seq=32, page_size=4, prefix_cache=True,
                       kv_dtype="int8", num_pages=9, host_pages=32, paged_cache=True),
        "max_new_tokens": 6,
        "prompts": [p.tolist() for p in _golden_prompts()],
    }


def make_golden() -> dict:
    """Run the reference engine on ``golden_trace()``; add its tokens and
    counters."""
    g = golden_trace()
    ref = _ref(**g["engine"])
    outs = _run(ref, [np.asarray(p, np.int32) for p in g["prompts"]], gen=g["max_new_tokens"],
                mod=ref_engine)
    g["tokens"] = [[int(t) for t in o.tokens] for o in outs]
    g["counters"] = {k: int(ref.pool_stats[k]) for k in COUNTERS}
    return g


def test_golden_int8_swap_file_matches_reference():
    g = json.loads(GOLDEN.read_text())
    assert g == make_golden()
    assert all(v > 0 for v in g["counters"].values()), g["counters"]


def test_port_replays_golden_int8_swap_on_cpu():
    """What chip_smoke.py's int8 golden phase does on the card, on the CPU."""
    g = json.loads(GOLDEN.read_text())
    eng = _port(**g["engine"])
    outs = _run(eng, [np.asarray(p, np.int32) for p in g["prompts"]], gen=g["max_new_tokens"])
    assert [o.tokens for o in outs] == g["tokens"]
    assert {k: eng.pool_stats[k] for k in COUNTERS} == g["counters"]


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
