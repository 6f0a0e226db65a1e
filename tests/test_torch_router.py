"""The port's fault-tolerant multi-replica router (``launch/router.py``)
against the reference's, mirroring ``tests/test_router.py``.

The contract is the reference's: where a request runs (which replica,
before or after a migration) is invisible in its tokens. Under injected
kill, stall and slow faults the router completes every request with the
tokens of a fault-free engine (greedy and sampled), and reports what
happened through ``router_stats`` instead of raising. Those cases run the
port alone, fault-free engine against faulted router, as the reference's
own tests do; sampled streams are the port's own (torch cannot replay the
reference's keys), so the sampled ones compare port with port, and a
planted fault (an export that drops the sampling stream) must show.

Port against reference: both routers run the same traces on the same
bridged float32 smoke weights, on a virtual clock that the driver advances
once per router round, submitting each request at its arrival. Tokens,
finish reasons, shed records, the router's counters, the replicas'
preemptions, swap counts and slot histories must be equal. The golden file
the card replays comes from the reference here
(``src/repro_torch/testdata/golden_stablelm_smoke_router.json``; rewrite
it with ``PYTHONPATH=src:. python tests/test_torch_router.py``)."""
import dataclasses
import json
import pathlib
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import engine as ref_engine
from repro.launch import router as ref_router
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch import router as port_router
from repro_torch.launch.engine import AdmissionError, Request, ServeEngine
from repro_torch.launch.router import FaultPlan, ReplicaFault, ServeRouter, parse_fault_spec
from repro_torch.launch.sampling import SamplingParams
from repro_torch.models.model import build_model
from tests._hypothesis_compat import given, settings, st

ARCH = "stablelm-1.6b"
P, G = 8, 6  # default prompt / generated tokens
PS = 4       # page size used throughout
ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "testdata" / "golden_stablelm_smoke_router.json"
ROUTER_COUNTERS = ("migrations", "migrated_requests", "affinity_routed", "balance_routed",
                   "retries", "forced_placements", "preemptions", "timeouts", "shed_requests",
                   "replica_requests", "replica_steps", "healthy")
POOL_COUNTERS = ("preemptions", "swapped_out_pages", "swapped_in_pages", "prefix_hit_pages",
                 "cow_copies", "prefill_tokens")
ENGINE_KW = dict(paged_cache=True, page_size=PS, prefix_cache=True, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and in a loaded
    run (a worker per core) an OpenMP region stalls on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(ref_smoke_config(ARCH), dtype="float32"))


@pytest.fixture(scope="module")
def parts():
    cfg, _ = _cfgs()
    return cfg, build_model(cfg), params_from_numpy(numpy_params(cfg, 0), cfg, "cpu")


def _ref_parts(seed=0):
    cfg, ref_cfg = _cfgs()
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    numpy_params(cfg, seed))
    return ref_build_model(ref_cfg), params


def _router(parts, **kw):
    _, model, params = parts
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    kw.setdefault("replicas", 2)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", P + G)
    return ServeRouter(model, params, device="cpu", **kw)


def _engine(parts, **kw):
    _, model, params = parts
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", P + G)
    return ServeEngine(model, params, device="cpu", **kw)


def _reqs(lens, *, gen=G, uid0=0, seed=0, sampled=False):
    """Row j of a (len(lens), max(lens)) numpy draw, cut to lens[j]."""
    rows = np.random.default_rng(seed).integers(1, 512, (len(lens), max(lens)), dtype=np.int32)
    reqs = [Request(uid=uid0 + j, prompt=rows[j, :n], max_new_tokens=gen)
            for j, n in enumerate(lens)]
    if sampled:
        for r in reqs:
            r.sampling = SamplingParams(temperature=0.9, top_p=0.95, seed=100 + r.uid)
    return reqs


def _assert_same_tokens(a, b):
    ref = {o.uid: o.tokens for o in b}
    assert len(a) == len(b)
    for o in a:
        assert o.tokens == ref[o.uid], f"uid {o.uid}: {o.tokens} != {ref[o.uid]}"


LENS = [P, P, 7, P, 6]


@pytest.fixture(scope="module")
def fault_free(parts):
    """A single fault-free engine's outputs for the shared 5-request trace:
    what every failover case is held to."""
    return {"greedy": _engine(parts).run(_reqs(LENS)),
            "sampled": _engine(parts).run(_reqs(LENS, sampled=True))}


# ------------------------------------------------------- failover identity
def test_kill_mid_decode_token_identical_greedy(parts, fault_free):
    r = _router(parts, fault_plan=FaultPlan(kill={0: 3}))
    outs = r.run(_reqs(LENS))
    _assert_same_tokens(outs, fault_free["greedy"])
    rs = r.router_stats
    assert rs["healthy"] == [False, True]
    assert "killed" in rs["fail_reasons"][0]
    assert rs["migrations"] == 1 and rs["migrated_requests"] > 0
    assert not r.shed_errors


def test_kill_mid_decode_token_identical_sampled(parts, fault_free):
    """The request's stream rides the resume record: migration neither
    replays nor skips a draw."""
    r = _router(parts, fault_plan=FaultPlan(kill={0: 3}))
    outs = r.run(_reqs(LENS, sampled=True))
    _assert_same_tokens(outs, fault_free["sampled"])
    assert r.router_stats["migrated_requests"] > 0


@pytest.mark.parametrize("fault", ["drop", "restart"])
def test_planted_fault_export_without_the_stream_changes_sampled_tokens(
        parts, fault_free, monkeypatch, fault):
    """Planted fault: an export whose records drop the sampling stream
    (``drop``: the importer decodes without it) or restart it from its seed
    (``restart``: draws replayed) must make the migrated sampled requests'
    tokens differ from the fault-free run."""
    export = port_engine.ServeEngine.export_inflight

    def faulty(self):
        items = export(self)
        for req, resume in items:
            if resume is not None:
                resume.rng = None if fault == "drop" else self._request_rng(req)
        return items

    monkeypatch.setattr(port_engine.ServeEngine, "export_inflight", faulty)
    r = _router(parts, fault_plan=FaultPlan(kill={0: 3}))
    outs = {o.uid: o.tokens for o in r.run(_reqs(LENS, sampled=True))}
    ref = {o.uid: o.tokens for o in fault_free["sampled"]}
    assert r.router_stats["migrated_requests"] > 0
    assert any(outs[u] != ref[u] for u in ref), "the planted fault went unnoticed"


def test_stall_detected_by_progress_tracking(parts, fault_free):
    """A stalled replica raises nothing: the router notices its frozen
    state within ``stall_patience`` rounds and migrates."""
    r = _router(parts, fault_plan=FaultPlan(stall={1: 2}), stall_patience=3)
    outs = r.run(_reqs(LENS))
    _assert_same_tokens(outs, fault_free["greedy"])
    rs = r.router_stats
    assert rs["healthy"] == [True, False]
    assert "stalled" in rs["fail_reasons"][1]
    assert rs["migrated_requests"] > 0


def test_stall_with_host_tiers_carries_pages(parts, fault_free):
    """Replicas with host tiers: the stalled replica's live slots leave with
    their pages, the survivor swaps them in (no re-prefill of their
    history), and the tokens are still the fault-free run's."""
    r = _router(parts, fault_plan=FaultPlan(stall={1: 2}), host_pages=32)
    outs = r.run(_reqs(LENS))
    _assert_same_tokens(outs, fault_free["greedy"])
    ps = r.engines[0].pool_stats
    assert r.router_stats["migrated_requests"] > 0
    assert ps["swapped_in_pages"] > ps["swapped_out_pages"]  # carried pages came in


def test_slow_replica_survives(parts, fault_free):
    r = _router(parts, fault_plan=FaultPlan(slow={1: (1, 0.001)}))
    outs = r.run(_reqs(LENS))
    _assert_same_tokens(outs, fault_free["greedy"])
    rs = r.router_stats
    assert rs["healthy"] == [True, True]
    assert rs["migrations"] == 0


def test_kill_with_queued_requests_migrates_queue(parts):
    """More requests than the dead replica's slots: its queue migrates too,
    in order, and everything completes."""
    lens = [P, P, 7, 6, P, 5, 7, P]
    ref = _engine(parts, num_slots=4).run(_reqs(lens))
    r = _router(parts, num_slots=2, fault_plan=FaultPlan(kill={0: 2}))
    outs = r.run(_reqs(lens))
    _assert_same_tokens(outs, ref)
    assert len(outs) == len(lens) and not r.shed_errors


# ------------------------------------------------------------ routing policy
def test_prefix_affinity_routes_to_warm_replica(parts):
    r = _router(parts)
    warm = _reqs([P])
    r.run(warm)
    assert r.replica_requests == [1, 0]
    assert r.engines[0].prefix_probe(warm[0].prompt) == (P // PS) * PS
    r.run(_reqs([P], uid0=1))  # the same prompt: replica 0 again
    assert r.replica_requests == [2, 0]
    assert r.router_stats["affinity_routed"] == 1


def test_migrated_prefix_hit_request_token_identical(parts):
    """A request riding replica 0's warm prefix index is mid-decode when
    replica 0 dies; it finishes on replica 1, whose index never saw the
    prefix, with the same tokens."""
    warm = _reqs([P])
    burst = [Request(uid=1, prompt=warm[0].prompt.copy(), max_new_tokens=G),
             *_reqs([7, 6], uid0=2, seed=1)]
    base = _engine(parts)
    ref = base.run(warm) + base.run(burst)
    r = _router(parts)
    outs = r.run(warm)
    r.fault_plan = FaultPlan(kill={0: r.router_stats["replica_steps"][0] + 2})
    outs += [o for o in r.run(burst) if o.uid != warm[0].uid]
    _assert_same_tokens(outs, ref)
    rs = r.router_stats
    assert rs["healthy"] == [False, True]
    assert rs["affinity_routed"] >= 1 and rs["migrated_requests"] > 0


def test_occupancy_balance_spreads_load(parts):
    r = _router(parts, prefix_cache=False)
    r.run(_reqs([P, 7, 6, 5]))
    assert all(n > 0 for n in r.replica_requests), r.replica_requests
    assert r.router_stats["balance_routed"] == 4


def test_backpressure_bounded_retry_then_completion(parts):
    lens = [P, P, 7, 6, P, 5]
    ref = _engine(parts, num_slots=4).run(_reqs(lens))
    r = _router(parts, num_slots=1, max_queue=1, max_retries=4)
    outs = r.run(_reqs(lens))
    _assert_same_tokens(outs, ref)
    assert r.retries > 0
    assert not r.shed_errors


# --------------------------------------------------------------- SLO / sheds
def test_deadline_shed_under_saturation(parts):
    """Saturated replicas and an expiring deadline: the queued request is
    shed with a ``deadline_exceeded`` record; the others finish with the
    fault-free tokens. Virtual clock: one tick per router round."""
    lens = [P, P, 6]
    ref = _engine(parts).run(_reqs(lens))
    clock = {"t": 0.0}
    r = _router(parts, num_slots=1, time_fn=lambda: clock["t"])
    reqs = _reqs(lens)
    doomed = Request(uid=99, prompt=reqs[0].prompt.copy(), max_new_tokens=G, deadline_s=2.0)
    for q in [*reqs, doomed]:
        r.submit(q)
    while r.has_work:
        r.step()
        clock["t"] += 1.0
    shed = r.shed_errors
    assert [e.uid for e in shed] == [99]
    assert shed[0].reason == "deadline_exceeded"
    assert r.router_stats["shed_requests"] == 1
    _assert_same_tokens(r.finished, ref)


def test_exceeds_pool_checks_every_replica_best_fit(parts):
    _, model, params = parts
    small = ServeEngine(model, params, num_slots=1, max_seq=10, device="cpu")
    big = ServeEngine(model, params, num_slots=1, max_seq=P + G, device="cpu")
    r = ServeRouter(engines=[small, big])
    fits_big = _reqs([P])            # needs 14: small is 4 short
    outs = r.run(fits_big)
    assert len(outs) == 1 and r.replica_requests == [0, 1]
    with pytest.raises(AdmissionError) as ei:
        r.submit(Request(uid=7, prompt=fits_big[0].prompt.copy(), max_new_tokens=12))
    assert ei.value.reason == "exceeds_pool"
    assert "replica 1" in str(ei.value) and "6 tokens" in str(ei.value)


def test_all_capable_replicas_dead_sheds_structured(parts):
    _, model, params = parts
    small = ServeEngine(model, params, num_slots=1, max_seq=10, device="cpu")
    big = ServeEngine(model, params, num_slots=1, max_seq=P + G, device="cpu")
    r = ServeRouter(engines=[big, small], fault_plan=FaultPlan(kill={0: 1}))
    outs = r.run(_reqs([4], gen=4) + _reqs([P], uid0=1, seed=1))
    assert [o.uid for o in outs] == [0]
    assert [e.uid for e in r.shed_errors] == [1]
    assert r.shed_errors[0].reason == "no_healthy_replica"


# ----------------------------------------------------------- chaos property
@given(chaos=st.integers(min_value=0, max_value=10**6))
@settings(max_examples=4, deadline=None)
def test_property_random_faults_token_identical(parts, fault_free, chaos):
    """A random kill or stall of a random replica at a random early step
    never changes a token against the fault-free engine and never drops a
    request; a fault that engaged was detected."""
    rng = random.Random(chaos)
    kind = rng.choice(["kill", "stall"])
    rid = rng.randrange(2)
    step = rng.randrange(1, 7)
    plan = FaultPlan(kill={rid: step}) if kind == "kill" else FaultPlan(stall={rid: step})
    r = _router(parts, fault_plan=plan)
    outs = r.run(_reqs(LENS))
    assert not r.shed_errors, f"{kind}@{rid}:{step} shed requests"
    _assert_same_tokens(outs, fault_free["greedy"])
    engaged = r.router_stats["replica_steps"][rid] > step
    assert r.router_stats["healthy"][rid] is (not engaged)


# ----------------------------------------------------------------- plumbing
def test_parse_fault_spec_grammar():
    plan = parse_fault_spec(["kill:1@8", "stall:0@4", "slow:1@2@0.05"])
    assert plan.kill == {1: 8}
    assert plan.stall == {0: 4}
    assert plan.slow == {1: (2, 0.05)}
    assert plan.action(1, 7) == ("slow", 0.05)   # kill > stall > slow
    assert plan.action(1, 8) == ("kill", 0.0)
    assert plan.action(0, 3) is None
    for bad in ["boom:1@2", "kill:x@2", "slow:1@2", "kill:1"]:
        with pytest.raises(ValueError):
            parse_fault_spec([bad])
    f = ReplicaFault(3, "kill")
    assert f.replica == 3 and f.kind == "kill" and "replica 3" in str(f)


def test_router_stats_shape(parts):
    r = _router(parts)
    r.run(_reqs([P, 6]))
    rs = r.router_stats
    model, params = _ref_parts()
    ref = ref_router.ServeRouter(model, params, replicas=2, num_slots=2, max_seq=P + G,
                                 **ENGINE_KW)
    assert set(rs) == set(ref.router_stats)
    assert rs["replicas"] == 2
    assert len(rs["occupancy"]) == len(rs["queued"]) == 2
    assert rs["migrations"] == 0 and rs["shed_requests"] == 0
    assert rs["affinity_routed"] + rs["balance_routed"] == 2


def test_replicas_share_one_set_of_weights(parts):
    """Replicas read one params dict: no leaf is copied per replica, the
    serving upcast of the unembedding included."""
    r = _router(parts, replicas=3)
    p0 = r.engines[0].params
    for e in r.engines[1:]:
        assert e.params["embed"]["unembed"] is p0["embed"]["unembed"]
        assert e.params["layers"] is p0["layers"]
        assert e.params["embed"]["tok"] is p0["embed"]["tok"]


def test_router_warm_restarts_every_clock_at_one_instant(parts):
    clock = {"t": 5.0}
    r = _router(parts, time_fn=lambda: clock["t"])
    clock["t"] = 9.0
    r.warm([P], gen_tokens=1)
    assert r._now() == 0.0 and all(e._now() == 0.0 for e in r.engines)
    assert all(not e.finished and e.steps == 0 for e in r.engines)


def test_router_module_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.launch.router\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "HOME": str(pathlib.Path.home()), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, cwd=ROOT)


# ------------------------------------------------------------ CLI on the CPU
def test_serve_cli_router_kill_on_cpu(capsys):
    from repro_torch.launch.serve import main

    res = main(["--continuous", "--device", "cpu", "--replicas", "2", "--fault", "kill:1@4",
                "--requests", "6", "--gen", "6", "--prompt-len", "8", "--slots", "2"])
    assert res["completed"] == 6 and all(len(t) == 6 for t in res["generated"])
    assert res["router"]["migrations"] == 1 and res["router"]["healthy"] == [True, False]
    assert not res["shed"]
    assert "1 migrations" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--replicas", "2"], "--replicas requires --continuous"),
    (["--continuous", "--fault", "kill:1@4"], "--fault requires --replicas"),
    (["--continuous", "--replicas", "2", "--kv-dtype", "int8"], "int8 replica pools"),
    (["--continuous", "--replicas", "2", "--host-pages", "8"], "per-replica host tiers"),
    (["--continuous", "--replicas", "2", "--draft", "stablelm-1.6b", "--spec-tokens", "2"],
     "do not build draft models"),
    (["--continuous", "--prefix-cache", "--window", "4"], "--prefix-cache cannot be honored"),
    (["--continuous", "--prefix-cache", "--prefill", "interleaved"], "suffix rounds"),
    (["--prefix-cache"], "batch mode"),
])
def test_serve_cli_refuses_what_it_cannot_honour(argv, match, capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--device", "cpu", *argv])
    assert match in capsys.readouterr().err


# ------------------------------------------------- against the reference
def _drive(router, requests, clock):
    """Submit each request once the virtual clock reaches its arrival, run
    one router round, advance the clock by one; until all is done."""
    todo = sorted(requests, key=lambda q: q.arrival_time)
    while todo or router.has_work:
        while todo and todo[0].arrival_time <= clock[0]:
            router.submit(todo.pop(0))
        router.step()
        clock[0] += 1.0


def _summary(router) -> dict:
    """What the port and the reference must agree on after a run."""
    rs = router.router_stats
    outs = sorted(router.finished, key=lambda o: o.uid)
    return {
        "tokens": [[o.uid, [int(t) for t in o.tokens]] for o in outs],
        "finish_reasons": [[o.uid, o.finish_reason] for o in outs],
        "shed": [[e.uid, e.reason] for e in router.shed_errors],
        "counters": {k: rs[k] for k in ROUTER_COUNTERS},
        "pool": [{k: e.pool_stats[k] for k in POOL_COUNTERS} for e in router.engines],
        "slot_history": [sorted([int(u), list(v)] for u, v in e.slot_history.items())
                         for e in router.engines],
    }


def _requests(mod, specs):
    return [mod.Request(uid=q["uid"], prompt=np.asarray(q["prompt"], np.int32),
                        max_new_tokens=q["max_new_tokens"], arrival_time=q["arrival_time"],
                        priority=q["priority"], deadline_s=q["deadline_s"]) for q in specs]


def golden_router_trace() -> dict:
    """The trace phase 4e replays on the card: two replicas of 2 slots over
    tight pools (8 allocatable pages of 4) with prefix sharing, requests
    arriving over 9 rounds, half of them on a shared 2-page prefix (affinity
    routing), the oldest at priority -1 (it is preempted where, at priority
    0, the youngest would be), one with a 1-round deadline that the fault's
    backlog sheds. Run once with replica 1 killed at its step 3 and no host
    tier (every migrated request re-prefills) and once with it stalled at
    step 3 and host tiers of 32 pages (live slots carry their pages)."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, 512, 2 * PS)
    spec = [  # (shares the prefix, own tokens, gen, arrival round, priority, deadline)
        (True, 3, 8, 0, -1, None), (False, 7, 8, 0, 0, None), (False, 9, 6, 1, 0, None),
        (False, 5, 8, 1, 0, None), (True, 2, 6, 4, 0, None), (True, 5, 6, 5, 0, None),
        (False, 6, 5, 6, 0, 1.0), (True, 4, 6, 7, 0, None), (False, 8, 6, 8, 0, None),
        (True, 1, 5, 9, 0, None),
    ]
    requests = []
    for u, (shared, n, gen, arrival, priority, deadline) in enumerate(spec):
        tail = rng.integers(1, 512, n)
        prompt = np.concatenate([prefix, tail]) if shared else tail
        requests.append(dict(uid=u, prompt=[int(t) for t in prompt], max_new_tokens=gen,
                             arrival_time=float(arrival), priority=priority,
                             deadline_s=deadline))
    return {
        "config": f"{ARCH} smoke, dtype float32",
        "seed": 0,
        "engine": dict(num_slots=2, max_seq=24, page_size=PS, num_pages=9, paged_cache=True,
                       prefix_cache=True, seed=0),
        "router": dict(replicas=2, stall_patience=3),
        "clock": "virtual: +1 per router round; requests submitted at their arrival",
        "requests": requests,
        "runs": [dict(name="kill, recompute", fault=["kill:1@3"], host_pages=0),
                 dict(name="stall, carried pages", fault=["stall:1@3"], host_pages=32)],
    }


def _run_golden(mod_engine, mod_router, model, params, g, run, **device):
    clock = [0.0]
    router = mod_router.ServeRouter(
        model, params, fault_plan=mod_router.parse_fault_spec(run["fault"]),
        time_fn=lambda: clock[0], host_pages=run["host_pages"], **g["router"], **g["engine"],
        **device)
    _drive(router, _requests(mod_engine, g["requests"]), clock)
    return _summary(router)


def make_golden_router() -> dict:
    """Run the reference router on ``golden_router_trace()``; add what it
    gave."""
    g = golden_router_trace()
    model, params = _ref_parts(g["seed"])
    for run in g["runs"]:
        run.update(_run_golden(ref_engine, ref_router, model, params, g, run))
    return g


@pytest.fixture(scope="module")
def golden_from_reference():
    return make_golden_router()


def test_golden_router_file_matches_reference(golden_from_reference):
    assert json.loads(GOLDEN.read_text()) == golden_from_reference


def test_golden_router_trace_exercises_the_lifecycle():
    """The file's trace does what phase 4e claims: both faults migrate, the
    kill run re-prefills and the stall run swaps carried pages in, a
    deadline sheds, affinity routing and backpressure happen, and the
    priority pair makes the oldest request the one preempted."""
    g = json.loads(GOLDEN.read_text())
    kill, stall = g["runs"]
    for run in (kill, stall):
        c = run["counters"]
        assert c["migrations"] == 1 and c["migrated_requests"] > 0
        assert c["preemptions"] > 0 and c["affinity_routed"] > 0
        assert [s[1] for s in run["shed"]] == ["deadline_exceeded"]
        assert len(run["tokens"]) + len(run["shed"]) == len(g["requests"])
    assert kill["counters"]["retries"] > 0
    assert all(p["swapped_in_pages"] == 0 for p in kill["pool"])
    assert stall["pool"][0]["swapped_in_pages"] > stall["pool"][0]["swapped_out_pages"]
    oldest = dict(stall["slot_history"][0])[0]
    assert len(oldest) > 1, "the priority -1 request was never preempted"


@pytest.mark.parametrize("run", [0, 1])
def test_port_replays_golden_router_on_cpu(parts, run):
    """What chip_smoke.py's phase 4e does on the card, on the CPU."""
    g = json.loads(GOLDEN.read_text())
    _, model, params = parts
    want = {k: v for k, v in g["runs"][run].items()
            if k not in ("name", "fault", "host_pages")}
    got = _run_golden(port_engine, port_router, model, params, g, g["runs"][run], device="cpu")
    assert got == want


def test_priorities_change_the_golden_victim(parts):
    """Control for the golden trace: at priority 0 everywhere the victim is
    another request (the youngest), so the file's preemption pattern is the
    priority's doing."""
    g = golden_router_trace()
    for q in g["requests"]:
        q["priority"] = 0
    _, model, params = parts
    got = _run_golden(port_engine, port_router, model, params, g, g["runs"][1], device="cpu")
    hist = dict(got["slot_history"][0])
    assert len(hist[0]) == 1
    assert got["counters"]["preemptions"] > 0


def _slow_backpressure_watchdog() -> dict:
    """A second trace for port-against-reference: 1-slot replicas with a
    queue cap of 1 (backpressure and forced placements), replica 1 slowed
    from its step 1, and a 6-round watchdog that times out the longest
    requests."""
    rng = np.random.default_rng(5)
    requests = [dict(uid=u, prompt=[int(t) for t in rng.integers(1, 512, n)],
                     max_new_tokens=gen, arrival_time=float(a), priority=0, deadline_s=None)
                for u, (n, gen, a) in enumerate([(8, 9, 0), (7, 4, 0), (6, 5, 0), (5, 4, 1),
                                                 (8, 8, 1), (4, 3, 2), (7, 6, 2)])]
    return {
        "engine": dict(num_slots=1, max_seq=20, page_size=PS, paged_cache=True,
                       prefix_cache=True, seed=0, max_wall_s=6.0),
        "router": dict(replicas=2, max_queue=1, max_retries=2, backoff_s=0.0),
        "requests": requests,
        "runs": [dict(fault=["slow:1@1@0.0001"], host_pages=0)],
    }


def test_slow_backpressure_and_watchdog_match_reference(parts):
    g = _slow_backpressure_watchdog()
    model, params = _ref_parts(0)
    want = _run_golden(ref_engine, ref_router, model, params, g, g["runs"][0])
    _, pm, pp = parts
    got = _run_golden(port_engine, port_router, pm, pp, g, g["runs"][0], device="cpu")
    assert got == want
    c = got["counters"]
    assert c["retries"] > 0 and c["forced_placements"] > 0 and c["timeouts"] > 0
    assert c["healthy"] == [True, True] and c["migrations"] == 0
    assert "timeout" in {r for _, r in got["finish_reasons"]}


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(make_golden_router(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
