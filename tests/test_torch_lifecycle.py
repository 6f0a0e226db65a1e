"""The port's request lifecycle against the reference engine's: arrival
times and the arrival gate, ``time_fn``, deadline sheds, the ``max_wall_s``
watchdog, priority-ordered preemption, the read-only prefix probe, the
prefix index's page cap, long requests, and moving in-flight work between
engines (``export_inflight``/``import_inflight``, with and without carried
pages). Mirrors the reference's ``tests/test_engine.py`` (staggered
arrivals, watchdog, deadlines), ``tests/test_paged_engine.py`` (SLO-aware
preemption, export/import), ``tests/test_swap_tier.py`` (sheds and exports
release their host-tier entries), ``tests/test_spec_decode.py`` (export
carries pages, a layout mismatch recomputes) and
``tests/test_prefix_cache.py`` (``probe``).

Each case runs the reference and the port on the same bridged float32
smoke weights and the same numpy-drawn prompts, on a clock both read the
same way (the engine's own step count, or a virtual clock the driver
advances once per step), and holds tokens, finish reasons, timing stamps,
shed records and counters equal. Sampled cases compare the port with
itself (fault-free against migrated): its streams are its own."""
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
from repro.launch import engine as ref_engine
from repro.launch.prefix_cache import PrefixCache as RefPrefixCache
from repro.models import build_model as ref_build_model
from repro_torch.bridge import numpy_params, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch.engine import AdmissionError, PagePool
from repro_torch.launch.prefix_cache import PrefixCache
from repro_torch.launch.sampling import SamplingParams
from repro_torch.models.model import build_model

ARCH = "stablelm-1.6b"
P, G = 8, 6
PS = 4
COUNTERS = ("preemptions", "swapped_out_pages", "swapped_in_pages", "prefill_tokens",
            "prefix_hit_pages", "cow_copies", "host_demoted_pages", "host_promote_hits",
            "shed_requests", "timeouts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and in a loaded
    run (a worker per core) an OpenMP region stalls on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    """(reference model, params), (port model, params): one float32 draw."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config(ARCH), dtype="float32")
    tree = numpy_params(cfg, 0)
    ref = (ref_build_model(ref_cfg),
           jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree))
    return ref, (build_model(cfg), params_from_numpy(tree, cfg, "cpu"))


def _engines(both, clock=None, **kw):
    """A reference engine and a port engine with the same arguments.
    ``clock``: "steps" (each engine's own decode-step count, the
    reference tests' clock) or a one-element list the driver advances."""
    (rm, rp), (pm, pp) = both
    out = []
    for mod, model, params, extra in ((ref_engine, rm, rp, {}),
                                      (port_engine, pm, pp, {"device": "cpu"})):
        holder = {}
        if clock == "steps":
            kw["time_fn"] = lambda h=holder: float(h["e"].steps) if "e" in h else 0.0
        elif clock is not None:
            kw["time_fn"] = lambda c=clock: c[0]
        e = mod.ServeEngine(model, params, **kw, **extra)
        holder["e"] = e
        out.append(e)
    return out


def _reqs(mod, lens, *, gen=G, seed=0, uid0=0, **fields):
    """Row j of a (len(lens), max(lens)) numpy draw, cut to lens[j]; a
    field given as a list sets request j's value."""
    rows = np.random.default_rng(seed).integers(1, 512, (len(lens), max(lens)), dtype=np.int32)
    reqs = []
    for j, n in enumerate(lens):
        extra = {k: (v[j] if isinstance(v, list) else v) for k, v in fields.items()}
        reqs.append(mod.Request(uid=uid0 + j, prompt=rows[j, :n],
                                max_new_tokens=gen[j] if isinstance(gen, list) else gen,
                                **extra))
    return reqs


def _outs(outs, times: bool = False) -> list:
    """Each output's uid, tokens, finish reason, slot and arrival, and with
    ``times`` (a clock both packages read alike) its three stamps."""
    return [(o.uid, [int(t) for t in o.tokens], o.finish_reason, o.slot, o.arrival_time)
            + ((o.admit_time, o.first_token_time, o.finish_time) if times else ())
            for o in sorted(outs, key=lambda o: o.uid)]


def _state(e) -> dict:
    ps = e.pool_stats or {}
    return {
        "counters": {k: ps.get(k, getattr(e, k, None)) for k in COUNTERS},
        "shed": [(x.uid, x.reason) for x in e.shed],
        "slot_history": {int(u): list(v) for u, v in e.slot_history.items()},
        "steps": e.steps,
    }


def _assert_same(ref_e, ref_outs, port_e, port_outs, times=False):
    assert _outs(port_outs, times) == _outs(ref_outs, times)
    assert _state(port_e) == _state(ref_e)


def _run_both(both, lens, clock=None, fields=None, gen=G, **kw):
    ref, port = _engines(both, clock=clock, **kw)
    outs = [e.run(_reqs(mod, lens, gen=gen, **(fields or {})))
            for e, mod in ((ref, ref_engine), (port, port_engine))]
    _assert_same(ref, outs[0], port, outs[1], times=clock is not None)
    return port, outs[1]


# ------------------------------------------------------ arrivals and clocks
@pytest.mark.parametrize("prefill", ["chunked", "interleaved"])
def test_staggered_arrivals_match_reference(both, prefill):
    """5 requests with staggered arrivals through 2 ring slots (the
    reference's ``test_staggered_arrivals_match_oracle``): outputs carry
    their arrival times, and latency and TTFT count from them."""
    port, outs = _run_both(both, [P] * 5, clock="steps", num_slots=2, max_seq=P + G,
                           prefill=prefill, fields=dict(arrival_time=[0.0, 0.0, 0.1, 0.2, 0.5]))
    assert [o.uid for o in outs] == list(range(5))
    for o in outs:
        assert o.finish_reason == "length" and len(o.tokens) == G
        assert o.latency == o.finish_time - o.arrival_time
        assert o.ttft == o.first_token_time - o.arrival_time


@pytest.mark.parametrize("paged_cache", [False, True])
def test_respect_arrivals_on_a_virtual_clock(both, paged_cache):
    """``step(respect_arrivals=True)`` admits nothing before its arrival:
    the admission, first-token and finish stamps on a virtual clock (one
    tick per step) equal the reference's."""
    clock = [0.0]
    ref, port = _engines(both, clock=clock, num_slots=2, max_seq=P + G,
                         paged_cache=paged_cache, page_size=PS)
    got = []
    for e, mod in ((ref, ref_engine), (port, port_engine)):
        clock[0] = 0.0
        e.reset_clock()
        for r in _reqs(mod, [P, 7, P, 6, 5], arrival_time=[0.0, 0.0, 3.0, 5.0, 9.0]):
            e.submit(r)
        outs = []
        while e.has_work:
            assert e.next_arrival() == min((r.arrival_time for r in e.waiting), default=None)
            outs += e.step(respect_arrivals=True)
            clock[0] += 1.0
        got.append(outs)
    _assert_same(ref, got[0], port, got[1], times=True)
    assert all(o.admit_time >= o.arrival_time for o in got[1])
    assert max(o.admit_time - o.arrival_time for o in got[1]) > 0  # one waited for a slot


def test_realtime_run_sleeps_until_arrivals(both):
    """``run(realtime=True)`` on the monotonic clock: no request is admitted
    before its arrival, and the tokens are the virtual-time run's."""
    (_, _), (pm, pp) = both
    mk = lambda: port_engine.ServeEngine(pm, pp, num_slots=2, max_seq=P + G, device="cpu")
    fast = mk().run(_reqs(port_engine, [P] * 3, arrival_time=[0.0, 0.05, 0.1]))
    eng = mk()
    eng.reset_clock()
    slow = eng.run(_reqs(port_engine, [P] * 3, arrival_time=[0.0, 0.05, 0.1]), realtime=True)
    assert [o.tokens for o in slow] == [o.tokens for o in fast]
    assert all(o.admit_time >= o.arrival_time for o in slow)


def test_make_requests_staggers_arrivals(both):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    reqs = port_engine.make_requests(cfg, n_requests=4, prompt_len=P, gen_tokens=2,
                                     stagger=0.25)
    assert [r.arrival_time for r in reqs] == [0.0, 0.25, 0.5, 0.75]
    assert all(r.priority == 0 and r.deadline_s is None for r in reqs)


# --------------------------------------------------- watchdog and deadlines
def test_watchdog_retires_stuck_slot(both):
    """``max_wall_s`` on the step clock: a slot older than the budget
    retires with a ``timeout`` output holding its partial tokens, and the
    queue behind it keeps flowing."""
    port, outs = _run_both(both, [P, P], clock="steps", num_slots=1, max_seq=P + G,
                           max_wall_s=3.0)
    assert [o.finish_reason for o in outs] == ["timeout", "timeout"]
    assert port.timeouts == 2 and not port.has_work
    assert all(0 < len(o.tokens) < G for o in outs)


def test_watchdog_timeout_publishes_no_prefix_page(both):
    """A timed-out slot's pages are freed unpublished: the prefix index
    holds none of them (a normal retirement would publish its prompt)."""
    port, outs = _run_both(both, [P, P], clock="steps", num_slots=1, max_seq=P + G,
                           max_wall_s=3.0, paged_cache=True, page_size=PS, prefix_cache=True)
    assert [o.finish_reason for o in outs] == ["timeout", "timeout"]
    assert port.prefix.size == 0 and port.pool.in_use == 0
    assert port.pool_stats["timeouts"] == 2


def test_watchdog_ample_budget_never_fires(both):
    port, outs = _run_both(both, [P] * 5, clock="steps", num_slots=2, max_seq=P + G,
                           max_wall_s=100.0)
    assert port.timeouts == 0
    assert all(o.finish_reason == "length" for o in outs)


def test_deadline_shed_structured(both):
    """A request still queued past its deadline is shed with a
    ``deadline_exceeded`` record; a decoding one never is; one without a
    deadline is served."""
    port, outs = _run_both(both, [P] * 3, clock="steps", num_slots=1, max_seq=P + G,
                           fields=dict(deadline_s=[100.0, 2.0, None]))
    assert [o.uid for o in outs] == [0, 2]
    assert port.shed_requests == 1 and [e.uid for e in port.shed] == [1]
    assert port.shed[0].reason == "deadline_exceeded"
    assert isinstance(port.shed[0], AdmissionError)
    assert port.pool_stats is None


def test_shed_queued_victim_drops_host_entry(both):
    """A mid-prefill victim (no generated tokens: not exempt) queued past its
    deadline is shed and its host-tier entry released with it."""
    ref, port = _engines(both, prefill="interleaved", max_seq=16, num_slots=2,
                         paged_cache=True, page_size=PS, num_pages=6, host_pages=16)
    got = []
    victims = []
    for e, mod in ((ref, ref_engine), (port, port_engine)):
        for r in _reqs(mod, [14, 14], gen=2):
            e.submit(r)
        victim, outs = None, []
        for _ in range(200):
            outs += e.step()
            if victim is None:
                for uid, resume in e._resume.items():
                    if not resume.generated and resume.host_key is not None:
                        victim = uid
                        for req in e.waiting:
                            if req.uid == uid:
                                req.deadline_s = 1e-9
                        break
            if not e.has_work:
                break
        got.append(outs)
        victims.append(victim)
    assert victims[0] == victims[1] is not None
    _assert_same(ref, got[0], port, got[1])
    assert port.shed_requests == 1 and port.shed[0].uid == victims[1]
    assert port.host.n_pages(("swap", victims[1])) == 0 and port.host.pages == 0
    assert victims[1] not in port._resume


# ------------------------------------------------------ priority preemption
def test_priority_overrides_youngest_preemption(both):
    """The dry pool's victim is the lowest priority, then the youngest: the
    old priority -1 slot pays the preemptions, not the younger ones."""
    port, _ = _run_both(both, [P, P, 7], num_slots=2, max_seq=P + G, paged_cache=True,
                        page_size=PS, num_pages=6, fields=dict(priority=[-1, 0, 0]))
    assert port.preemptions > 0
    assert len(port.slot_history[0]) > 1
    assert all(len(port.slot_history[u]) == 1 for u in (1, 2))


def test_equal_priorities_preempt_youngest_as_before(both):
    port, _ = _run_both(both, [P, P], num_slots=2, max_seq=P + G, paged_cache=True,
                        page_size=PS, num_pages=6)
    assert port.preemptions > 0
    assert len(port.slot_history[1]) > 1 and len(port.slot_history[0]) == 1


# ----------------------------------------------------------- prefix probe
def test_probe_is_read_only():
    """``probe`` against the reference's, and without ``match``'s side
    effects: no lookup or hit counted, no LRU touch (a probed chain is
    still the eviction victim)."""
    a = np.asarray([1, 1, 2, 2], np.int32)
    b = np.asarray([1, 1, 3, 3], np.int32)
    got = []
    for pool_cls, cache_cls in ((ref_engine.PagePool, RefPrefixCache), (PagePool, PrefixCache)):
        pool = pool_cls(num_pages=16, page_size=2)
        cache = cache_cls(pool)
        pa = pool.alloc(2)
        cache.insert(a, pa)
        pb_tail = pool.alloc(1)
        cache.insert(b, [pa[0], pb_tail[0]])
        pool.free(pa), pool.free(pb_tail)
        cache.match(b)                            # B hottest; A's leaf is the LRU one
        lookups, hits = cache.lookups, cache.hit_pages
        probes = [cache.probe(a), cache.probe(a[:2]), cache.probe(np.asarray([9, 9], np.int32))]
        for _ in range(5):
            cache.probe(a)
        assert cache.lookups == lookups and cache.hit_pages == hits
        assert cache.evict(1) == 1
        got.append((probes, cache.match(a), pa[0]))
    assert got[0] == got[1]
    probes, matched, root_page = got[1]
    assert probes == [2, 1, 0] and matched == [root_page]


def test_engine_prefix_probe_changes_nothing(both):
    """``prefix_probe`` reports predicted hit tokens and leaves the hit
    rate, the LRU order and every refcount as they were."""
    _, port = _engines(both, num_slots=2, max_seq=2 * P + G, paged_cache=True, page_size=PS,
                       prefix_cache=True)
    reqs = _reqs(port_engine, [P, P + 4], gen=2, seed=3)
    port.run(reqs)
    before = (port.pool_stats["prefix_hit_rate"], port.prefix.lookups, port.prefix.hit_pages,
              {p: port.pool.refcount(p) for p in range(port.num_pages)},
              sorted((n.last_used, n.page) for n in port.prefix._leaves()))
    assert port.prefix_probe(reqs[1].prompt) == (P + 4) // PS * PS
    assert port.prefix_probe(reqs[0].prompt[:5]) == PS
    assert port.prefix_probe(np.asarray([7, 7, 7], np.int32)) == 0
    after = (port.pool_stats["prefix_hit_rate"], port.prefix.lookups, port.prefix.hit_pages,
             {p: port.pool.refcount(p) for p in range(port.num_pages)},
             sorted((n.last_used, n.page) for n in port.prefix._leaves()))
    assert after == before
    _, rings = _engines(both, num_slots=2, max_seq=P + G)
    assert rings.prefix_probe(reqs[0].prompt) == 0


# -------------------------------------------- prefix cap and long requests
def test_prefix_cache_pages_caps_the_index(both):
    """``prefix_cache_pages`` (the reference's demote/promote round trip):
    a 2-page index evicts A's pages to the tier when B publishes, and A
    comes back by promotion; tokens and counters as the reference's."""
    ref, port = _engines(both, max_seq=16, num_slots=1, num_pages=8, paged_cache=True,
                         page_size=PS, prefix_cache=True, prefix_cache_pages=2, host_pages=8)
    got = []
    for e, mod in ((ref, ref_engine), (port, port_engine)):
        a = _reqs(mod, [8], gen=4, seed=0)
        outs = e.run(a) + e.run(_reqs(mod, [8], gen=4, seed=7, uid0=1))
        assert e.prefix.size <= 2
        outs += e.run([mod.Request(uid=10, prompt=a[0].prompt, max_new_tokens=4)])
        got.append(outs)
    _assert_same(ref, got[0], port, got[1])
    assert port.prefix.max_pages == 2
    assert port.host_demoted_pages >= 2 and port.host_promote_hits == 2


def test_long_requests_widen_the_table(both):
    """``long_requests``: every slot's table spans the whole allocatable
    pool, so a request longer than the ring-equivalent width is served
    (the default engine refuses it), as by the reference."""
    ref, port = _engines(both, num_slots=2, max_seq=P, paged_cache=True, page_size=PS,
                         num_pages=9, long_requests=True)
    assert port.table_width == ref.table_width == 8
    _, narrow = _engines(both, num_slots=2, max_seq=P, paged_cache=True, page_size=PS,
                         num_pages=9)
    assert narrow.table_width == 4
    _, wide = _engines(both, num_slots=2, max_seq=P, paged_cache=True, page_size=PS,
                       num_pages=9, table_width=6)
    assert wide.table_width == 6
    probe = _reqs(port_engine, [P + 4], gen=12)[0]
    assert narrow.capacity_shortfall(probe) == 24 - 16
    assert port.capacity_shortfall(probe) == 0
    with pytest.raises(AdmissionError, match="exceeds pool capacity"):
        narrow.submit(probe)
    got = [e.run(_reqs(mod, [P + 4], gen=12))
           for e, mod in ((ref, ref_engine), (port, port_engine))]
    _assert_same(ref, got[0], port, got[1])


# --------------------------------------------------------------- migration
def _migrate(both, n_steps, src_kw, dst_kw, lens):
    """For the reference and the port: submit ``lens`` to a source engine,
    step it ``n_steps`` times, export everything into a fresh destination
    and run it. Returns [(src, dst, outputs, items)] for each."""
    out = []
    ref_src, port_src = _engines(both, **src_kw)
    ref_dst, port_dst = _engines(both, **dst_kw)
    for src, dst, mod in ((ref_src, ref_dst, ref_engine), (port_src, port_dst, port_engine)):
        for r in _reqs(mod, lens):
            src.submit(r)
        early = []
        for _ in range(n_steps):
            early += src.step()
        items = src.export_inflight()
        assert items and not src.has_work
        dst.import_inflight(items)
        out.append((src, dst, early + dst.run(), items))
    return out


def test_export_import_mid_decode_token_identical(both):
    """The failover primitive: a half-served engine's live slots and queue
    move to a fresh engine; the merged outputs are the reference's and an
    uninterrupted run's."""
    kw = dict(num_slots=2, max_seq=P + G, paged_cache=True, page_size=PS)
    (rs, rd, ro, _), (ps, pd, po, items) = _migrate(both, 3, kw, kw, [P, P, 7, 6])
    assert _outs(po) == _outs(ro)
    assert ps.pool.in_use == 0 and ps.prefix is None
    whole = port_engine.ServeEngine(both[1][0], both[1][1], device="cpu", **kw)
    assert [x[1] for x in _outs(po)] == [x[1] for x in _outs(whole.run(
        _reqs(port_engine, [P, P, 7, 6])))]
    assert _state(pd) == _state(rd)
    assert [q.uid for q, _ in items] == [0, 1, 2, 3]  # live slots by admission, then the queue


def test_export_import_sampled_streams_continue(both):
    """Migration continues each request's own stream: the migrated sampled
    run equals the uninterrupted one (the port with itself)."""
    (_, _), (pm, pp) = both
    kw = dict(num_slots=2, max_seq=P + G, paged_cache=True, page_size=PS, device="cpu")

    def reqs():
        rs = _reqs(port_engine, [P, 7])
        for r in rs:
            r.sampling = SamplingParams(temperature=0.9, top_k=7, seed=100 + r.uid)
        return rs

    whole = port_engine.ServeEngine(pm, pp, **kw).run(reqs())
    for host_pages in (0, 16):  # recompute; carried pages swapped in
        a = port_engine.ServeEngine(pm, pp, host_pages=host_pages, **kw)
        for r in reqs():
            a.submit(r)
        early = []
        for _ in range(3):
            early += a.step()
        items = a.export_inflight()
        assert all(res is None or res.rng is not None for _, res in items)
        b = port_engine.ServeEngine(pm, pp, host_pages=host_pages, **kw)
        b.import_inflight(items)
        merged = sorted(early + b.run(), key=lambda o: o.uid)
        assert [o.tokens for o in merged] == [o.tokens for o in whole]
        assert (b.swapped_in_pages > 0) == (host_pages > 0)


def test_import_rejects_over_capacity(both):
    (_, _), (pm, pp) = both
    small = port_engine.ServeEngine(pm, pp, num_slots=1, max_seq=P + G, paged_cache=True,
                                    page_size=PS, device="cpu")
    big = _reqs(port_engine, [P], gen=20)[0]
    with pytest.raises(AdmissionError) as ei:
        small.import_inflight([(big, None)])
    assert ei.value.reason == "exceeds_pool"


def test_export_inflight_carries_swapped_entries_and_recomputes_without_tier(both):
    """A queued swapped-out victim's tier entry leaves the source with the
    record (as arrays, its key cleared: the source tier ends empty); an
    importer without a tier resumes everything by re-prefill."""
    src_kw = dict(num_slots=2, max_seq=P + G, paged_cache=True, page_size=PS, num_pages=6,
                  host_pages=16)
    dst_kw = dict(num_slots=2, max_seq=P + G, paged_cache=True, page_size=PS)
    out = []
    ref_src, port_src = _engines(both, **src_kw)
    ref_dst, port_dst = _engines(both, **dst_kw)
    for src, dst, mod in ((ref_src, ref_dst, ref_engine), (port_src, port_dst, port_engine)):
        for r in _reqs(mod, [P, P, 7]):
            src.submit(r)
        while src.has_work and src.host.pages == 0:
            src.step()
        assert src.host.pages > 0
        items = src.export_inflight()
        assert src.host.pages == 0 and not src.has_work
        assert all(res is None or res.host_key is None for _, res in items)
        assert any(res is not None and res.host_arrays is not None for _, res in items)
        dst.import_inflight(items)
        out.append(src.finished + dst.run())
    _assert_same(ref_dst, out[0], port_dst, out[1])
    assert port_dst.swapped_in_pages == 0


@pytest.mark.parametrize("host_pages", [64])
def test_export_carries_pages_and_import_swaps_in(both, host_pages):
    """Live mid-decode slots carry their pages; a layout-compatible importer
    with a tier adopts them under its own key and swaps them in; tokens are
    the uninterrupted run's and the reference's."""
    kw = dict(num_slots=2, max_seq=P + G, paged_cache=True, page_size=PS,
              host_pages=host_pages)
    (rs, rd, ro, ritems), (ps, pd, po, items) = _migrate(both, 4, kw, kw, [P, P, 7])
    assert ps.pool.in_use == 0
    assert _outs(po) == _outs(ro)
    assert any(res.host_key == ("swap", q.uid) for q, res in items if res and res.generated)
    assert pd.pool_stats["swapped_in_pages"] == rd.pool_stats["swapped_in_pages"] > 0
    assert _state(pd) == _state(rd)


def test_import_layout_mismatch_falls_back_to_recompute(both):
    """An int8 importer cannot adopt fp pages: the records' arrays are
    dropped and the requests re-prefill, as in the reference."""
    src_kw = dict(num_slots=2, max_seq=P + G, paged_cache=True, page_size=PS, host_pages=64)
    dst_kw = dict(src_kw, kv_dtype="int8")
    (rs, rd, ro, _), (ps, pd, po, items) = _migrate(both, 3, src_kw, dst_kw, [P, P])
    for _, res in items:
        if res is not None:
            assert res.host_key is None and res.host_arrays is None
    assert len(po) == 2 and all(len(o.tokens) == G for o in po)
    assert pd.pool_stats["swapped_in_pages"] == 0
    assert _outs(po) == _outs(ro)


def test_export_from_a_speculative_engine_resets_the_draft(both):
    """A speculative engine's exported slots leave their draft rows unsynced
    (``_draft_pos`` -1), and the migrated greedy tokens are the plain
    engine's."""
    (_, _), (pm, pp) = both
    kw = dict(num_slots=2, max_seq=P + G, paged_cache=True, page_size=PS, device="cpu")
    plain = port_engine.ServeEngine(pm, pp, **kw).run(_reqs(port_engine, [P, 7, 6]))
    a = port_engine.ServeEngine(pm, pp, draft_model=pm, draft_params=pp, spec_tokens=2, **kw)
    for r in _reqs(port_engine, [P, 7, 6]):
        a.submit(r)
    early = a.step() + a.step()
    items = a.export_inflight()
    assert (a._draft_pos == -1).all()
    b = port_engine.ServeEngine(pm, pp, draft_model=pm, draft_params=pp, spec_tokens=2, **kw)
    b.import_inflight(items)
    merged = sorted(early + b.run(), key=lambda o: o.uid)
    assert [o.tokens for o in merged] == [o.tokens for o in plain]


def test_reset_metrics_clears_the_lifecycle_counters(both):
    _, port = _engines(both, clock="steps", num_slots=1, max_seq=P + G, max_wall_s=2.0)
    port.run(_reqs(port_engine, [P, P], deadline_s=[None, 0.5]))
    assert port.timeouts and port.shed and port.slot_history
    port.reset_metrics()
    assert port.timeouts == port.shed_requests == 0 and not port.shed and not port.slot_history


def test_lifecycle_modules_import_neither_jax_nor_the_reference():
    """The lifecycle's modules and the router load without jax or any
    ``repro`` module."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.launch.engine, repro_torch.launch.prefix_cache, "
            "repro_torch.launch.router\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(root / "src"), "JAX_PLATFORMS": "cpu",
           "HOME": str(pathlib.Path.home()), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, cwd=root)
