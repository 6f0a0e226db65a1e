"""Continuous-batching serving demo on the PyTorch port: slot pool,
staggered arrivals, immediate backfill (the reference's
``continuous_serving.py``).

    PYTHONPATH=src python examples/torch_continuous_serving.py [--device cpu] [--stagger 0.15]

Eight requests with different prompt/output lengths arrive over about a
second and are served through a pool of THREE KV-cache slots. The engine
admits each request into a free slot the moment one exists (retired
sequences are backfilled immediately, no batch barrier), interleaves
prefill with decode, and produces exactly the tokens the sequential
single-batch oracle (``launch/serve.generate_batch``, one request at a
time) produces for every request: the property the test suite pins. The
model runs in float32, where the engine's chunked prefill and the oracle's
token-by-token decode round alike well inside the gap between the top two
logits.

The second half re-runs the same trace with a sliding-window ring cache;
where the reference re-runs it through its Pallas decode kernel in
interpret mode, the engine here runs its kernels on the card and the same
trace is replayed through an engine on the CPU (the plain versions) to
compare tokens (``--device cpu``: both runs are plain). Then a burst of
simultaneous arrivals with batched multi-slot prefill and per-request
temperature/top-k/top-p sampling.

The finale is the PAGED KV cache: the same trace through a shared page pool
(token-identical to the ring engine), then an OVERSUBSCRIBED pool (half the
memory, watermark admission, youngest-slot preemption with token-exact
resume), one request whose prompt + gen exceeds max_seq (which ring mode
must reject and the paged pool serves), and prefix sharing.

The LAST act is tensor-parallel serving: the same engine sharded over a
2-shard ``model``-axis mesh. Where the reference forces a 2-device CPU host
platform, both shards here sit on the one device (``make_serve_mesh(2,
devices=[device, device])``), so it runs anywhere. Every shard holds its
attention-head slice of EVERY page, so the page budget stays whole: a long
request that a pool of one shard's proportional page count must reject
(``AdmissionError: exceeds_pool``) streams through the meshed pool, with
tokens identical to the single-device engine."""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticCorpus
from repro_torch.launch.engine import AdmissionError, Request, ServeEngine
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.serve import generate_batch
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_map

ARCH = "stablelm-1.6b"
SLOTS = 3


def build_trace(cfg, n=8, seed=0, stagger=0.15):
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, n_domains=4, noise=0.0)
    rng = np.random.default_rng(seed)
    reqs = []
    for r in range(n):
        plen = int(rng.choice([8, 16, 24]))
        gen = int(rng.choice([4, 8, 12]))
        prompt = corpus.sample(torch.Generator().manual_seed(seed + r), torch.ones(4) / 4, 1,
                               plen)["tokens"][0].numpy()
        reqs.append(Request(uid=r, prompt=prompt, max_new_tokens=gen,
                            arrival_time=float(r) * stagger))
    return reqs


def serve(engine, reqs, label):
    t0 = time.time()
    outs = engine.run(reqs, realtime=True)
    wall = time.time() - t0
    total = sum(len(o.tokens) for o in outs)
    print(f"\n=== {label} ===")
    print(f"{len(outs)} requests, {total} tokens, {engine.steps} engine steps, "
          f"{wall:.2f}s ({total / max(wall, 1e-9):.1f} tok/s)")
    for o in outs:
        print(f"  req {o.uid}: slot {o.slot}  prompt {len(o.prompt):2d}  "
              f"gen {len(o.tokens):2d} [{o.finish_reason}]  "
              f"ttft {o.ttft * 1e3:6.1f} ms  latency {o.latency * 1e3:6.1f} ms  "
              f"tokens {o.tokens[:6]}{'...' if len(o.tokens) > 6 else ''}")
    by_slot: dict = {}
    for uid, hist in sorted(engine.slot_history.items()):
        for s in hist:
            by_slot.setdefault(s, []).append(uid)
    for s in sorted(by_slot):
        print(f"  slot {s} served requests {by_slot[s]}")
    return outs


def same(a, b) -> bool:
    return all(x.tokens == y.tokens for x, y in zip(a, b))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stagger", type=float, default=0.15,
                    help="seconds between the trace's arrivals")
    args = ap.parse_args(argv)
    dev = args.device
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)

    def trace(**kw):
        return build_trace(cfg, stagger=args.stagger, **kw)

    reqs = trace()
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    out: dict = {}

    engine = ServeEngine(model, params, num_slots=SLOTS, max_seq=max_seq, device=dev)
    base = serve(engine, reqs, f"continuous batching · {SLOTS} slots")

    # the sequential single-batch oracle, one request at a time
    oracle = [generate_batch(model, params, torch.as_tensor(r.prompt[None], device=dev),
                             r.max_new_tokens)[0][0].tolist() for r in trace()]
    out["oracle_agree"] = all(o.tokens == t for o, t in zip(base, oracle))
    print(f"\nengine tokens identical to the single-batch oracle's: {out['oracle_agree']}")

    engine_w = ServeEngine(model, params, num_slots=SLOTS, max_seq=max_seq, window=8,
                           device=dev)
    serve(engine_w, trace(), "sliding-window ring cache (window=8)")

    # the kernels (on the card) against the plain versions (the CPU)
    engine_c = ServeEngine(model, tree_map(lambda p: p.cpu(), params), num_slots=SLOTS,
                           max_seq=max_seq, device="cpu")
    cout = serve(engine_c, trace(), "plain versions on the CPU")
    out["kernel_agree"] = same(base, cout)
    print(f"\n{dev} engine token-identical to the CPU's plain versions: "
          f"{out['kernel_agree']}")

    # burst: every request arrives at t=0; batched admission prefills each
    # scheduling round in ONE forward, and each request samples its
    # continuation on its own stream (engine seed + uid)
    burst = trace()
    for r in burst:
        r.arrival_time = 0.0
        r.sampling = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
    engine_s = ServeEngine(model, params, num_slots=SLOTS, max_seq=max_seq, seed=1, device=dev)
    souts = serve(engine_s, burst, "burst arrivals · batched prefill + sampling")
    print(f"\nprefill dispatches for {len(souts)} burst requests: "
          f"{engine_s.prefill_dispatches} (batched multi-slot prefill)")

    # paged KV cache: one shared page pool + per-slot page tables replaces
    # the per-slot rings; same tokens
    engine_p = ServeEngine(model, params, num_slots=SLOTS, max_seq=max_seq, paged_cache=True,
                           page_size=8, long_requests=True, device=dev)
    pouts = serve(engine_p, trace(), "paged KV pool (ring-equivalent)")
    out["paged_agree"] = same(base, pouts)
    print(f"\npaged engine token-identical to ring engine: {out['paged_agree']}")

    # oversubscribed: half the pages. Admission throttles on a watermark,
    # decode preempts the youngest slot back to the queue, and resumed
    # requests still finish with exactly the same tokens
    pages_auto = engine_p.num_pages
    engine_t = ServeEngine(model, params, num_slots=SLOTS, max_seq=max_seq, paged_cache=True,
                           page_size=8, num_pages=max(4, pages_auto // 2), watermark_pages=1,
                           device=dev)
    touts = serve(engine_t, trace(), f"oversubscribed pool · {engine_t.pool.capacity} pages "
                                     f"(vs {pages_auto - 1} ring-equivalent)")
    stats = engine_t.pool_stats
    out["oversubscribed_agree"] = same(base, touts)
    print(f"\n{stats['preemptions']} preemptions, peak occupancy "
          f"{stats['occupancy_max']:.0%}; tokens still identical: "
          f"{out['oversubscribed_agree']}")

    # beyond ring capacity: prompt + gen > max_seq has no slot to fit in
    # ring mode but spans the shared pool in paged mode
    long_req = trace(n=1, seed=7)[0]
    long_req.max_new_tokens = max_seq   # prompt + gen ≈ 2 × max_seq
    long_req.arrival_time = 0.0
    louts = engine_p.run([long_req])
    print(f"\noversized request (prompt {len(long_req.prompt)} + gen "
          f"{long_req.max_new_tokens} > max_seq {max_seq}): paged engine generated "
          f"{len(louts[0].tokens)} tokens")

    # prefix sharing: every request opens with the same system prompt;
    # later requests map its published pages and prefill only their tails
    rng = np.random.default_rng(3)
    system = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    shared = [Request(uid=100 + j, prompt=np.concatenate(
        [system, rng.integers(1, cfg.vocab_size, 4 + j).astype(np.int32)]), max_new_tokens=6)
        for j in range(6)]
    engine_x = ServeEngine(model, params, num_slots=SLOTS, max_seq=max_seq + 16,
                           paged_cache=True, page_size=8, prefix_cache=True, device=dev)
    engine_n = ServeEngine(model, params, num_slots=SLOTS, max_seq=max_seq + 16,
                           paged_cache=True, page_size=8, device=dev)
    xouts = engine_x.run([dataclasses.replace(r) for r in shared])
    nouts = engine_n.run([dataclasses.replace(r) for r in shared])
    stats = engine_x.pool_stats
    out["prefix_agree"] = same(xouts, nouts)
    print(f"\nshared system prompt · prefix cache: prefilled {engine_x.prefill_tokens} "
          f"tokens vs {engine_n.prefill_tokens} without sharing (hit rate "
          f"{stats['prefix_hit_rate']:.0%}, {stats['prefix_hit_pages']} pages aliased); "
          f"tokens identical: {out['prefix_agree']}")

    # tensor-parallel finale: the SAME engine sharded over a 2-shard
    # ``model``-axis mesh (both shards on this device)
    s = 2
    engine_m = ServeEngine(model, params, num_slots=SLOTS, max_seq=2 * max_seq,
                           paged_cache=True, page_size=8, long_requests=True,
                           mesh=make_serve_mesh(s, devices=[dev] * s), device=dev)
    mouts = serve(engine_m, trace(), f"tensor-parallel · {s}-shard mesh")
    out["mesh_agree"] = same(base, mouts)
    print(f"\n{s}-shard mesh: per-shard KV bytes 1/{s} of the single-device pool; "
          f"tokens identical to the unsharded engine: {out['mesh_agree']}")

    # memory headroom: every shard holds its head slice of every page, so
    # the meshed engine keeps the whole page budget at 1/S the per-device
    # bytes; one device holding a proportional 1/S-page pool must reject a
    # long request the meshed pool streams through
    cap = engine_m.pool.capacity
    long_req = trace(n=1, seed=11)[0]
    long_req.arrival_time = 0.0
    long_req.max_new_tokens = (cap // s + 2) * 8 - len(long_req.prompt)
    slice_engine = ServeEngine(model, params, num_slots=1, max_seq=2 * max_seq,
                               paged_cache=True, page_size=8, num_pages=cap // s + 1,
                               long_requests=True, device=dev)
    try:
        slice_engine.run([dataclasses.replace(long_req)])
        raise AssertionError("the 1/S-page pool admitted an oversized request")
    except AdmissionError as e:
        out["slice_rejects"] = e.reason
        print(f"\n1/{s}-page pool ({slice_engine.pool.capacity} pages) rejects the "
              f"{len(long_req.prompt)}+{long_req.max_new_tokens}-token request: {e.reason}")
    mlong = engine_m.run([dataclasses.replace(long_req)])
    out["mesh_long_tokens"] = len(mlong[0].tokens)
    print(f"meshed pool ({cap} pages × 1/{s} bytes each) serves it: "
          f"{len(mlong[0].tokens)} tokens generated")
    return out


if __name__ == "__main__":
    main()
