"""Serving CLI of the port: the single-batch path (``serve_batch``, the
default mode: one fixed batch, the prompt teacher-forced through the decode
step in lockstep, then greedy decoding; the oracle the engine's tokens are
held against) and, with ``--continuous``, the continuous-batching engine
(the shared paged KV pool with prefix sharing by default, or per-slot
contiguous rings with ``--no-paged-cache``; chunked or interleaved prefill;
sliding windows; temperature/top-k/top-p sampling; speculative decoding
with ``--draft``/``--spec-tokens``; arrivals ``--stagger`` seconds apart,
served in real time; a ``--max-wall-s`` watchdog). ``--replicas N`` serves
through the fault-tolerant router over N engine replicas
(``launch/router.py``), with faults injected by ``--fault``. ``--mesh N``
serves tensor-parallel over N model-axis shards (``launch/mesh.py``; with
``--num-devices N`` every shard on ``--device``). Every hot-path
dispatch replays a CUDA graph captured once per shape bucket
(``launch/graphs.py``); ``--no-bucket-prefill`` dispatches admission rounds
at their exact shapes, one prefill graph per distinct shape, and
``--no-batch-prefill`` prefills each request in a dispatch of its own.

    # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --full --batch 4 \\
        --prompt-len 64 --gen 64 --window 96
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \\
        --slots 8 --requests 16 --prompt-len 128 --gen 32

    # int8 KV pages and a host tier of 256 pages behind a tight pool
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \\
        --slots 8 --requests 16 --prompt-len 320 --gen 64 --num-pages 200 \\
        --kv-dtype int8 --host-pages 256

    # on the CPU, with the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --batch 2 \\
        --prompt-len 8 --gen 4 --window 4
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu \\
        --no-paged-cache --prefill interleaved --window 4
    # one prefill dispatch per request, on the rings (a window the prompts wrap)
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu \\
        --no-paged-cache --no-batch-prefill --window 4
    # int8 pages and a host tier on the CPU: a pool that preempts and swaps
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu \\
        --requests 3 --gen 6 --prompt-len 8 --slots 2 --page-size 4 --num-pages 6 \\
        --kv-dtype int8 --host-pages 16
    # sampled, and speculative with a same-params draft, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu \\
        --temperature 0.8 --top-k 40 --top-p 0.95
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu \\
        --draft stablelm-1.6b --spec-tokens 3
    # two replicas behind the router, replica 1 killed at its step 4: its
    # in-flight requests finish on replica 0 with the same tokens
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu \\
        --replicas 2 --fault kill:1@4 --stagger 0.01
    # tensor-parallel over 2 shards, both on the CPU (on the card: --full and
    # no --device); the tokens are the unsharded engine's
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu \\
        --mesh 2 --num-devices 2
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.graphs import GraphCache
from repro_torch.launch.mesh import visible_devices
from repro_torch.models.model import build_model


def generate_batch(model, params, prompts: torch.Tensor, gen_tokens: int, *,
                   window: int = 0, graphs: GraphCache | None = None,
                   inputs: dict | None = None) -> tuple[torch.Tensor, float, float]:
    """Lockstep greedy generation over one fixed batch: a ring cache of
    prompt + gen slots (the window's, when smaller), made by
    ``model.init_cache`` from the batch {"tokens": prompts, **inputs}
    (``inputs``: whisper's "audio_embeds", whose encoder it runs), the
    prompts (B, P) teacher-forced through the decode step, then
    ``gen_tokens`` greedy tokens. Decode attention streams every ring slot
    (``swa_decode``; whisper's cross-attention too). The
    decode step and its argmax are one specialization of ``graphs`` (a
    fresh ``GraphCache`` on the prompts' device when None: one CUDA graph
    on the card), replayed for every prompt and generated token; each
    replay's token is copied into the next one's input. Returns (generated
    (B, gen_tokens) int64 on the CPU, prefill seconds, decode seconds); the
    tokens stay on the device until the end. The encoder's wall counts
    into the prefill seconds."""
    b, p = prompts.shape
    device = prompts.device
    vocab = model.cfg.vocab_size
    graphs = graphs if graphs is not None else GraphCache(device)
    prompts = prompts.long()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    cache = model.init_cache(params, {"tokens": prompts, **(inputs or {})}, p + gen_tokens,
                             window=window)

    def step(tok):
        _, logits = model.decode(params, cache, tok, window=window, paged=False)
        return logits[:, :vocab].argmax(dim=-1, keepdim=True)

    tok = None
    for i in range(p):
        tok = graphs("decode", (), step, prompts[:, i:i + 1])
    sync()
    t_prefill = time.perf_counter() - t0
    generated = torch.empty((b, gen_tokens), dtype=torch.long, device=device)
    t0 = time.perf_counter()
    for j in range(gen_tokens):
        generated[:, j:j + 1] = tok   # before the next replay rewrites it
        tok = graphs("decode", (), step, tok)
    sync()
    t_gen = time.perf_counter() - t0
    return generated.cpu(), t_prefill, t_gen


def serve_batch(arch: str, *, smoke: bool = True, batch: int = 4, prompt_len: int = 32,
                gen_tokens: int = 32, window: int = 0, seed: int = 0, device="cuda",
                log_fn=print) -> dict:
    """The single-batch path: seeded random weights, ``batch`` synthetic
    prompts (``engine.synthetic_prompts``: row r is the engine trace's
    request r), ``generate_batch``; reports throughput. The audio family
    decodes over audio embeddings (B, encoder_seq, D) drawn from N(0, 1)
    by a generator seeded ``seed + 2`` (the reference's key); vlm decodes
    from the tokens alone, no image, as the reference's does."""
    from repro_torch.launch.engine import synthetic_prompts

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    prompts = torch.from_numpy(synthetic_prompts(cfg, batch, prompt_len, seed)).to(device)
    inputs = {}
    if cfg.arch_type == "audio":
        inputs["audio_embeds"] = torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), device=device, dtype=torch.float32,
            generator=torch.Generator(device=device).manual_seed(seed + 2),
        ).to(getattr(torch, cfg.dtype))
    graphs = GraphCache(device)
    gen, t_prefill, t_gen = generate_batch(model, params, prompts, gen_tokens, window=window,
                                           graphs=graphs, inputs=inputs)
    result = {
        "arch": cfg.name,
        "device": str(torch.device(device)),
        "batch": batch,
        "prompt_len": prompt_len,
        "gen_tokens": gen_tokens,
        "window": window,
        "prefill_seconds": t_prefill,
        "decode_seconds": t_gen,
        "tokens_per_second": batch * gen_tokens / max(t_gen, 1e-9),
        "compiles": dict(graphs.counts),
        "generated": gen.tolist(),
    }
    log_fn(f"{cfg.name}: prefill {prompt_len} tok in {t_prefill:.2f}s; generated "
           f"{gen_tokens} tok/seq × {batch} seqs in {t_gen:.2f}s "
           f"({result['tokens_per_second']:.1f} tok/s)")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="published widths instead of the smoke config")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window span (0 = full attention)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4, help="[single batch] lockstep batch size")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine instead of the single batch")
    ap.add_argument("--slots", type=int, default=4,
                    help="[continuous] KV-cache slot pool size")
    ap.add_argument("--requests", type=int, default=8,
                    help="[continuous] number of queued requests")
    ap.add_argument("--prefill", choices=("chunked", "interleaved"), default="chunked",
                    help="[continuous] prompt admission mode")
    ap.add_argument("--no-batch-prefill", dest="batch_prefill", action="store_false",
                    help="[continuous] one prefill dispatch per request instead of one per "
                    "admission round")
    ap.add_argument("--no-bucket-prefill", dest="bucket_prefill", action="store_false",
                    help="[continuous] disable shape-bucketed admission rounds (one prefill "
                    "graph per distinct round shape)")
    ap.add_argument("--no-paged-decode", dest="paged_decode", action="store_false",
                    help="[continuous] ring decode streams every slot instead of skipping "
                    "each slot's dead pages (the same tokens)")
    ap.add_argument("--no-paged-cache", dest="paged_cache", action="store_false",
                    help="[continuous] per-slot contiguous ring KV caches instead of the "
                    "shared paged pool (prompt + gen <= max_seq without a window)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="[continuous] tokens per physical KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="[continuous] total physical pages incl. the reserved scratch page "
                    "(0 = ring-equivalent capacity)")
    ap.add_argument("--watermark-pages", type=int, default=0,
                    help="[continuous] free pages admission keeps in reserve while other "
                    "slots are live")
    ap.add_argument("--long-requests", action="store_true",
                    help="[continuous] give every slot the whole allocatable pool as its "
                    "logical width instead of the ring-equivalent default (requests longer "
                    "than the slot count would split, at a wider page table)")
    # None = the advertised default (on where the config supports it);
    # an explicit --prefix-cache fails on a config that cannot honour it
    ap.add_argument("--no-prefix-cache", dest="prefix_cache", action="store_false",
                    default=None,
                    help="[continuous] disable shared-prefix KV reuse (off anyway with "
                    "--no-paged-cache, a window or interleaved prefill)")
    ap.add_argument("--prefix-cache", dest="prefix_cache", action="store_true",
                    help="[continuous] require shared-prefix KV reuse (the default where the "
                    "config supports it; an error on a config that cannot honour it)")
    ap.add_argument("--prefix-cache-pages", type=int, default=0,
                    help="[continuous] cap on pool pages the prefix index may pin (0 = the "
                    "pool's allocatable capacity); entries are LRU-evicted under pressure")
    ap.add_argument("--kv-dtype", choices=("fp", "int8"), default="fp",
                    help="[continuous] KV page storage: the model dtype, or int8 with one "
                    "f32 scale per token slot per kv head")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="[continuous] host-memory tier behind the pool, in pages: "
                    "preemption swaps a slot's pages there instead of re-prefilling, and "
                    "evicted prefix pages demote there (0 = no tier)")
    ap.add_argument("--no-swap", dest="swap", action="store_false",
                    help="[continuous] with --host-pages, keep prefix demote/promote but "
                    "resume preemptions by re-prefill instead of swap-in")
    ap.add_argument("--draft", default=None, metavar="ARCH",
                    help="[continuous] speculative decoding: config of the draft model that "
                    "proposes --spec-tokens tokens per slot per round, verified by the target "
                    "in one batched dispatch (seeded like the target: the target's own arch "
                    "is a same-params draft); greedy tokens stay those of the plain engine")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="[continuous] draft lookahead depth k per round (needs --draft)")
    ap.add_argument("--stagger", type=float, default=0.0,
                    help="[continuous] seconds between arrivals (> 0 serves in real time)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="[continuous] serve through the fault-tolerant router over this many "
                    "engine replicas sharing one set of weights (prefix-affinity and "
                    "occupancy placement, token-exact failover); 1 = one engine, no router")
    ap.add_argument("--fault", action="append", default=None, metavar="KIND:R@S",
                    help="[router] inject a fault: kill:R@S, stall:R@S or slow:R@S@SEC "
                    "(replica R at its own step S); repeatable, the specs make one plan")
    ap.add_argument("--max-wall-s", type=float, default=0.0,
                    help="[continuous] per-request watchdog: retire a slot older than this "
                    "with a timeout result (0 = off)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="[continuous] serve tensor-parallel over this many model-axis shards "
                    "(0 = unsharded); n_heads and n_kv_heads must divide by it; the tokens "
                    "are the unsharded engine's")
    ap.add_argument("--num-devices", type=int, default=0,
                    help="name --device this many times as the mesh's devices (every shard "
                    "on one device; 0 = the visible devices of --device's type)")
    # sampling (temperature 0 = greedy; request r samples on --seed + r)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="[continuous] sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="[continuous] keep the k most likely tokens (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="[continuous] nucleus sampling mass (1.0 = off)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    # the reference's fail-fast contract: a flag the engine would have to
    # ignore is a configuration error, not a degraded run
    if args.mesh > 0:
        if not args.continuous:
            ap.error("--mesh requires --continuous (tensor-parallel serving is an engine path)")
        kind = torch.device(args.device).type
        have = args.num_devices or len(visible_devices(kind))
        if have < args.mesh:
            ap.error(f"--mesh {args.mesh} needs {args.mesh} devices, found {have}; pass "
                     f"--num-devices {args.mesh} (every shard on --device) or run on a larger "
                     "host")
    if args.replicas > 1 and args.mesh > 0:
        ap.error("--replicas with --mesh is not supported: the router builds single-device "
                 "replicas (data-parallel across replicas, not tensor-parallel within one)")
    if args.replicas > 1 and not args.continuous:
        ap.error("--replicas requires --continuous (the router fronts continuous-batching "
                 "engine replicas)")
    if args.fault and args.replicas <= 1:
        ap.error("--fault requires --replicas > 1 (fault injection is a router harness; a "
                 "single engine has nowhere to fail over to)")
    if args.prefix_cache:
        blockers = []
        if not args.continuous:
            blockers.append("batch mode (use --continuous)")
        if not args.paged_cache:
            blockers.append("--no-paged-cache (prefix sharing rides the page table)")
        if args.window > 0:
            blockers.append(f"--window {args.window} (sliding-window ring wraps; prefix pages "
                            "would be overwritten)")
        if args.prefill == "interleaved":
            blockers.append("--prefill interleaved (suffix rounds need chunked batched "
                            "admission)")
        if blockers:
            ap.error("--prefix-cache cannot be honored by this config: " + "; ".join(blockers))
    for flag, hit, replicas_why in (
            ("--kv-dtype int8", args.kv_dtype != "fp",
             "router replicas build fp pools; int8 replica pools are not wired yet"),
            (f"--host-pages {args.host_pages}", args.host_pages > 0,
             "router replicas manage their own pools; per-replica host tiers are not wired "
             "yet")):
        blockers = []
        if hit and not args.continuous:
            blockers.append("batch mode (use --continuous)")
        if hit and not args.paged_cache:
            blockers.append("--no-paged-cache (it works on the page pool)")
        if hit and args.replicas > 1:
            blockers.append(f"--replicas ({replicas_why})")
        if hit and flag.startswith("--host-pages") and args.mesh > 0:
            blockers.append(f"--mesh {args.mesh} (the KV pool is sharded; the host tier "
                            "assumes a single-device pool)")
        if blockers:
            ap.error(f"{flag} cannot be honored by this config: " + "; ".join(blockers))
    if args.host_pages < 0:
        ap.error(f"--host-pages {args.host_pages} cannot be honored: a tier holds >= 0 pages")
    if not args.swap and args.host_pages == 0:
        ap.error("--no-swap cannot be honored: it selects what the host tier does, and "
                 "--host-pages is 0")
    if args.temperature <= 0 and (args.top_k > 0 or args.top_p < 1.0):
        ap.error("--top-k/--top-p require --temperature > 0 (temperature 0 is greedy "
                 "decoding)")
    if args.temperature > 0 and not args.continuous:
        ap.error("sampling flags require --continuous (the single batch is greedy by "
                 "construction)")
    if args.draft is not None or args.spec_tokens > 0:
        blockers = []
        if args.draft is None:
            blockers.append("--spec-tokens without --draft (the lookahead depth needs a "
                            "draft model to propose it)")
        if args.spec_tokens <= 0:
            blockers.append("--draft without --spec-tokens >= 1 (a draft with no lookahead "
                            "depth proposes nothing)")
        if not args.continuous:
            blockers.append("batch mode (use --continuous)")
        if not args.paged_cache:
            blockers.append("--no-paged-cache (the k-token verify rides the suffix-prefill "
                            "path over the page table)")
        if args.prefill == "interleaved":
            blockers.append("--prefill interleaved (the verify dispatch needs chunked "
                            "batched admission)")
        if args.window > 0:
            blockers.append(f"--window {args.window} (verify positions assume the "
                            "full-context page layout)")
        if args.mesh > 0:
            blockers.append(f"--mesh {args.mesh} (the draft runs single-device; sharded "
                            "verify is not wired)")
        if args.replicas > 1:
            blockers.append("--replicas (router replicas do not build draft models yet)")
        if blockers:
            ap.error("speculative decoding cannot be honored by this config: "
                     + "; ".join(blockers))
    if not args.continuous:
        return serve_batch(args.arch, smoke=args.smoke, batch=args.batch,
                           prompt_len=args.prompt_len, gen_tokens=args.gen,
                           window=args.window, seed=args.seed, device=args.device)
    from repro_torch.launch.engine import serve_continuous
    from repro_torch.launch.sampling import SamplingParams

    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                  top_p=args.top_p, seed=args.seed)
    if args.replicas > 1:
        from repro_torch.launch.router import parse_fault_spec, serve_router_continuous

        return serve_router_continuous(
            args.arch, smoke=args.smoke, replicas=args.replicas, num_slots=args.slots,
            n_requests=args.requests, prompt_len=args.prompt_len, gen_tokens=args.gen,
            window=args.window, paged_cache=args.paged_cache, page_size=args.page_size,
            num_pages=args.num_pages, watermark_pages=args.watermark_pages,
            prefix_cache=args.prefix_cache is not False, sampling=sampling,
            fault_plan=parse_fault_spec(args.fault) if args.fault else None,
            seed=args.seed, stagger=args.stagger, max_wall_s=args.max_wall_s,
            device=args.device,
        )
    return serve_continuous(
        args.arch, smoke=args.smoke, num_slots=args.slots, n_requests=args.requests,
        prompt_len=args.prompt_len, gen_tokens=args.gen, window=args.window,
        prefill=args.prefill, paged_decode=args.paged_decode, paged_cache=args.paged_cache,
        page_size=args.page_size, num_pages=args.num_pages, long_requests=args.long_requests,
        watermark_pages=args.watermark_pages, prefix_cache=args.prefix_cache is not False,
        prefix_cache_pages=args.prefix_cache_pages, kv_dtype=args.kv_dtype,
        host_pages=args.host_pages, swap=args.swap, num_shards=args.mesh,
        num_devices=args.num_devices, draft=args.draft,
        spec_tokens=args.spec_tokens, sampling=sampling, batch_prefill=args.batch_prefill,
        bucket_prefill=args.bucket_prefill, seed=args.seed, stagger=args.stagger,
        max_wall_s=args.max_wall_s, device=args.device,
    )


if __name__ == "__main__":
    main()
