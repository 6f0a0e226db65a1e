"""Serving CLI of the port: the continuous-batching engine over the shared
paged KV pool, greedy decoding, prefix sharing on by default.

    # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \\
        --slots 8 --requests 16 --prompt-len 128 --gen 32

    # int8 KV pages and a host tier of 256 pages behind a tight pool
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \\
        --slots 8 --requests 16 --prompt-len 320 --gen 64 --num-pages 200 \\
        --kv-dtype int8 --host-pages 256

    # on the CPU, with the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu
    # int8 pages and a host tier on the CPU: a pool that preempts and swaps
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu \\
        --requests 3 --gen 6 --prompt-len 8 --slots 2 --page-size 4 --num-pages 6 \\
        --kv-dtype int8 --host-pages 16
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="published widths instead of the smoke config")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine (the port's only serving mode)")
    ap.add_argument("--slots", type=int, default=4, help="KV-cache slot pool size")
    ap.add_argument("--requests", type=int, default=8, help="number of queued requests")
    ap.add_argument("--page-size", type=int, default=16, help="tokens per physical KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="total physical pages incl. the reserved scratch page "
                    "(0 = ring-equivalent capacity)")
    ap.add_argument("--watermark-pages", type=int, default=0,
                    help="free pages admission keeps in reserve while other slots are live")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache", action="store_false",
                    help="disable shared-prefix KV reuse")
    ap.add_argument("--kv-dtype", choices=("fp", "int8"), default="fp",
                    help="KV page storage: the model dtype, or int8 with one f32 scale per "
                    "token slot per kv head")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host-memory tier behind the pool, in pages: preemption swaps a "
                    "slot's pages there instead of re-prefilling, and evicted prefix pages "
                    "demote there (0 = no tier)")
    ap.add_argument("--no-swap", dest="swap", action="store_false",
                    help="with --host-pages, keep prefix demote/promote but resume "
                    "preemptions by re-prefill instead of swap-in")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.continuous:
        ap.error("the port serves through the continuous-batching engine only: pass "
                 "--continuous (the single-batch oracle is a later slice)")
    # the reference's fail-fast contract: a flag the engine would have to
    # ignore is a configuration error, not a degraded run
    if args.host_pages < 0:
        ap.error(f"--host-pages {args.host_pages} cannot be honored: a tier holds >= 0 pages")
    if not args.swap and args.host_pages == 0:
        ap.error("--no-swap cannot be honored: it selects what the host tier does, and "
                 "--host-pages is 0")
    from repro_torch.launch.engine import serve_continuous

    return serve_continuous(
        args.arch, smoke=args.smoke, num_slots=args.slots, n_requests=args.requests,
        prompt_len=args.prompt_len, gen_tokens=args.gen, page_size=args.page_size,
        num_pages=args.num_pages, watermark_pages=args.watermark_pages,
        prefix_cache=args.prefix_cache, kv_dtype=args.kv_dtype, host_pages=args.host_pages,
        swap=args.swap, seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
