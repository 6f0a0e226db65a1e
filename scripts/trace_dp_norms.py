"""Trace the global squared norms of federated training, the clip scales
they give and the losses that follow, to find where two checkouts' training
first parts.

Runs ``run_training`` at chip_smoke.py's training configuration
(stablelm-1.6b at its published widths, 2 clouds x batch 8 x 256 tokens,
4 steps with a sync every 2, top-k + int8 channel, DP clip 1.0 and noise
0.1, AdamW's clip 1.0) with ``ops.tree_sq_norm`` wrapped, and writes one
JSON object: for every call, the module that made it, the norm's Σx² and
the clip scale min(1, 1 / ‖x‖) it gives as float32 bit patterns; and every
step's loss, as one.

    PYTHONPATH=<checkout>/src python3 scripts/trace_dp_norms.py --out a.json
    python3 scripts/trace_dp_norms.py --compare a.json b.json

``--smoke`` takes the architecture's smoke widths instead, and ``--device
cpu`` runs on the CPU."""
from __future__ import annotations

import argparse
import json
import struct
import sys


def bits(v: float) -> str:
    return struct.pack(">f", v).hex()


def value(h: str) -> float:
    return struct.unpack(">f", bytes.fromhex(h))[0]


def ulps(a: str, b: str) -> int:
    return int(b, 16) - int(a, 16)   # both positive float32: bit patterns are ordered


def trace(smoke: bool, device: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training
    from repro_torch.optim.adamw import clip_scale

    calls = []
    plain = ops.tree_sq_norm

    def traced(leaves):
        total = plain(leaves)
        calls.append((sys._getframe(1).f_globals["__name__"], total.clone(),
                      clip_scale(total, 1.0)))
        return total

    ops.tree_sq_norm = traced
    try:
        res = run_training("stablelm-1.6b", smoke=smoke, steps=4, seq_len=256,
                           per_cloud_batch=8, n_clouds=2, local_steps=2, aggregation="fedavg",
                           compression="topk+int8", topk_ratio=0.01, dp_clip=1.0, dp_noise=0.1,
                           log_every=1, device=device, log_fn=lambda m: None)
    finally:
        ops.tree_sq_norm = plain
    return {
        "calls": [{"caller": who, "sq_norm": bits(sq.item()), "scale": bits(s.item())}
                  for who, sq, s in calls],
        "losses": [bits(h["loss"]) for h in res["history"]],
    }


def compare(a: dict, b: dict) -> None:
    for i, (ca, cb) in enumerate(zip(a["calls"], b["calls"])):
        sq, sc = ulps(ca["sq_norm"], cb["sq_norm"]), ulps(ca["scale"], cb["scale"])
        print(f"call {i} {ca['caller']}: sq_norm {value(ca['sq_norm'])!r} {sq:+d} ulp, "
              f"scale {value(ca['scale'])!r} {sc:+d} ulp")
    for i, (la, lb) in enumerate(zip(a["losses"], b["losses"])):
        print(f"step {i + 1} loss {value(la)!r} -> {value(lb)!r} ({ulps(la, lb):+d} ulp)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the trace of this checkout here")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), help="two traces to compare")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        compare(a, b)
        return
    out = trace(args.smoke, args.device)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"{len(out['calls'])} norms, {len(out['losses'])} losses -> {args.out}")


if __name__ == "__main__":
    main()
