#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: needs CUDA; prints the card's name and power limit, turns off
   TF32 and reduced-precision bf16 reductions in matrix products;
2. build: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once);
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, at the serving path's shapes (stablelm-1.6b: Hkv 32, G 1, hd 64,
   bf16, page 16, scattered tables with shared pages and scratch tails), at
   a GQA shape (G 4, hd 128) and in float32. Planted faults (the plain
   version with its mask shifted by one key, or without its last live
   page) must land outside the tolerance. Times the kernel, the plain
   version and one PyTorch library call (``scaled_dot_product_attention``
   over the same K/V, gathered up to each row's live span — a yardstick
   only, the port never calls it) as device time from the profiler's
   kernel rows, and the wrapper's wall time per call;
4. golden: the port's engine replays the reference engine's float32 greedy
   trace (``src/repro_torch/testdata/golden_stablelm_smoke.json``) and must
   reproduce its tokens exactly;
5. main path: ``ServeEngine`` over stablelm-1.6b at its published widths
   (24 layers, bf16, seeded random weights), 8 slots, page 16, prefix cache
   on: 8 cold prompts, then 8 prompts sharing a 256-token prefix; checks
   every request, finite logits, cold and suffix dispatches, a prefix hit
   rate > 0 and that every kernel launched; re-runs a cold round, a decode
   step and a suffix round through the plain versions (and through the
   planted faults) from the kernel run's cache and compares logits;
6. channel kernels: top-k, int8, the DP norm and clip/noise against their
   plain versions on the card at the training path's leaves (the embedding,
   100352 x 2048, and one stacked MLP leaf, 24 x 2048 x 5632, fp32, k = 3):
   bitwise (the norm within 1e-6 relative), each with a planted fault that
   must fail its check; times at the embedding leaf;
7. training: ``run_training`` over stablelm-1.6b at its published widths
   (2 clouds, H = 2, 4 steps, batch 8 x 256 per cloud, topk+int8 with error
   feedback, DP clip 1.0 and noise 0.1, FedAvg): finite losses, every
   channel kernel launched, local-step and sync-round times, the sync's
   device time by stage, the idle share of a local step, peak memory; then
   one sync round from a copy of the trained state through the kernels and
   through the plain versions (and a planted fault) with the same noise
   seed, whose new global parameters must agree;
8. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
# Kernel vs plain: max abs err relative to the RMS of the plain output. bf16:
# both sides round the output to bf16, so they may differ by one bf16 ulp
# (2**-7 relative) of an element a few times the RMS. float32: summation
# order over a few hundred keys (~1e-7 relative per add). On an H100 the
# sound bf16 readings were <= 0.024 and the planted faults >= 1.7.
RTOL = {"bfloat16": 0.05, "float32": 1e-4}
# Kernel vs plain logits at full width, relative to the logit scale. In
# float32 the two differ only in summation order: 1e-3 leaves room for 24
# layers of growth. In bf16 a one-ulp difference in one attention output
# grows through 24 random-weight layers: on an H100 the sound readings were
# <= 0.040 x scale and the planted faults >= 0.226 x scale; 0.1 lies between.
LOGIT_RTOL = {"float32": 1e-3, "bfloat16": 0.1}
REPLACES = {
    "paged_decode": "src/repro/kernels/paged_decode.py:208",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:106",
    "suffix_prefill": "src/repro/kernels/flash_suffix_prefill.py:152",
    "int8_roundtrip": "src/repro/kernels/quantize.py:96",
    "topk_sparsify": "src/repro/kernels/topk_compress.py:50",
    "sq_norm": "src/repro/kernels/dp_clip.py:36",
    "clip_noise": "src/repro/kernels/dp_clip.py:58",
}
SOURCES = {
    "paged_decode": "src/repro_torch/csrc/paged_decode.cu",
    "flash_prefill": "src/repro_torch/csrc/flash_prefill.cu",
    "suffix_prefill": "src/repro_torch/csrc/flash_suffix_prefill.cu",
    "int8_roundtrip": "src/repro_torch/csrc/quantize.cu",
    "topk_sparsify": "src/repro_torch/csrc/topk_compress.cu",
    "sq_norm": "src/repro_torch/csrc/dp_clip.cu",
    "clip_noise": "src/repro_torch/csrc/dp_clip.cu",
}
SERVING = ("paged_decode", "flash_prefill", "suffix_prefill")
CHANNEL = ("int8_roundtrip", "topk_sparsify", "sq_norm", "clip_noise")
FP32_FLOPS = 67e12             # H100 SXM fp32 peak outside the tensor cores
# The DP norm, kernel vs plain: both sum in fp32 in other orders (two fixed
# passes vs PyTorch's reduction); over 2e8 squares the relative error of
# either is ~1e-7. A dropped 2048-element chunk or ragged tail moves it by
# far more than 1e-6.
SQ_NORM_RTOL = 1e-6
# The training path's settings.
TOPK_RATIO, DP_CLIP, DP_NOISE, NOISE_SEED = 0.01, 1.0, 0.1, 1234
# Sync round, kernels vs plain versions: they differ only in the norm's
# summation order, so the clip scale may differ in its last ulp; that moves
# a transmitted delta by ~1e-7 of itself, and a new bf16 parameter only
# where g + aggregate sat at a rounding boundary: ~1 element in 1e9. A
# sound run may differ in at most 1e-6 of the parameters, each by at most
# one bf16 ulp (2**-7 relative); a planted fault (top-k keeping k - 1 per
# block) changes ~1e-3 of them.
SYNC_DIFF_FRAC = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


FAILED: list[str] = []


def expect(cond: bool, what: str) -> None:
    """A numeric check whose failure is reported at once and fails the run
    at its end, so that every reading of the run is still printed."""
    if not cond:
        log(f"FAILED: {what}")
        FAILED.append(what)


def timed_ms(fn, iters: int = 20) -> tuple[float, float]:
    """(device ms, wall ms) per call of ``fn``. Device time is the sum of
    the profiler's kernel rows (every kernel the call launched); wall time
    is CUDA events around ``iters`` back-to-back calls, host work included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    check(dev > 0, "the profiler saw no kernel: device time not measured")
    return dev / iters / 1e3, wall


# Planted faults: the plain versions with one deliberate error each, which
# the kernel-vs-plain comparisons must tell from the sound plain versions.
def _decode_shift(q, kp, vp, pos, table, window=0):
    """Mask shifted by one: the newest key (at ``pos``) is left out."""
    from repro_torch.kernels import ref

    return ref.paged_decode_ref(q, kp, vp, pos - 1, table, window)


def _decode_drop_page(q, kp, vp, pos, table, window=0):
    """The row's last live page (the one holding ``pos``) is left out."""
    from repro_torch.kernels import ref

    page = kp.shape[1]
    return ref.paged_decode_ref(q, kp, vp, pos // page * page - 1, table, window)


def _prefill_shift(q, k, v, *, window=0):
    """Causal mask shifted by one: query i sees keys 0..i-1 (query 0 keeps
    key 0)."""
    import torch

    from repro_torch.kernels import ref

    head = ref.flash_prefill_ref(q[:, :1], k[:, :1], v[:, :1], window=window)
    rest = ref.flash_prefill_ref(q[:, 1:], k[:, :-1], v[:, :-1], window=window)
    return torch.cat([head, rest], 1)


def _suffix_shift(q, ks, vs, pk, pv, table, starts, *, prefix_width):
    """The last cached prefix key is left out."""
    from repro_torch.kernels import ref

    return ref.suffix_prefill_ref(q, ks, vs, pk, pv, table, (starts - 1).clamp(min=0),
                                  prefix_width=prefix_width)


def _suffix_drop_page(q, ks, vs, pk, pv, table, starts, *, prefix_width):
    """The last cached prefix page is left out."""
    from repro_torch.kernels import ref

    page = pk.shape[1]
    cut = (starts - (starts - 1) % page - 1).clamp(min=0)
    return ref.suffix_prefill_ref(q, ks, vs, pk, pv, table, cut, prefix_width=prefix_width)


@contextlib.contextmanager
def plain_kernels(**swap):
    """Route the model's attention through the plain versions, on whatever
    device the tensors are: the reference run of the logit comparison.
    ``swap`` replaces some of them (``paged_decode=``, ``flash_prefill=``,
    ``suffix_prefill=``), e.g. with a planted fault."""
    from repro_torch.kernels import ops, ref

    names = {"paged_decode": "paged_decode_attention",
             "flash_prefill": "flash_prefill_attention",
             "suffix_prefill": "suffix_prefill_attention"}
    plain = {"paged_decode": ref.paged_decode_ref, "flash_prefill": ref.flash_prefill_ref,
             "suffix_prefill": ref.suffix_prefill_ref, **swap}
    saved = {k: getattr(ops, attr) for k, attr in names.items()}
    for k, attr in names.items():
        setattr(ops, attr, plain[k])
    try:
        yield
    finally:
        for k, attr in names.items():
            setattr(ops, attr, saved[k])


@contextlib.contextmanager
def plain_channel(**swap):
    """Route the channel kernels' wrappers to their plain versions on
    whatever device the tensors are; ``swap`` replaces some of them
    (``topk_sparsify=``, ``int8_roundtrip=``, ``sq_norm=``, ``clip_noise=``),
    e.g. with a planted fault."""
    from repro_torch.kernels import dp_clip, quantize, ref, topk_compress

    where = {"topk_sparsify": topk_compress, "int8_roundtrip": quantize,
             "sq_norm": dp_clip, "clip_noise": dp_clip}
    plain = {"topk_sparsify": ref.topk_sparsify_ref, "int8_roundtrip": ref.int8_roundtrip_ref,
             "sq_norm": ref.sq_norm_ref, "clip_noise": ref.clip_noise_ref, **swap}
    saved = {k: getattr(mod, k) for k, mod in where.items()}
    for k, mod in where.items():
        setattr(mod, k, plain[k])
    try:
        yield
    finally:
        for k, mod in where.items():
            setattr(mod, k, saved[k])


def _topk_short(x, k):
    """Planted fault: top-k keeping k - 1 per block."""
    from repro_torch.kernels import ref

    return ref.topk_sparsify_ref(x, k - 1)


def _int8_div128(x):
    """Planted fault: the int8 scale with 128 in place of 127."""
    import torch

    from repro_torch.kernels import ref

    rows = ref._blocks(x)
    amax = rows.abs().amax(dim=1, keepdim=True)
    scale = (amax / amax.new_tensor(128.0)).clamp(min=1e-12)
    return ref._unblocks(torch.round(rows / scale).clamp(-127, 127) * scale, x)


# ------------------------------------------------------------------ phase 1
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    import repro_torch  # noqa: F401  (fails before any output outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        "matmul.allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return smi


# ------------------------------------------------------------------ phase 2
def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(reports)} kernel libraries built in {time.perf_counter() - t0:.1f} s")
    for name, out in reports.items():
        regs = sorted({line.split("ptxas info    : ")[-1] for line in out.splitlines()
                       if "registers" in line})
        log(f"[build] {name}: {'; '.join(regs)}")


# ------------------------------------------------------------------ phase 3
def _table(gen, live_pages, width, num_pages, shared=0):
    """Scattered page table: row r's first live_pages[r] logical pages at
    random distinct physical pages (the first ``shared`` of them common to
    all rows), the rest scratch page 0."""
    import torch

    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    need = shared + sum(max(n - shared, 0) for n in live_pages)
    check(need <= num_pages - 1, f"pool of {num_pages} pages cannot hold {need}")
    table = torch.zeros(len(live_pages), width, dtype=torch.int32)
    nxt = shared
    for r, n in enumerate(live_pages):
        own = n - min(n, shared)
        table[r, :n] = torch.cat([perm[: min(n, shared)], perm[nxt: nxt + own]])
        nxt += own
    return table


def _decode_case(gen, dt, b, hkv, g, hd, page, t_w, num_pages, pos_list, shared):
    import torch

    d = DEVICE
    q = torch.randn(b, hkv, g, hd, generator=gen).to(d, dt)
    kp = torch.randn(num_pages, page, hkv, hd, generator=gen).to(d, dt)
    vp = torch.randn(num_pages, page, hkv, hd, generator=gen).to(d, dt)
    pos = torch.tensor(pos_list, dtype=torch.int32)
    live = [min(-(-(p + 1) // page), t_w) for p in pos_list]
    table = _table(gen, live, t_w, num_pages, shared).to(d)
    return q, kp, vp, pos.to(d), table


def _unique_tokens(table, spans, page):
    """Distinct (physical page, offset) slots that rows read: row r reads
    its logical token slots 0..spans[r]-1 through its table row."""
    tab = table.cpu().tolist()
    return len({(tab[r][c // page], c % page) for r, n in enumerate(spans) for c in range(n)})


def phase_kernels(smi):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(1)
    rows = {}

    def compare(name, dt, shape, out, plain, faults=()):
        """Kernel output vs plain version (relative to the plain output's
        RMS), and each planted fault's output vs the kernel's."""
        dname = str(dt).split(".")[-1]
        tol = RTOL[dname]
        rms = plain.float().pow(2).mean().sqrt().item()
        e = (out.float() - plain.float()).abs().max().item()
        msg = (f"[kernels] {name} {dname} {shape}: max_abs_err {e:.3e}, plain RMS {rms:.3e}, "
               f"err/RMS {e / rms:.3e} (tol {tol:g})")
        expect(e <= tol * rms, f"{name} {dname} {shape}: err/RMS {e / rms} > {tol}")
        for fname, fout in faults:
            fe = (out.float() - fout.float()).abs().max().item()
            msg += f"; planted fault '{fname}' err/RMS {fe / rms:.3e}"
            expect(fe > tol * rms, f"{name} {dname}: planted fault '{fname}' within tolerance")
        log(msg)
        return e

    # --- paged decode at the main path's shape: 8 slots at depths 100..380,
    # the first 6 pages shared (a common prompt prefix), scratch tails
    b, hkv, hd, page, t_w, num_pages = 8, 32, 64, 16, 208, 209
    elem = 2
    pos_list = [100 + 40 * r for r in range(b)]
    q, kp, vp, pos, table = _decode_case(gen, torch.bfloat16, b, hkv, 1, hd, page, t_w,
                                         num_pages, pos_list, shared=6)
    dec = (q, kp, vp, pos, table)
    e = compare("paged_decode", torch.bfloat16, "B8 Hkv32 G1 hd64 page16",
                ops.paged_decode_attention(*dec), ref.paged_decode_ref(*dec),
                [("mask shifted by one", _decode_shift(*dec)),
                 ("last live page dropped", _decode_drop_page(*dec))])
    # library call: each row's live pages only, padded to the longest span
    live = [-(-(p + 1) // page) for p in pos_list]
    kg = ref.gather_pages_ref(kp, table[:, : max(live)]).transpose(1, 2)   # (B, H, C, hd)
    vg = ref.gather_pages_ref(vp, table[:, : max(live)]).transpose(1, 2)
    mask = torch.arange(max(live) * page, device=DEVICE)[None, :] <= pos[:, None].long()
    qs = q.reshape(b, hkv, 1, hd)
    spans = [p + 1 for p in pos_list]
    uniq = _unique_tokens(table, spans, page)
    ms, wall = timed_ms(lambda: ops.paged_decode_attention(*dec))
    rows["paged_decode"] = dict(
        max_abs_err=e, ms=ms, wrapper_ms=wall,
        plain_ms=timed_ms(lambda: ref.paged_decode_ref(*dec))[0],
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask[:, None, None, :]))[0],
        # q and out, each distinct live K/V slot once, pos and live table entries
        bytes=(2 * b * hkv * hd + 2 * uniq * hkv * hd) * elem + 4 * (b + sum(live)),
        flops=4 * sum(spans) * hkv * hd,
    )
    log(f"[kernels] paged_decode bound counts {uniq} distinct live tokens "
        f"({sum(spans)} over the rows)")

    # --- flash prefill at the cold round's shape: 8 rows, bucket 512
    n, s = 8, 512
    q5 = torch.randn(n, s, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
    k4 = torch.randn(n, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    v4 = torch.randn(n, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    e = compare("flash_prefill", torch.bfloat16, "B8 S512 Hkv32 G1 hd64",
                ops.flash_prefill_attention(q5, k4, v4), ref.flash_prefill_ref(q5, k4, v4),
                [("mask shifted by one", _prefill_shift(q5, k4, v4))])
    qt, kt, vt = (x.reshape(n, s, hkv, hd).transpose(1, 2) for x in (q5, k4, v4))
    ms, wall = timed_ms(lambda: ops.flash_prefill_attention(q5, k4, v4))
    rows["flash_prefill"] = dict(
        max_abs_err=e, ms=ms, wrapper_ms=wall,
        plain_ms=timed_ms(lambda: ref.flash_prefill_ref(q5, k4, v4), iters=5)[0],
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                   is_causal=True))[0],
        bytes=4 * n * s * hkv * hd * elem,
        flops=4 * n * hkv * hd * s * (s + 1) // 2,
    )

    # --- suffix prefill at the hit round's shape: 8 rows of 64-token
    # suffixes behind a 256-token prefix shared by all (16 pages, W 16)
    s_suf, start, w_pfx = 64, 256, 16
    q5 = torch.randn(n, s_suf, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
    ks = torch.randn(n, s_suf, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    vs = torch.randn(n, s_suf, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    live = [(start + s_suf) // page] * n
    stable = _table(gen, live, t_w, num_pages, shared=w_pfx).to(DEVICE)
    starts = torch.full((n,), start, dtype=torch.int32, device=DEVICE)
    args = (q5, ks, vs, kp, vp, stable, starts)
    e = compare("suffix_prefill", torch.bfloat16, "n8 S64 start256 W16 Hkv32 G1 hd64",
                ops.suffix_prefill_attention(*args, prefix_width=w_pfx),
                ref.suffix_prefill_ref(*args, prefix_width=w_pfx),
                [("last prefix key dropped", _suffix_shift(*args, prefix_width=w_pfx)),
                 ("last prefix page dropped", _suffix_drop_page(*args, prefix_width=w_pfx))])
    kc = torch.cat([ref.gather_pages_ref(kp, stable[:, :w_pfx]), ks], 1).transpose(1, 2)
    vc = torch.cat([ref.gather_pages_ref(vp, stable[:, :w_pfx]), vs], 1).transpose(1, 2)
    kpos = torch.arange(start + s_suf, device=DEVICE)
    smask = (kpos[None, :] <= start + torch.arange(s_suf, device=DEVICE)[:, None])
    qt = q5.reshape(n, s_suf, hkv, hd).transpose(1, 2)
    uniq = _unique_tokens(stable, [min(start, w_pfx * page)] * n, page)
    pp = min(-(-start // page), w_pfx)
    ms, wall = timed_ms(lambda: ops.suffix_prefill_attention(*args, prefix_width=w_pfx))
    rows["suffix_prefill"] = dict(
        max_abs_err=e, ms=ms, wrapper_ms=wall,
        plain_ms=timed_ms(lambda: ref.suffix_prefill_ref(*args, prefix_width=w_pfx))[0],
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(qt, kc, vc,
                                                                   attn_mask=smask))[0],
        # q, suffix k/v and out per row, each distinct prefix slot once,
        # starts and the prefix table entries
        bytes=(4 * n * s_suf + 2 * uniq) * hkv * hd * elem + 4 * n * (1 + pp),
        flops=4 * n * hkv * hd * (s_suf * start + s_suf * (s_suf + 1) // 2),
    )
    log(f"[kernels] suffix_prefill bound counts {uniq} distinct prefix tokens "
        f"({n * start} over the rows)")

    # --- GQA (G 4, hd 128) in bf16, and every kernel in float32
    for dt, (b2, hkv2, g2, hd2) in ((torch.bfloat16, (4, 8, 4, 128)),
                                   (torch.float32, (3, 4, 2, 64))):
        pos_list = [5, 77, 130, 200][:b2]
        q, kp2, vp2, pos2, table2 = _decode_case(gen, dt, b2, hkv2, g2, hd2, 16, 16, 64,
                                                 pos_list, shared=2)
        compare("paged_decode", dt, f"B{b2} Hkv{hkv2} G{g2} hd{hd2} window40",
                ops.paged_decode_attention(q, kp2, vp2, pos2, table2, 40),
                ref.paged_decode_ref(q, kp2, vp2, pos2, table2, 40))
        s2 = 100
        q5 = torch.randn(b2, s2, hkv2, g2, hd2, generator=gen).to(DEVICE, dt)
        k4 = torch.randn(b2, s2, hkv2, hd2, generator=gen).to(DEVICE, dt)
        v4 = torch.randn(b2, s2, hkv2, hd2, generator=gen).to(DEVICE, dt)
        compare("flash_prefill", dt, f"B{b2} S{s2} Hkv{hkv2} G{g2} hd{hd2}",
                ops.flash_prefill_attention(q5, k4, v4), ref.flash_prefill_ref(q5, k4, v4))
        st2 = torch.tensor([0, 17, 48, 64][:b2], dtype=torch.int32, device=DEVICE)
        sargs = (q5, k4, v4, kp2, vp2, table2, st2)
        compare("suffix_prefill", dt, f"n{b2} S{s2} starts0..64 Hkv{hkv2} G{g2} hd{hd2}",
                ops.suffix_prefill_attention(*sargs, prefix_width=4),
                ref.suffix_prefill_ref(*sargs, prefix_width=4))

    for name, r in rows.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / BF16_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels] {name} path shape ({smi}): kernel device ms {r['ms']:.4f} (wrapper "
            f"wall {r['wrapper_ms']:.4f}) plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.3f} GFLOP)")
    return rows


# ------------------------------------------------------------------ phase 4
def phase_golden():
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata/golden_stablelm_smoke.json").read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)
    eng = ServeEngine(build_model(cfg), params, device=DEVICE, **g["engine"])
    before = dict(ops.LAUNCHES)
    outs = eng.run([Request(uid=u, prompt=p, max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    torch.cuda.synchronize()
    launched = {k: ops.LAUNCHES[k] - before[k] for k in SERVING}
    got = [o.tokens for o in outs]
    check(got == g["tokens"], f"golden fp32 tokens differ from the reference:\n{got}\n"
                              f"{g['tokens']}")
    check(all(v > 0 for v in launched.values()), f"golden run missed a kernel: {launched}")
    log(f"[golden] {len(got)} requests, fp32 greedy tokens identical to the reference "
        f"engine's; kernel launches {launched}")


# ------------------------------------------------------------------ phase 5
def _main_path_requests(vocab):
    from repro_torch.launch.engine import Request

    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, 256, dtype=np.int32)
    cold = []
    for u, n in enumerate(rng.integers(96, 385, 8)):
        p = rng.integers(0, vocab, int(n), dtype=np.int32)
        if u == 0:  # its retirement publishes the shared prefix's 16 pages
            p = np.concatenate([prefix, rng.integers(0, vocab, 64, dtype=np.int32)])
        cold.append(Request(uid=u, prompt=p, max_new_tokens=32))
    hits = [Request(uid=8 + j, max_new_tokens=32, prompt=np.concatenate(
        [prefix, rng.integers(0, vocab, int(rng.integers(32, 65)), dtype=np.int32)]))
        for j in range(8)]
    return cold, hits


def _logit_parity(model, params, cfg, cold, hits):
    """A cold round over the 8 cold prompts, one decode step and a suffix
    round over the 8 shared-prefix prompts, on the card. Each stage runs
    through the kernels, then from a copy of the same cache through the
    plain versions and through each planted fault of its kernel."""
    import torch

    from repro_torch.launch.engine import bucket_length, bucket_pages

    page, n = 16, 8
    width = 2 * 26 * n + 1
    cache = model.init_paged_cache(n, width, page, 26 * 2, device=DEVICE)
    table = np.zeros((n, 52), np.int32)
    nxt = 1
    cold_len = [len(r.prompt) for r in cold]
    for i, L in enumerate(cold_len):
        k = -(-(L + 1) // page)
        table[i, :k] = np.arange(nxt, nxt + k)
        nxt += k
    cache["table"].copy_(torch.from_numpy(table))
    tokens = np.zeros((n, bucket_length(max(cold_len))), np.int32)
    for i, r in enumerate(cold):
        tokens[i, : len(r.prompt)] = r.prompt
    slots = torch.arange(n, device=DEVICE)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(DEVICE)

    def stage(what, run, faults):
        snap = {k: v.clone() for k, v in cache.items()}
        _, lk = run(cache)
        lk = lk[:, : cfg.vocab_size]
        check(bool(torch.isfinite(lk).all()), f"{what}: non-finite logits")
        got = {}
        for fname, swap in [("plain", {}), *faults]:
            twin = {k: v.clone() for k, v in snap.items()}
            with plain_kernels(**swap):
                _, lp = run(twin)
            got[fname] = lp[:, : cfg.vocab_size]
            del twin
        del snap
        tol = LOGIT_RTOL[cfg.dtype]
        scale = max(got["plain"].abs().max().item(), 1.0)
        d = (lk - got["plain"]).abs().max().item()
        agree = (lk.argmax(-1) == got["plain"].argmax(-1)).float().mean().item()
        msg = (f"[main] {cfg.dtype} {what}: kernel vs plain max |dlogit| {d:.3e} = "
               f"{d / scale:.3e} x logit scale {scale:.2f} (tol {tol:g} x scale), argmax "
               f"agreement {agree:.2f}")
        expect(d <= tol * scale, f"{cfg.dtype} {what}: logit diff {d} too large")
        for fname, _ in faults:
            fd = (lk - got[fname]).abs().max().item()
            msg += f"; planted fault '{fname}' {fd:.3e} = {fd / scale:.3e} x scale"
            expect(fd > tol * scale, f"{cfg.dtype} {what}: planted fault '{fname}' within "
                                     "tolerance")
        log(msg)
        return lk

    lk = stage("cold round", lambda c: model.prefill_slots(params, c, t(tokens), t(cold_len),
                                                           slots),
               [("mask shifted by one", dict(flash_prefill=_prefill_shift))])
    feed = lk.argmax(-1, keepdim=True).to(torch.int32)
    stage("decode step", lambda c: model.decode(params, c, feed),
          [("mask shifted by one", dict(paged_decode=_decode_shift)),
           ("last live page dropped", dict(paged_decode=_decode_drop_page))])
    # suffix round: rows reuse cold row 0's 16 prefix pages (the shared
    # prefix) and get fresh pages behind them
    suf = [r.prompt[256:] for r in hits]
    table_h = np.zeros((n, 52), np.int32)
    for i, p in enumerate(suf):
        k = -(-(256 + len(p)) // page)
        table_h[i, :16] = table[0, :16]
        table_h[i, 16:k] = np.arange(nxt, nxt + k - 16)
        nxt += k - 16
    cache["table"].copy_(torch.from_numpy(table_h))
    stoks = np.zeros((n, bucket_length(max(len(p) for p in suf))), np.int32)
    for i, p in enumerate(suf):
        stoks[i, : len(p)] = p
    starts = t(np.full(n, 256, np.int32))
    lens = [len(p) for p in suf]
    pw = bucket_pages(16, 52)
    stage("suffix round", lambda c: model.prefill_slots(params, c, t(stoks), t(lens), slots,
                                                        starts=starts, prefix_pages=pw),
          [("last prefix key dropped", dict(suffix_prefill=_suffix_shift)),
           ("last prefix page dropped", dict(suffix_prefill=_suffix_drop_page))])


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _kernel_rows(prof):
    """The profiler's kernel rows only: an operator's row repeats the time of
    the kernels it launched."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def _profile_decode(eng, smi, n=5):
    """Host wall time and device time of one batched decode step (8 slots,
    the engine's cache as the trace left it), and the kernels it launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    feed = torch.zeros((eng.num_slots, 1), dtype=torch.int32, device=DEVICE)

    def step():
        eng.model.decode(eng.params, eng.cache, feed)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = _kernel_rows(prof)
    if not events:
        log(f"[profile] {smi}: decode step host wall {host_ms:.2f} ms; device time not "
            "measured (the profiler saw no kernels)")
        return
    dev_ms = sum(e.self_device_time_total for e in events) / n / 1e3
    launches = sum(e.count for e in events) / n
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    log(f"[profile] {smi}: decode step host wall {host_ms:.2f} ms, device time {dev_ms:.3f} ms "
        f"in {launches:.0f} kernel launches, device idle share {1 - dev_ms / host_ms:.3f}; "
        "top: " + "; ".join(f"{e.key[:40]} x{e.count // n} {e.self_device_time_total / n / 1e3:.3f}"
                            " ms" for e in top))


def phase_main_path(smi):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models.model import build_model

    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = model.init(gen, DEVICE)
    n_params = _numel(params)
    log(f"[main] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
        f"hd {cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.2f} B parameters")
    cold, hits = _main_path_requests(cfg.vocab_size)
    _logit_parity(model, params, cfg, cold, hits)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _cast(params, torch.float32)
    _logit_parity(build_model(cfg32), params32, cfg32, cold, hits)
    del params32
    torch.cuda.empty_cache()

    eng = ServeEngine(model, params, num_slots=8, max_seq=384 + 32, page_size=16,
                      prefix_cache=True, device=DEVICE)
    eng.warm(sorted({len(r.prompt) for r in cold}), gen_tokens=2)
    finite = []

    def checked(fn):
        def run(*a, **kw):
            cache, logits = fn(*a, **kw)
            finite.append(torch.isfinite(logits[:, : cfg.vocab_size]).all())
            return cache, logits
        return run

    eng.model = dataclasses.replace(model, decode=checked(model.decode),
                                    prefill_slots=checked(model.prefill_slots))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = []
    for group in (cold, hits):  # the second group arrives once the first retired
        eng.reset_clock()
        outs += eng.run(group)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in SERVING}
    ps = eng.pool_stats
    check(len(outs) == 16 and all(len(o.tokens) == 32 for o in outs),
          "not every request finished with 32 tokens")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    check(ps["suffix_dispatches"] > 0 and ps["cold_dispatches"] > 0,
          f"dispatch split not exercised: {ps}")
    check(ps["prefix_hit_rate"] > 0, "no prefix hit")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    tokens = sum(len(o.tokens) for o in outs)
    ttft = float(np.percentile([o.ttft for o in outs], 50))
    lat = float(np.percentile([o.latency for o in outs], 50))
    log(f"[main] {smi}: 16 requests x 32 tokens in {wall:.3f} s: {tokens / wall:.1f} tok/s, "
        f"TTFT p50 {ttft * 1e3:.1f} ms, latency p50 {lat * 1e3:.1f} ms; {eng.steps} decode "
        f"steps, {ps['cold_dispatches']} cold + {ps['suffix_dispatches']} suffix dispatches, "
        f"prefix hit rate {ps['prefix_hit_rate']:.3f}, {ps['cow_copies']} CoW, "
        f"{ps['preemptions']} preemptions; launches {launches}")
    _profile_decode(eng, smi)
    return launches


# ------------------------------------------------------------------ phase 6
def phase_channel_kernels(smi):
    """The four channel kernels against their plain versions at the
    training path's leaves, each with a planted fault; times at the
    embedding leaf."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dp_clip import CHUNK

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    k = ops.topk_k(TOPK_RATIO)
    one = torch.ones((), device=DEVICE)
    scale = torch.tensor(0.37, device=DEVICE)
    sigma = 0.05
    rows = {}

    def bitwise(name, what, out, plain, faults):
        e = (out.float() - plain.float()).abs().max().item()
        expect(torch.equal(out, plain), f"{name} {what}: kernel differs from plain (max {e})")
        msg = f"[channel] {name} {what}: bitwise equal {torch.equal(out, plain)}, max_abs_err {e:.3e}"
        for fname, fout in faults:
            bad = torch.equal(out, fout)
            expect(not bad, f"{name} {what}: planted fault '{fname}' not caught")
            msg += f"; planted fault '{fname}' differs: {not bad}"
        log(msg)
        return e

    def rel(a, b):
        return abs(a.item() - b.item()) / abs(b.item())

    for lname, shape in (("embed 100352x2048", (100352 * 2048,)),
                         ("mlp 24x2048x5632", (24, 2048, 5632))):
        x = torch.randn(shape, generator=gen, device=DEVICE) * 1e-3
        noise = torch.randn(shape, generator=gen, device=DEVICE)
        n = x.numel()
        errs = {
            "topk_sparsify": bitwise("topk_sparsify", f"{lname} k={k}",
                                     ops.topk_sparsify_leaf(x, TOPK_RATIO),
                                     ref.topk_sparsify_ref(x, k),
                                     [("keeps k-1 per block", _topk_short(x, k))]),
            "int8_roundtrip": bitwise("int8_roundtrip", lname, ops.int8_roundtrip_leaf(x),
                                      ref.int8_roundtrip_ref(x),
                                      [("divisor 128", _int8_div128(x))]),
            "clip_noise": bitwise("clip_noise", f"{lname} scale 1, sigma {sigma}",
                                  ops.clip_noise(x, one, noise, sigma),
                                  ref.clip_noise_ref(x, one, noise, sigma),
                                  [("noise term left out", ref.clip_noise_ref(x, one))]),
        }
        bitwise("clip_noise", f"{lname} clip scale 0.37, no noise", ops.clip_noise(x, scale),
                ref.clip_noise_ref(x, scale), [("scale left out", x)])
        flat = x.reshape(-1)
        ragged = flat[: 1_000_077]
        got, want = ops.sq_norm(x), ref.sq_norm_ref(x)
        got_r, want_r = ops.sq_norm(ragged), ref.sq_norm_ref(ragged)
        f_chunk = rel(got, ref.sq_norm_ref(flat[:-CHUNK]))
        f_tail = rel(got_r, ref.sq_norm_ref(ragged[:1_000_000]))
        errs["sq_norm"] = abs(got.item() - want.item())
        expect(rel(got, want) <= SQ_NORM_RTOL, f"sq_norm {lname}: rel err {rel(got, want)}")
        expect(rel(got_r, want_r) <= SQ_NORM_RTOL, f"sq_norm ragged: {rel(got_r, want_r)}")
        expect(f_chunk > SQ_NORM_RTOL and f_tail > SQ_NORM_RTOL,
               f"sq_norm planted faults not caught: {f_chunk}, {f_tail}")
        log(f"[channel] sq_norm {lname}: rel err {rel(got, want):.3e} (tol {SQ_NORM_RTOL:g}); "
            f"ragged n=1000077 rel err {rel(got_r, want_r):.3e}; planted faults: last "
            f"{CHUNK}-element chunk dropped {f_chunk:.3e}, ragged tail dropped {f_tail:.3e}")
        if lname.startswith("embed"):
            nb_rounds = k  # continuous data: no ties, so exactly k rounds per block
            timing = {
                "topk_sparsify": (lambda: ops.topk_sparsify_leaf(x, TOPK_RATIO),
                                  lambda: ref.topk_sparsify_ref(x, k), None,
                                  8 * n, n * (2 + 2 * nb_rounds)),
                "int8_roundtrip": (lambda: ops.int8_roundtrip_leaf(x),
                                   lambda: ref.int8_roundtrip_ref(x), None, 8 * n, 6 * n),
                "sq_norm": (lambda: ops.sq_norm(x), lambda: ref.sq_norm_ref(x),
                            lambda: torch.dot(flat, flat), 4 * n + 4, 2 * n),
                "clip_noise": (lambda: ops.clip_noise(x, one, noise, sigma),
                               lambda: ref.clip_noise_ref(x, one, noise, sigma),
                               lambda: torch.add(x, noise, alpha=sigma), 12 * n + 4, 3 * n),
            }
            for name, (kern, plain, lib, nbytes, flops) in timing.items():
                ms, wall = timed_ms(kern)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / FP32_FLOPS * 1e3
                rows[name] = dict(
                    max_abs_err=errs[name], ms=ms, wrapper_ms=wall,
                    plain_ms=timed_ms(plain, iters=5)[0],
                    library_ms=None if lib is None else timed_ms(lib)[0],
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                )
                r = rows[name]
                log(f"[channel] {name} {lname} ({smi}): kernel device ms {r['ms']:.4f} "
                    f"(wrapper wall {r['wrapper_ms']:.4f}) plain_ms {r['plain_ms']:.4f} "
                    f"library_ms {r['library_ms'] if lib is None else format(r['library_ms'], '.4f')} "
                    f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}: {nbytes / 1e9:.3f} GB)")
        else:
            for name, e in errs.items():
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
        del x, noise, flat, ragged
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 7
def _stage(kernel_name: str) -> str:
    """The sync-round stage a device kernel belongs to, by its name."""
    n = kernel_name.lower()
    if "clip_noise_kernel" in n:
        return "noise" if "true" in n else "clip"
    if "sq_norm" in n:
        return "clip"
    if "topk" in n:
        return "top-k"
    if "int8" in n:
        return "int8"
    if "normal" in n or "philox" in n:
        return "noise"
    return "delta/EF/aggregate"


def phase_training(smi):
    """Federated training of stablelm-1.6b at its published widths, then a
    kernel-vs-plain sync round from a copy of the trained state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training
    from repro_torch.utils.tree import tree_leaves, tree_unflatten

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clouds, batch, seq = 2, 8, 256
    walls = {"local": [], "sync": []}

    def step_fn(trainer, state, b, arrived, alphas):
        if "untimed_sync" not in trainer.__dict__:   # time the sync round on its own
            sync = trainer._sync

            def timed_sync(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = sync(*a)
                torch.cuda.synchronize()
                walls["sync"].append(time.perf_counter() - t)
                return out
            trainer.__dict__["untimed_sync"] = sync
            trainer._sync = timed_sync
        n_sync = len(walls["sync"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = trainer.train_step(state, b, arrived, alphas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        walls["local"].append(wall - (walls["sync"][-1] if len(walls["sync"]) > n_sync else 0))
        return out

    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_training("stablelm-1.6b", smoke=False, steps=4, seq_len=seq,
                       per_cloud_batch=batch, n_clouds=clouds, local_steps=2,
                       aggregation="fedavg", compression="topk+int8", topk_ratio=TOPK_RATIO,
                       dp_clip=DP_CLIP, dp_noise=DP_NOISE, log_every=1, device=DEVICE,
                       log_fn=lambda m: log(f"[train] {m}"), step_fn=step_fn)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [x for h in res["history"] for x in h["per_cloud_loss"]]
    check(len(res["history"]) == 4 and all(np.isfinite(losses)), f"non-finite losses: {losses}")
    check(all(launches[k] > 0 for k in CHANNEL), f"a channel kernel never launched: {launches}")
    tokens = clouds * batch * seq
    steady = walls["local"][1:]
    local = sum(steady) / len(steady)
    log(f"[train] {smi}: {res['params']:,} parameters, {clouds} clouds x "
        f"{res['trainer'].model.cfg.n_layers} layers, 4 steps (2 sync "
        f"rounds) in {total:.3f} s incl. init; local step walls (both clouds) "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls['local'])} ms, steady {local * 1e3:.1f} ms "
        f"= {tokens / local:.0f} tokens/s; sync round walls "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls['sync'])} ms; peak memory {peak:.2f} GB "
        f"(max_memory_allocated), {torch.cuda.memory_allocated() / 1e9:.2f} GB held after the "
        f"run; uplink {res['bytes_per_cloud_per_sync']:,} B per cloud per sync (wire model); "
        f"losses {losses}; launches {launches}")

    trainer, state = res["trainer"], res["state"]
    del res
    # the device idle share of one local step (cloud 0, one fresh batch)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    toks = torch.randint(0, trainer.model.cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    b0 = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cloud = state["clouds"][0]
    trainer._local_step(cloud, b0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer._local_step(cloud, b0)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._local_step(cloud, b0)
        torch.cuda.synchronize()
    ev = _kernel_rows(prof)
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:4]
    log(f"[train] {smi}: one local step (1 cloud, {batch} x {seq}) host wall {host_ms:.1f} ms, "
        f"device time {dev_ms:.1f} ms in {sum(e.count for e in ev)} kernel launches, device "
        f"idle share {max(0.0, 1 - dev_ms / host_ms):.3f}; top: " + "; ".join(
            f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms" for e in top))

    # one sync round from a copy of the trained state: kernels, plain, fault
    for c in state["clouds"]:
        c["opt"] = None                      # the sync reads no optimizer state
    torch.cuda.empty_cache()
    like = state["global"]["params"]
    def host(leaves):
        return [x.to("cpu", copy=True) for x in leaves]

    snap = {"clouds": [host(tree_leaves(c["params"])) for c in state["clouds"]],
            "ef": [host(tree_leaves(t)) for t in state["ef"]],
            "global": host(tree_leaves(like))}
    arrived = torch.ones(clouds, dtype=torch.bool, device=DEVICE)
    alphas = torch.full((clouds,), 0.5, device=DEVICE)

    def restore():
        for c, saved in zip(state["clouds"], snap["clouds"]):
            for p, s in zip(tree_leaves(c["params"]), saved):
                p.copy_(s)
        for t, saved in zip(state["ef"], snap["ef"]):
            for e, s in zip(tree_leaves(t), saved):
                e.copy_(s)
        state["global"]["params"] = tree_unflatten(like, [s.to(DEVICE) for s in snap["global"]])
        state["loss_accum"] = torch.zeros(clouds, device=DEVICE)
        state["rng"] = torch.Generator(device=DEVICE).manual_seed(NOISE_SEED)
        torch.cuda.synchronize()

    def sync_from_copy():
        restore()
        trainer.__dict__["untimed_sync"](state, arrived, alphas)
        torch.cuda.synchronize()
        return tree_leaves(state["global"]["params"])

    restore()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.__dict__["untimed_sync"](state, arrived, alphas)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
    got = host(tree_leaves(state["global"]["params"]))
    stages: dict[str, float] = {}
    for e in _kernel_rows(prof):
        stages[_stage(e.key)] = stages.get(_stage(e.key), 0.0) + e.self_device_time_total / 1e3
    log(f"[train] {smi}: profiled sync round wall {prof_wall:.1f} ms, device time "
        f"{sum(stages.values()):.2f} ms by stage: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(stages.items(), key=lambda x: -x[1])))

    def compare(what, faults=False):
        differ = total_n = beyond = 0
        worst = 0.0
        for a, b in zip(sync_from_copy(), got):
            b = b.to(DEVICE).float()
            d = (a.float() - b).abs()
            differ += int((d > 0).sum())
            beyond += int((d > 2.0**-7 * b.abs()).sum())
            total_n += d.numel()
            worst = max(worst, d.max().item())
        frac = differ / total_n
        sound = frac <= SYNC_DIFF_FRAC and beyond == 0
        if faults:
            expect(not sound, f"sync round: planted fault '{what}' not caught ({frac})")
        else:
            expect(sound, f"sync round kernels vs {what}: {differ} of {total_n} differ, "
                          f"{beyond} by more than one bf16 ulp")
        log(f"[train] sync round, new global params, kernels vs {what}: {differ} of {total_n} "
            f"differ (fraction {frac:.3e}, tol {SYNC_DIFF_FRAC:g}), {beyond} by more than one "
            f"bf16 ulp, max |diff| {worst:.3e}")

    with plain_channel():
        compare("plain versions")
    with plain_channel(topk_sparsify=_topk_short):
        compare("planted fault: top-k keeps k-1 per block", faults=True)
    del state, trainer, snap, got
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    smi = phase_device()
    import torch

    phase_build()
    rows = phase_kernels(smi)
    phase_golden()
    launches = phase_main_path(smi)
    rows.update(phase_channel_kernels(smi))
    train_launches = phase_training(smi)
    launches.update({k: train_launches[k] for k in CHANNEL})
    check(not FAILED, f"{len(FAILED)} numeric checks failed: {FAILED}")
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "wrapper_ms": r["wrapper_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
