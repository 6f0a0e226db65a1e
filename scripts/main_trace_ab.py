"""Phase 5 of ``chip_smoke.py`` from several checkouts in turn, one process
each, on one card: an A/B of the unsharded serving path.

Phase 5 serves stablelm-1.6b at its published widths (random weights, bf16)
over the fp-page trace: 8 cold prompts of 96-384 tokens, then 8 with a
shared 256-token prefix plus 32-64, 32 greedy tokens each, graphed and then
eager, with the decode step's profile after each. Each checkout builds its
kernels under its own ``build/`` and runs the phase with its own code.

    python3 scripts/main_trace_ab.py PARENT CHANGE CHANGE PARENT

Every CUDA-graph capture is timed (a device sync on either side): the
graphed engine's ``warm()`` captures each cold shape and the decode step,
and the timed trace then captures its suffix round at first use. Prints
each run's phase-5 log lines prefixed with the run's index and root, then
one line per run: the graphed trace's tok/s and TTFT p50, the graphed
decode step's device time, and the captures' walls. Exits non-zero if a
run fails."""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys

RUN = r"""
import sys
import time
sys.path.insert(0, ".")
import chip_smoke as cs
import torch
from repro_torch.launch import graphs

capture = graphs.GraphCache._capture


def timed_capture(self, fn, inputs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = capture(self, fn, inputs)
    torch.cuda.synchronize()
    print(f"[capture] {(time.perf_counter() - t0) * 1e3:.1f} ms, inputs "
          f"{[None if x is None else tuple(x.shape) for x in inputs]}", flush=True)
    return g


graphs.GraphCache._capture = timed_capture
smi = cs.phase_device()
cs.phase_build()
cs.phase_main_path(smi)
sys.exit(1 if cs.FAILED else 0)
"""

CAPTURE = re.compile(r"^\[capture\] ([\d.]+) ms")
TRACE = re.compile(r"^\[main\] .*?: 16 requests .*? ([\d.]+) tok/s, TTFT p50 ([\d.]+) ms")
STEP = re.compile(r"decode step host wall [\d.]+ ms, device time ([\d.]+) ms")


def main(roots: list[str]) -> int:
    if not roots:
        sys.exit(__doc__)
    summary, rc = [], 0
    for i, root in enumerate(roots):
        r = subprocess.run([sys.executable, "-c", RUN], cwd=pathlib.Path(root).resolve(),
                           capture_output=True, text=True, timeout=900)
        lines = (r.stdout + r.stderr).splitlines()
        for line in lines:
            print(f"run {i} {root}: {line}")
        tok_s = ttft = step = None
        captures = [float(m.group(1)) for m in map(CAPTURE.search, lines) if m]
        for line in lines:
            m = TRACE.search(line)
            if m and tok_s is None:
                tok_s, ttft = float(m.group(1)), float(m.group(2))
            m = STEP.search(line)
            if m and "profile" in line and step is None:
                step = float(m.group(1))
        summary.append(f"run {i} {root}: rc {r.returncode}, graphed {tok_s} tok/s, TTFT p50 "
                       f"{ttft} ms, decode step device {step} ms; captures, ms: warm() "
                       f"{sum(captures[:-1]):.1f} in {len(captures) - 1}, the timed trace's "
                       f"{captures[-1] if captures else None}")
        rc = rc or r.returncode
    print("\n".join(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
