"""The first timed phases of ``chip_smoke.py`` from several checkouts in
turn, one process each, on one card: an A/B of what runs beside them.

Each run does what the checkout's ``chip_smoke.py`` does up to and with its
kernel phases: the device, the kernels' build (with the dry run's table in
a process of its own beside it, and read after it, where the checkout has
the dry run), then 7g (the recurrent families' training, in a process of
its own) and the kernel phases 3, 3b-3g and 3w-3x/5w. Each checkout builds
its kernels under its own ``build/``.

    python3 scripts/early_phases_ab.py PARENT CHANGE CHANGE PARENT

Prints each run's log lines prefixed with the run's index and root, then
one line per run: its build and dry-run walls, 7g's phase wall and the
steady local-step walls of its two configs, the walls of phases 3d-3g and
3w-3x/5w, and each kernel row's device and wrapper ms. Exits non-zero if a
run fails."""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

RUN = r"""
import json
import sys
import time
sys.path.insert(0, ".")
import chip_smoke as cs

smi = cs.phase_device()
dry = cs.start_dryrun(cs.ROOT / "build" / "dryrun") if hasattr(cs, "start_dryrun") else None
cs.phase_build()
if dry is not None:
    t0 = time.perf_counter()
    cs.phase_dryrun(smi, dry)
    print(f"[ab] dry run wait after the build {time.perf_counter() - t0:.1f} s")
t0 = time.perf_counter()
cs.phase_training_recurrent_isolated()
print(f"[ab] 7g {time.perf_counter() - t0:.1f} s")
rows = cs.phase_kernels(smi)
rows.update(cs.phase_kernels_int8(smi))
rows.update(cs.phase_kernels_ring(smi))
for name in ("verify", "tp", "shapes", "hd256", "whisper"):
    t0 = time.perf_counter()
    getattr(cs, "phase_kernels_" + name)(smi)
    print(f"[ab] {name} {time.perf_counter() - t0:.1f} s")
print("[ab] rows " + json.dumps({k: [r["ms"], r["wrapper_ms"]] for k, r in rows.items()}))
sys.exit(1 if cs.FAILED else 0)
"""

AB = re.compile(r"^\[ab\] (\S+) ([\d.]+) s")
BUILD = re.compile(r"^\[build\] \d+ kernel libraries built in ([\d.]+) s")
DRY = re.compile(r"^\[dryrun\] 80 records .*? in ([\d.]+) s")
STEADY = re.compile(r"^\[train-recurrent\] (\S+) .*steady ([\d.]+) ms")


def main(roots: list[str]) -> int:
    if not roots:
        sys.exit(__doc__)
    summary, rc = [], 0
    for i, root in enumerate(roots):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", RUN], cwd=pathlib.Path(root).resolve(),
                           capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = (r.stdout + r.stderr).splitlines()
        for line in lines:
            print(f"run {i} {root}: {line}")
        walls, rows = {}, {}
        for line in lines:
            for pat, key in ((BUILD, "build"), (DRY, "dry run")):
                m = pat.search(line)
                if m:
                    walls[key] = float(m.group(1))
            m = AB.search(line)
            if m:
                walls[m.group(1)] = float(m.group(2))
            m = STEADY.search(line)
            if m:
                walls[f"{m.group(1)} steady ms"] = float(m.group(2))
            if line.startswith("[ab] rows "):
                rows = json.loads(line[len("[ab] rows "):])
        summary.append(f"run {i} {root}: rc {r.returncode}, {wall:.1f} s; walls {walls}; "
                       f"rows (ms, wrapper ms) {rows}")
        rc = rc or r.returncode
    print("\n".join(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
