"""Time each phase of two trees' ``chip_smoke.py`` on one card.

    python -m medseg_torch.tools.time_smoke_phases --parent .checkout/parent [--change .]

For the parent, then the change (one fresh process each, run from that
tree's root), it runs the tree's whole ``chip_smoke.main()`` with every
``phase_*`` function of the script wrapped in a wall clock, and prints one
line per tree: the seconds of each phase in the order they ran
(``phase_kernels`` under its label) and of the whole run. A phase that one
tree lacks shows only in the other's line. The processes' whole output goes
to ``chiprun_out/time_smoke_phases.log``. Needs a GPU; the parent is a
``git archive`` of the parent commit unpacked into an ignored directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PROGRAM = """
import functools, json, time
import chip_smoke as c
times = []
def wrap(name, fn):
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        label = f"{name}[{args[4]}]" if name == "phase_kernels" else name
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            times.append([label, round(time.perf_counter() - t0, 1)])
    return timed
for name in [n for n in dir(c) if n.startswith("phase_")]:
    setattr(c, name, wrap(name, getattr(c, name)))
t0 = time.perf_counter()
rc = c.main()
print("PHASE_TIMES " + json.dumps({"phases": times, "total_s": round(time.perf_counter() - t0, 1),
                                   "rc": rc}))
"""
MARK = "PHASE_TIMES "


def run(tree: str, label: str, log, timeout: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=tree, capture_output=True,
                          text=True, timeout=timeout)
    log.write(f"===== {label} ({tree}): exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s\n{proc.stdout}{proc.stderr}")
    log.flush()
    lines = [line for line in proc.stdout.splitlines() if line.startswith(MARK)]
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"{label}: chip_smoke failed (exit {proc.returncode})")
    result = json.loads(lines[-1][len(MARK):])
    print(f"[{label}] " + json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="root of the parent tree")
    p.add_argument("--change", default=".", help="root of the changed tree")
    p.add_argument("--timeout", type=int, default=1200, help="seconds for each process")
    args = p.parse_args(argv)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "time_smoke_phases.log"), "w") as log:
        for tree, label in ((args.parent, "parent"), (args.change, "change")):
            run(os.path.abspath(tree), label, log, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
