"""Time the CLI phases of two trees' ``chip_smoke.py`` on one card, in turns.

    python -m medseg_torch.tools.compare_cli_phases --parent .checkout/parent

For each of parent, change, change, parent (one fresh process each, run from
that tree's root) it runs the tree's ``chip_smoke.py`` phases device, build,
pretrain-cli (the pretraining CLI's steps/s), seg-cli (the segmentation CLI
on CT: train steps/s, seconds per validation volume, the final evaluation)
and seg-cli-mri (the BraTS step), and prints their result lines under the
tree's label. The same card and host serve all four runs, so the host
chain's numbers of the two trees compare within the call. The whole output
goes to ``chiprun_out/compare_cli_phases.log``. Needs a GPU; the parent is
a ``git archive`` of the parent commit unpacked into an ignored directory.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

PHASES = (
    "import chip_smoke as c\n"
    "device, card = c.phase_device()\n"
    "c.phase_build(card)\n"
    "c.phase_pretrain_cli(device, card)\n"
    "c.phase_seg_cli(device, card)\n"
    "c.phase_seg_cli_mri(device, card)\n"
)
SHOWN = ("[device]", "[build]", "[pretrain-cli] medseg_torch", "[seg-cli] medseg_torch",
         "[seg-cli] final", "[seg-cli-mri] medseg_torch")


def run(tree: str, label: str, log, timeout: int) -> None:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PHASES], cwd=tree, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    log.write(f"===== {label} ({tree}): exit {proc.returncode}, {seconds:.1f} s\n")
    log.write(proc.stdout + proc.stderr)
    log.flush()
    for line in proc.stdout.splitlines():
        if line.startswith(SHOWN):
            print(f"[{label}] {line[:900]}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"{label}: the phases failed (exit {proc.returncode})")
    print(f"[{label}] {seconds:.1f} s for the process", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="root of the parent tree")
    p.add_argument("--change", default=".", help="root of the changed tree")
    p.add_argument("--timeout", type=int, default=600, help="seconds for each process")
    args = p.parse_args(argv)
    os.makedirs("chiprun_out", exist_ok=True)
    order = [(args.parent, "parent"), (args.change, "change"), (args.change, "change"),
             (args.parent, "parent")]
    with open(os.path.join("chiprun_out", "compare_cli_phases.log"), "w") as log:
        for tree, label in order:
            run(tree, label, log, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
