"""The readings that a cell's correctness limits are set from, in one process.

    python3 portbench/calibrate.py --workload btcv-train-4x96 --seeds 1-12 \
        --control-seeds 101-103 [--out readings.jsonl]

- Program: each seed runs the cell's timed path as a run does, with a window
  of no time: a serve cell serves every pool volume twice, a train cell
  makes its checked steps; the judge's numbers are its readings.
- Control: the reference put in the program's place and computed in fp8
  (every matmul and conv operand, ``reference/precision.py``), the precision
  below the configuration's bf16: a serve cell serves the label maps of its
  fp8 logits, a train cell makes the checked steps in fp8; each is judged
  against the float32 reference as the program is.
- Faults (train cells): half of each batch left out, the loss a mean over
  the rest, in the reference put in the program's place. A state left
  unchanged reads 1 on ``change_gap`` by definition and needs no run.

Prints one JSON line per reading and writes them to ``--out``; needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def program_reading(cell, seed: int, device) -> dict:
    from portbench import serve, train

    kind = {"serve": serve, "train": train}[cell.traffic["kind"]]
    extra = 2 * cell.traffic["pool"] if cell.traffic["kind"] == "serve" else 0
    out = kind.run(cell, seed, 0.0, False, device, time.perf_counter(), min_requests=extra)
    return dict(out["numbers"], failed=out["failed"], judge_s=out["judge_s"])


def serve_control(cell, seed: int, device) -> dict:
    """The fp8 reference's label maps of the pool, judged as the program's."""
    import torch

    from portbench import inputs, judge
    from portbench.params import make_weights

    judge.reference_precision()
    config, arch = cell.config, cell.architecture
    weights = make_weights(arch, config["model"], seed, device)
    pool = inputs.serve_pool(config, cell.traffic, seed, device)
    worst = 0.0
    for volume in pool:
        answer = judge.label_map(
            judge.reference_logits(arch, weights, config, volume, device, "fp8"),
            config["task"]).cpu()
        ref = judge.reference_logits(arch, weights, config, volume, device)
        worst = max(worst, judge.serve_gap(ref, answer, config["task"]))
        del ref
        torch.cuda.empty_cache()
    return {"gap_max": worst}


def train_reference_reading(cell, seed: int, device, precision: str = "fp32",
                            rows: int | None = None) -> dict:
    """The reference put in the program's place (``precision``, ``rows``),
    judged against the float32 reference on the checked steps."""
    from portbench import inputs, judge
    from portbench.params import make_weights

    judge.reference_precision()
    config, traffic, arch = cell.config, cell.traffic, cell.architecture
    batches = inputs.train_pool(config, traffic, seed, device)[:traffic["checked_steps"]]
    weights0 = make_weights(arch, config["model"], seed, device)
    ref = judge.reference_steps(arch, weights0, config, batches, device)
    got = judge.reference_steps(arch, weights0, config, batches, device, precision, rows)
    return judge.train_numbers(got, ref)


def control_reading(cell, seed: int, device) -> dict:
    if cell.traffic["kind"] == "serve":
        return serve_control(cell, seed, device)
    return train_reference_reading(cell, seed, device, precision="fp8")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import manifest

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = manifest.load(ROOT, args.workload)
    rows = cell.traffic.get("crops_per_step", 0) // 2
    jobs = ([("program", s, lambda s: program_reading(cell, s, device)) for s in args.seeds]
            + [("control", s, lambda s: control_reading(cell, s, device))
               for s in args.control_seeds]
            + [("half_batch", s, lambda s: train_reference_reading(cell, s, device, rows=rows))
               for s in args.fault_seeds])
    lines = []
    for kind, seed, job in jobs:
        t = time.perf_counter()
        reading = job(seed)
        line = {"workload": cell.name, "kind": kind, "seed": seed,
                "seconds": time.perf_counter() - t, **reading,
                "card": torch.cuda.get_device_name(device)}
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    for name in cell.limits["numbers"]:
        by_kind = {}
        for line in lines:
            if math.isfinite(line.get(name, math.nan)):
                by_kind.setdefault(line["kind"], []).append(line[name])
        summary = {k: (min(v), max(v)) for k, v in by_kind.items()}
        print(f"[calibrate] {cell.name} {name}: (min, max) by kind {summary}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
