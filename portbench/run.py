"""Run one cell of ``BENCHMARK.json`` on this machine's NVIDIA GPU.

    python3 portbench/run.py --workload btcv-serve-ct512 --seed 7 --seconds 40 --trace 0

Set-up (process start to the first timed request) loads the program, makes
the weights and inputs from ``--seed`` on the device and warms every shape
the cell uses; the window then runs the cell's traffic for ``--seconds``.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled slice of whole
requests after the window. Once the program is freed, the plain reference
judges what the window produced. The last line on standard output is one
JSON object; the numbers compared, each beside its limit, are the last lines
on standard error and the result's last key. Without a CUDA device (or with
fewer than the cell asks for) the run fails and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "medseg")  # top-level module names, compared whole
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda"}
CACHE_ROOT = ".portbench_cache"  # inside the checkout, at a fixed path


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``cell`` on ``device``: the result as the line carries it."""
    import torch

    from portbench import judge, manifest, serve, train

    kind = {"serve": serve, "train": train}[cell.traffic["kind"]]
    out = kind.run(cell, seed, seconds, trace, device, t0)
    times = out["request_s"]
    deciles = statistics.quantiles(times, n=10) if len(times) > 1 else times
    logging.getLogger("portbench").info(
        "%s seed %d: set-up %.3f s; %d requests (%d failed) in %.3f s of window, the first "
        "%.4f s, min %.4f, deciles %s, max %.4f; judged in %.3f s", cell.name, seed,
        out["setup_s"], out["attempted"], out["failed"], out["window_s"], times[0] if times else 0,
        min(times, default=0), [round(d, 4) for d in deciles], max(times, default=0),
        out["judge_s"])
    correct, checks = judge.checks(out["numbers"], cell.limits, out["failed"])
    device = torch.device(device)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(out["peak_bytes"])}
    breakdown = None
    if not trace:
        values = dict(out["metrics"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    else:
        ctx = out["context"]
        ctx.families = manifest.kernel_families(cell.folder)
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(cell.folder, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"] = ctx.trace.busy_s
        info["window_s"] = ctx.trace.window_s
        breakdown = {"device_ops": ctx.trace.top_device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks  # last: each number compared beside its limit
    return result


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / CACHE_ROOT / sub)
    sys.path.insert(0, str(ROOT))  # the checkout's root, where portbench and the program are
    logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="[portbench] %(message)s")
    import torch

    from portbench import manifest

    cell = manifest.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark measures medseg_torch alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = None  # JSON has no infinity: the check failed
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
