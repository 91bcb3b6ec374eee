"""Where the serving path's time goes, on one NVIDIA GPU.

    python -m medseg_torch.tools.profile_serving    # from the repository root

Runs config 4 as ``chip_smoke.py`` does (UNETR-B/16, bf16, random weights
from seed 0; a 512x512x160 one-channel volume; 96^3 windows, overlap 0.5,
Gaussian blend: the z-row walk, K4, an fp32 accumulator) and measures,
after warm runs:

1. the fused forward on one batch of four windows: the CUDA-event time
   unprofiled, then ``torch.profiler`` over ``FORWARDS`` forwards: device
   time and launches per kernel class (and its costliest kernel names),
   busy time (the union of the kernel intervals) and the idle share of the
   traced span;
2. ``Validator.infer_volume``: ``VOLUMES`` unprofiled runs on the host clock,
   then one profiled run with the same breakdown.

Prints one line per measurement and writes all of it as JSON to
``chiprun_out/profile_serving.json`` under the repository root. The
profiler widens launch gaps, so the idle share of a traced span is an upper
bound; ``busy / unprofiled wall`` is the estimate without it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

FORWARDS = 5
VOLUMES = 3
TOP_NAMES = 4  # kernel names kept per class, by device time
OUT_DIR = Path(__file__).resolve().parents[2] / "chiprun_out"

_CONV_MODE = {"0": "K1 conv3x3x3_of", "1": "K1 conv3x3x3_of", "2": "K5 conv3x3x3_of_cat2",
              "3": "K2 conv3x3x3_of_combine", "4": "K9 conv3x3x3_flat"}
# the conv's template arguments begin with its input mode (conv_of.cu: after
# the dtype); conv_tc.cu's kernels are the same modes on the tensor cores
# (and mode 4, K9), ``conv_tc_async_kernel`` those with the asynchronous staging
_CONV_KERNEL = re.compile(r"conv3_kernel<[^,]+,\s*(?:\([^)]*\))?(\d)")
_CONV_TC_KERNEL = re.compile(r"conv_tc_(async_)?kernel<\s*(?:\((?:[^()]|\([^()]*\))*\))?(\d)")
_CLASSES = (  # (class, pattern on the kernel's name), first match wins
    # K6 on the tensor cores; its CUDA-core route keeps the plain names
    ("K6 conv3x3x3_wgrad_of, tensor cores", re.compile(r"wgrad_tc_(reduce_)?kernel")),
    # K3 and K4: outhead_tc.cu on the tensor cores, outhead_of.cu and
    # outhead_row_of.cu otherwise
    ("K3 outhead_of, tensor cores", re.compile(r"outhead_tc_kernel")),
    ("K4 outhead_row_of, tensor cores", re.compile(r"outhead_row_tc_kernel")),
    ("K3 outhead_of", re.compile(r"outhead_kernel")),
    ("K4 outhead_row_of", re.compile(r"outhead_row_kernel")),
    ("K6 conv3x3x3_wgrad_of", re.compile(r"wgrad_kernel|wgrad_reduce_kernel")),
    ("K7 dice_ce_sums", re.compile(r"dice_ce_sums_(finish_)?kernel")),
    ("K8 dice_ce_bwd", re.compile(r"dice_ce_bwd_kernel")),
    ("K9 conv3x3x3_flat", re.compile(r"conv_flat_kernel")),
    ("SDPA attention", re.compile(r"fmha|flash|attention", re.I)),
    ("elementwise", re.compile(r"elementwise_kernel")),
    ("reduction", re.compile(r"reduce_kernel")),
    ("layer norm", re.compile(r"layer_norm")),
    ("concat/copy", re.compile(r"CatArray|copy", re.I)),
    ("cuBLAS/cuDNN", re.compile(r"gemm|nvjet|cutlass|xmma|cudnn|conv|sm90_|sm80_", re.I)),
)


def kernel_class(name: str) -> str:
    m = _CONV_KERNEL.search(name)
    if m:
        return _CONV_MODE[m.group(1)]
    m = _CONV_TC_KERNEL.search(name)
    if m:
        return f"{_CONV_MODE[m.group(2)]}, tensor cores{', async' if m.group(1) else ''}"
    for cls, pattern in _CLASSES:
        if pattern.search(name):
            return cls
    return "other"


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile(fn, n: int, trace_path: Path) -> dict:
    """Runs ``fn`` ``n`` times under the profiler and breaks the device
    kernels down by class; times are per run, in ms."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    os.remove(trace_path)
    if not events:
        raise RuntimeError("the profiler recorded no device kernels")
    by_class: dict[str, dict] = {}
    for e in events:
        c = by_class.setdefault(kernel_class(e["name"]), {"ms": 0.0, "launches": 0, "top": {}})
        c["ms"] += e["dur"] / 1e3 / n
        c["launches"] += 1
        c["top"][e["name"]] = c["top"].get(e["name"], 0.0) + e["dur"] / 1e3 / n
    for c in by_class.values():
        c["launches"] /= n
        c["top"] = sorted(c["top"].items(), key=lambda kv: -kv[1])[:TOP_NAMES]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in events]
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _busy_us(intervals)
    return {
        "kernels_per_run": len(events) / n,
        "busy_ms": busy / 1e3 / n,
        "span_ms": span / 1e3 / n,
        "idle_share_traced": 1.0 - busy / span,
        "by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1]["ms"])),
    }


def _print_breakdown(label: str, p: dict) -> None:
    print(f"[{label}] {p['kernels_per_run']:.0f} kernels, busy {p['busy_ms']:.3f} ms in a traced "
          f"span of {p['span_ms']:.3f} ms (idle {100 * p['idle_share_traced']:.2f}%)", flush=True)
    for cls, c in p["by_class"].items():
        print(f"[{label}]   {c['ms']:10.3f} ms  {c['launches']:8.1f} launches  {cls}", flush=True)
        for name, ms in c["top"]:
            print(f"[{label}]       {ms:10.3f} ms  {name[:110]}", flush=True)


def main() -> None:
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.kernels import kernel_check
    from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights
    from medseg_torch.models.unetr import init_weights, unetr_b16
    from medseg_torch.ops.sliding_window import SlidingWindowSpec

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    device = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    model = init_weights(unetr_b16(1, 14, 96, dtype=torch.bfloat16), g).to(device).eval()
    x = torch.randn((4, 1, 96, 96, 96), generator=g).to(device)
    weights = fused_weights(model)

    def forward():
        return fast_apply_v3(model, x, weights)

    result = {"card": card, "forward": {}, "volume": {}}
    result["forward"]["ms"] = kernel_check.time_ms(forward, reps=10)
    print(f"[forward] unprofiled {result['forward']['ms']:.3f} ms per batch of 4 windows",
          flush=True)
    fwd = profile(forward, FORWARDS, OUT_DIR / "trace_forward.json")
    result["forward"].update(fwd)
    _print_breakdown("forward", fwd)

    spec = SlidingWindowSpec(roi=(96, 96, 96), overlap=0.5, sw_batch=4, mode="gaussian")
    validator = Validator(model, 14, "ct", spec, device=device)
    volume = np.random.default_rng(0).standard_normal((512, 512, 160, 1), dtype=np.float32)
    validator.infer_volume(volume)  # warm
    seconds = []
    for _ in range(VOLUMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        validator.infer_volume(volume)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    result["volume"]["seconds"] = seconds
    print(f"[volume] unprofiled s/volume {seconds}", flush=True)
    vol = profile(lambda: validator.infer_volume(volume), 1, OUT_DIR / "trace_volume.json")
    vol["busy_over_unprofiled_wall"] = vol["busy_ms"] / 1e3 / min(seconds)
    result["volume"].update(vol)
    _print_breakdown("volume", vol)
    print(f"[volume] busy / fastest unprofiled wall: {vol['busy_over_unprofiled_wall']:.4f}",
          flush=True)
    with open(OUT_DIR / "profile_serving.json", "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
