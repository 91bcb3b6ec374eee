"""A ``torch.profiler`` trace of a few whole requests, reduced to what the
per-layer metrics read.

``kernel_class`` (with its patterns) and the interval union of ``busy_us``
are copies of ``kernel_class`` and ``_busy_us`` in
``medseg_torch/tools/profile_serving.py`` as they stood when this benchmark
was written, kept here so that no change to the program moves the yardstick.
The trace is written as a Chrome trace under ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Callable

REQUEST_SPAN = "portbench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10

_CONV_MODE = {"0": "K1 conv3x3x3_of", "1": "K1 conv3x3x3_of", "2": "K5 conv3x3x3_of_cat2",
              "3": "K2 conv3x3x3_of_combine", "4": "K9 conv3x3x3_flat"}
_CONV_KERNEL = re.compile(r"conv3_kernel<[^,]+,\s*(?:\([^)]*\))?(\d)")
_CONV_TC_KERNEL = re.compile(r"conv_tc_(async_)?kernel<\s*(?:\((?:[^()]|\([^()]*\))*\))?(\d)")
_CLASSES = (  # (class, pattern on the kernel's name), first match wins
    ("K1 conv3x3x3_of, narrow tensor cores", re.compile(r"conv_narrow_kernel")),
    ("K6 conv3x3x3_wgrad_of, narrow tensor cores", re.compile(r"wgrad_narrow_kernel")),
    ("K6 conv3x3x3_wgrad_of, tensor cores", re.compile(r"wgrad_tc_(reduce_)?kernel")),
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


def busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def union(intervals) -> list[tuple[float, float]]:
    """The sorted, disjoint union of (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    """Events of a traced slice of ``requests`` whole requests; times in us
    on the trace's clock."""

    kernels: list[tuple[str, float, float]]  # (name, start, end)
    device_ops: list[tuple[str, float, float]]  # kernels, copies and sets
    host_ops: list[tuple[str, float, float]]
    requests: list[tuple[float, float]]

    @property
    def window(self) -> tuple[float, float]:
        """First request's start to last request's end."""
        return min(s for s, _ in self.requests), max(e for _, e in self.requests)

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e6

    def _clipped(self, events):
        lo, hi = self.window
        return [(max(s, lo), min(e, hi)) for _, s, e in events if e > lo and s < hi]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device, in the window."""
        return busy_us(self._clipped(self.device_ops)) / 1e6

    def kernel_seconds(self, pattern: re.Pattern | None = None, classes=None) -> float:
        """Summed device seconds of the window's kernels whose names match
        ``pattern`` or whose class is in ``classes``."""
        lo, hi = self.window
        total = 0.0
        for name, s, e in self.kernels:
            if e <= lo or s >= hi:
                continue
            if pattern is not None and not pattern.search(name):
                continue
            if classes is not None and kernel_class(name) not in classes:
                continue
            total += min(e, hi) - max(s, lo)
        return total / 1e6

    def kernel_count(self) -> int:
        lo, hi = self.window
        return sum(1 for _, s, e in self.kernels if e > lo and s < hi)

    def top_device_ops(self) -> list[list]:
        """The device operations that took most time, by name."""
        lo, hi = self.window
        by_name: dict[str, float] = {}
        for name, s, e in self.device_ops:
            if e > lo and s < hi:
                by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
        return [[name, sec] for name, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        """The longest gaps in which the device ran nothing, each named by
        the innermost host operation running at its middle."""
        lo, hi = self.window
        busy = union(self._clipped(self.device_ops))
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:TOP]:
            mid = 0.5 * (s + e)
            around = [(hs, name) for name, hs, he in self.host_ops if hs <= mid <= he]
            name = max(around)[1] if around else "host (outside any traced op)"
            out.append([name, (e - s) / 1e6])
        return out


def record(run: Callable[[Callable], None], requests: int, attempts: int = 3) -> Trace:
    """Profiles ``run(span)``, which must serve ``requests`` whole requests,
    each inside ``with span():``, and synchronize at its end."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def span():
        return record_function(REQUEST_SPAN)

    for _ in range(attempts):  # the profiler now and then returns a trace without device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(span)
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        trace = parse(events)
        if trace.kernels and len(trace.requests) == requests:
            return trace
    raise RuntimeError(f"the profiler recorded no device kernels or not {requests} requests")


def parse(events: list[dict]) -> Trace:
    kernels, device_ops, host_ops, requests = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"])
        t = (name, s, s + float(e["dur"]))
        if cat in DEVICE_CATS:
            device_ops.append(t)
            if cat == "kernel":
                kernels.append(t)
        elif cat == "user_annotation" and name == REQUEST_SPAN:
            requests.append((t[1], t[2]))
        elif cat in HOST_CATS:
            host_ops.append(t)
    return Trace(kernels, device_ops, host_ops, requests)
