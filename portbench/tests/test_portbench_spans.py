"""The span readers (``portbench/spans.py`` and its seven metrics) on
made-up traces: idle inside a span, the train phases' idle adding up to
the window's, a ratio over the spans' own count, and None without spans."""

from __future__ import annotations

import pytest

from portbench import manifest, readings, spans, tracing
from portbench.tests.tiny import REPO

SERVE = ("host.walk_idle_ms.serve", "host.forward_ms.serve", "host.upload_ms.serve")
TRAIN = ("host.upload_ms.train", "host.forward_idle_ms.train", "host.backward_idle_ms.train",
         "host.optimizer_idle_ms.train")
PHASES = ("medseg.train.upload", "medseg.train.forward", "medseg.train.backward",
          "medseg.train.optimizer")


def read(name: str, ctx):
    return manifest.metric_reader(REPO / "portbench", name)(ctx)


def context(kind: str, trace: tracing.Trace, traced: int) -> readings.Context:
    return readings.Context(kind=kind, task="ct", model={}, trace=trace, traced=traced,
                            completed=traced, window_s=1.0, items=1, families={},
                            peak_bytes=0)


def serve_trace() -> tracing.Trace:
    """Two requests over 0-200 us; the walks begin before the window and end
    after it; device ops straddle the window's start and a walk's start."""
    device = [("Memcpy HtoD (Pageable -> Device)", -10.0, 20.0), ("k", 30.0, 50.0),
              ("k", 90.0, 120.0)]
    host = [("medseg.serve.upload", -8.0, -5.0), ("medseg.serve.walk", -5.0, 60.0),
            ("medseg.serve.forward", 10.0, 14.0), ("medseg.serve.forward", 40.0, 46.0),
            ("medseg.serve.upload", 100.0, 110.0), ("medseg.serve.walk", 110.0, 210.0),
            ("medseg.serve.forward", 150.0, 158.0),
            ("medseg.serve.walker", 0.0, 200.0), ("aten::copy_", 60.0, 110.0)]
    return tracing.Trace(kernels=device[1:], device_ops=device, host_ops=host,
                         requests=[(0.0, 100.0), (100.0, 200.0)])


def test_idle_in_a_span_counts_only_the_gaps_inside_it():
    tr = serve_trace()
    walks = spans.intervals(tr, "medseg.serve.walk")
    assert walks == [(0.0, 60.0), (110.0, 200.0)]  # clipped to the window
    # inside 0-60 and 110-200 (150 us) the device runs 0-20, 30-50 and 110-120
    assert spans.idle_us(tr, walks) == pytest.approx(100.0)
    ctx = context("serve", tr, traced=2)
    assert read("host.walk_idle_ms.serve", ctx) == pytest.approx(0.050)  # 100 us / 2 volumes
    assert read("host.upload_ms.serve", ctx) == pytest.approx(0.005)  # 10 us in the window


def test_forward_ms_is_duration_over_the_spans_count():
    ctx = context("serve", serve_trace(), traced=2)
    assert read("host.forward_ms.serve", ctx) == pytest.approx(0.006)  # (4 + 6 + 8) / 3 us


def train_trace() -> tracing.Trace:
    """Two steps over 0-200 us, each upload, forward, backward and optimizer
    with host time between them; device ops inside, across and outside the
    spans."""
    host, device = [], []
    for base in (0.0, 100.0):
        for k, phase in enumerate(PHASES):
            host.append((phase, base + 5 + 20 * k, base + 20 + 20 * k))
        device += [("Memcpy HtoD (Pageable -> Device)", base + 8, base + 12),
                   ("k", base + 18, base + 30), ("k", base + 50, base + 63),
                   ("k", base + 70, base + 95)]
    host.append(("aten::copy_", 80.0, 120.0))
    kernels = [d for d in device if d[0] == "k"]
    return tracing.Trace(kernels=kernels, device_ops=device, host_ops=host,
                         requests=[(0.0, 100.0), (100.0, 200.0)])


def test_train_phases_and_the_idle_outside_them_add_up_to_the_window_idle():
    tr = train_trace()
    inside = tracing.union(iv for phase in PHASES for iv in spans.intervals(tr, phase))
    lo, hi = tr.window
    edges = [lo] + [t for iv in inside for t in iv] + [hi]
    outside = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
               if edges[i + 1] > edges[i]]
    ctx = context("train", tr, traced=2)
    phases_ms = [read(name, ctx) for name in TRAIN[1:]]
    upload_idle_ms = 1e-3 * spans.idle_us(tr, spans.intervals(tr, PHASES[0])) / 2
    outside_ms = 1e-3 * spans.idle_us(tr, outside) / 2
    total_ms = 1e3 * (1 - tr.busy_s / tr.window_s) * tr.window_s / 2
    assert sum(phases_ms) + upload_idle_ms + outside_ms == pytest.approx(total_ms)
    # per step: upload 5-20 idle 5-8, 12-18; forward 25-40 idle 30-40; backward 45-60
    # idle 45-50; optimizer 65-80 idle 65-70
    assert upload_idle_ms == pytest.approx(0.009)
    assert phases_ms == pytest.approx([0.010, 0.005, 0.005])
    assert read("host.upload_ms.train", ctx) == pytest.approx(0.015)


@pytest.mark.parametrize("kind,names", [("serve", SERVE), ("train", TRAIN)])
def test_no_span_in_the_trace_reads_none(kind, names):
    bare = tracing.Trace(kernels=[("k", 10.0, 20.0)], device_ops=[("k", 10.0, 20.0)],
                         host_ops=[("aten::copy_", 0.0, 10.0)], requests=[(0.0, 100.0)])
    other = serve_trace() if kind == "train" else train_trace()  # the other kind's spans
    for trace in (bare, other):
        ctx = context(kind, trace, traced=1)
        assert [read(name, ctx) for name in names] == [None] * len(names)
    mismatched = context("train" if kind == "serve" else "serve",
                         serve_trace() if kind == "serve" else train_trace(), traced=2)
    assert [read(name, mismatched) for name in names] == [None] * len(names)
