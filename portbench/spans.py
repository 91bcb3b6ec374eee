"""The program's own host spans in the traced slice, and what the span
metrics read from them.

``medseg_torch.utils.profiling.span`` records ``medseg.serve.*`` and
``medseg.train.*`` ranges inside each request while a profiler runs. The
trace keeps them, on the clock of the kernels and copies, among
``Trace.host_ops``. Each reader returns None where the trace holds no span
of its name (a program without the spans, or a path that bypasses one), so
that a missing span is left out of the line and never reads 0.
"""

from __future__ import annotations

from portbench.readings import Context, per_request
from portbench.tracing import Trace, busy_us


def intervals(trace: Trace, name: str) -> list[tuple[float, float]]:
    """The (start, end) of every host op called ``name``, clipped to the
    traced window."""
    lo, hi = trace.window
    return [(max(s, lo), min(e, hi)) for n, s, e in trace.host_ops
            if n == name and e > lo and s < hi]


def idle_us(trace: Trace, spans: list[tuple[float, float]]) -> float:
    """The measure of ``spans``'s union (inside the window) in which no
    operation ran on the device: that of the union of spans and device
    operations less that of the device operations."""
    lo, hi = trace.window
    device = [(max(s, lo), min(e, hi)) for _, s, e in trace.device_ops if e > lo and s < hi]
    inside = [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]
    return busy_us(inside + device) - busy_us(device)


def idle_ms(ctx: Context, kind: str, name: str):
    """Device idle ms per request while the host is inside ``name``."""
    spans = intervals(ctx.trace, name) if ctx.kind == kind else []
    if not spans:
        return None
    return 1e-3 * per_request(ctx, idle_us(ctx.trace, spans))


def duration_ms(ctx: Context, kind: str, name: str):
    """Summed ms of the ``name`` spans per request."""
    spans = intervals(ctx.trace, name) if ctx.kind == kind else []
    if not spans:
        return None
    return 1e-3 * per_request(ctx, sum(e - s for s, e in spans))


def mean_ms(ctx: Context, kind: str, name: str):
    """Summed ms of the ``name`` spans over their count."""
    spans = intervals(ctx.trace, name) if ctx.kind == kind else []
    if not spans:
        return None
    return 1e-3 * sum(e - s for s, e in spans) / len(spans)
