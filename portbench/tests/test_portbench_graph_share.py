"""``host.graph_share.serve`` on made-up traces: the share of forward spans
that hold a replay span, and None without replay spans."""

from __future__ import annotations

import pytest

from portbench import manifest, readings, tracing
from portbench.tests.tiny import REPO


def read(ctx):
    return manifest.metric_reader(REPO / "portbench", "host.graph_share.serve")(ctx)


def context(kind: str, host) -> readings.Context:
    trace = tracing.Trace(kernels=[("k", 0.0, 10.0)], device_ops=[("k", 0.0, 10.0)],
                          host_ops=host, requests=[(0.0, 100.0), (100.0, 200.0)])
    return readings.Context(kind=kind, task="ct", model={}, trace=trace, traced=2,
                            completed=2, window_s=1.0, items=1, families={}, peak_bytes=0)


def forwards(*starts):
    return [("medseg.serve.forward", s, s + 10.0) for s in starts]


def test_share_of_forwards_holding_a_replay():
    host = forwards(10.0, 30.0, 110.0, 130.0) + [
        ("medseg.serve.capture", 31.0, 35.0),  # a capture is no replay
        ("medseg.serve.replay", 36.0, 38.0), ("medseg.serve.replay", 112.0, 113.0),
        ("medseg.serve.replay", 131.0, 132.0), ("medseg.serve.replay", 150.0, 151.0)]
    assert read(context("serve", host)) == pytest.approx(75.0)


def test_every_forward_replayed_reads_100():
    host = forwards(10.0, 110.0) + [("medseg.serve.replay", 12.0, 13.0),
                                    ("medseg.serve.replay", 111.0, 112.0)]
    assert read(context("serve", host)) == pytest.approx(100.0)


@pytest.mark.parametrize("kind,host", [
    ("serve", forwards(10.0, 110.0)),  # eager forwards only: the parent
    ("serve", [("medseg.serve.replay", 12.0, 13.0)]),  # no forward span
    ("train", forwards(10.0) + [("medseg.serve.replay", 12.0, 13.0)]),
])
def test_nothing_to_read_is_none(kind, host):
    assert read(context(kind, host)) is None
