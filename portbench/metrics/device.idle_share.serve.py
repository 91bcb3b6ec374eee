"""Percent of the traced window (first volume's start to last volume's end) in
which no operation ran on the device."""

from portbench import readings


def read(ctx):
    return readings.idle_share(ctx, "serve")
