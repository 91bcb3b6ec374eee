"""Percent of the traced window (first step's start to last step's end) in
which no operation ran on the device."""

from portbench import readings


def read(ctx):
    return readings.idle_share(ctx, "train")
