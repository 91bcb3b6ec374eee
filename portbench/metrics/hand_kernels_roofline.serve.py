"""The bound time of the work the hand kernels carry in a volume (counted from
the configuration) over their device time in the trace, in percent."""

from portbench import readings


def read(ctx):
    return readings.roofline(ctx, "serve")
