"""The forward's operations per window (counted from the configuration) x
windows completed in the unprofiled window, over its seconds, as a percent
of the H100's 989 TFLOP/s bf16 dense peak."""

from portbench import readings


def read(ctx):
    return readings.mfu(ctx, "serve", passes=1.0)
