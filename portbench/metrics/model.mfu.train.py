"""3 x the forward's operations per crop x crops completed in the unprofiled
window, over its seconds, as a percent of the H100's 989 TFLOP/s bf16 dense
peak; remat's recompute is not counted."""

from portbench import readings


def read(ctx):
    return readings.mfu(ctx, "train", passes=3.0)
