"""Device kernels in the traced slice per completed step."""

from portbench import readings


def read(ctx):
    return readings.launches(ctx, "train")
