"""Device kernels in the traced slice per completed volume."""

from portbench import readings


def read(ctx):
    return readings.launches(ctx, "serve")
