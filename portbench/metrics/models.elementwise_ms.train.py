"""Device ms per step of the elementwise, reduction and layer-norm kernel
classes (the norms, activations and glue outside the hand kernels)."""

from portbench import readings


def read(ctx):
    return readings.elementwise_ms(ctx, "train")
