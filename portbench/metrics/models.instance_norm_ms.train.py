"""Device ms per step of the instance-norm kernels of the conv blocks
(``instnorm_*_kernel``, by name: the norm with its leaky ReLU and residual
add, forward, remat's recompute and backward). With
``models.elementwise_ms.train`` it gives the models layer's device time.
None where the trace holds no such kernel (a program that runs the norm as
PyTorch operations)."""

import re

from portbench import readings

NORM_KERNELS = re.compile(r"instnorm_\w+_kernel")


def read(ctx):
    if ctx.kind != "train":
        return None
    seconds = ctx.trace.kernel_seconds(NORM_KERNELS)
    if seconds == 0:
        return None
    return 1e3 * readings.per_request(ctx, seconds)
