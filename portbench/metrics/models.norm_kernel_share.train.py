"""Percent of the instance norms applied in the traced steps that ran on the
hand kernels: the norm kernels' forward launches (one
``instnorm_fwd_*_kernel`` an application, by name) over the
``medseg.norm`` spans (one a ``models.blocks.InstanceNorm`` forward,
remat's recompute included), times 100. None where the trace holds no such
span (a program without it)."""

import re

from portbench import spans

FORWARD_KERNEL = re.compile(r"instnorm_fwd_\w+_kernel")


def read(ctx):
    if ctx.kind != "train":
        return None
    norms = spans.intervals(ctx.trace, "medseg.norm")
    if not norms:
        return None
    lo, hi = ctx.trace.window
    launched = sum(1 for name, s, e in ctx.trace.kernels
                   if FORWARD_KERNEL.search(name) and e > lo and s < hi)
    return 100.0 * launched / len(norms)
