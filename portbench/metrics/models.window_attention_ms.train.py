"""Device ms per step of the kernels that compute the windows' attention
(``F.scaled_dot_product_attention``'s forward and backward kernels, by
name), the recompute under remat included. None where the trace holds no
such kernel, or no ``medseg.swin.attention`` span (a program without the
span)."""

from portbench import readings, spans

ATTENTION_SPAN = "medseg.swin.attention"


def read(ctx):
    if ctx.kind != "train" or not spans.intervals(ctx.trace, ATTENTION_SPAN):
        return None
    seconds = ctx.trace.kernel_seconds(classes=("SDPA attention",))
    if seconds == 0:
        return None
    return 1e3 * readings.per_request(ctx, seconds)
