"""Percent: the bound time of a step's window attention over the device
time of the kernels that compute it (``models.window_attention_ms.train``'s
kernels). The work is the architecture's ``window_attention_work``: QK^T and
AV of every window and head, the backward at twice the forward's operations,
the forward counted as often a step as the trace holds
``medseg.swin.attention`` spans per block (twice under remat's recompute);
bytes of q, k, v, o, the bias with the shift mask, and their gradients, each
once a call. Each call's bound is the larger of its operations over the bf16
peak and its bytes over the HBM bandwidth. None where the architecture has
no window attention or the trace no such span or kernel."""

from portbench import readings, spans, work

ATTENTION_SPAN = "medseg.swin.attention"


def read(ctx):
    arch = ctx.architecture
    if ctx.kind != "train" or not hasattr(arch, "window_attention_work"):
        return None
    calls = spans.intervals(ctx.trace, ATTENTION_SPAN)
    seconds = ctx.trace.kernel_seconds(classes=("SDPA attention",))
    if not calls or seconds == 0:
        return None
    blocks = sum(s["depth"] for s in arch.stages(ctx.model))
    forwards = round(len(calls) / ctx.traced / blocks)
    bound = sum(work.bound_s(flops, nbytes, "bf16")
                for flops, nbytes in arch.window_attention_work(ctx.model, ctx.items, forwards))
    return 100.0 * bound / readings.per_request(ctx, seconds)
