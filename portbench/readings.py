"""What the per-layer metric readers read: one traced slice of whole requests
and the unprofiled window before it, and the arithmetic the readers share.

Each reader (``metrics/<name>.py``) returns a number, or None where its
cell has nothing for it to read; the harness leaves a None out of the line.
"""

from __future__ import annotations

import dataclasses
import re
from types import ModuleType

from portbench import work
from portbench.tracing import Trace

ELEMENTWISE_CLASSES = ("elementwise", "reduction", "layer norm")


@dataclasses.dataclass
class Context:
    kind: str  # "serve" or "train", the traffic's kind
    task: str
    model: dict  # the configuration's model group
    trace: Trace  # ``traced`` whole requests, profiled
    traced: int
    completed: int  # requests completed in the unprofiled window
    window_s: float  # its seconds
    items: int  # windows per volume, or crops per step
    families: dict  # kernels/<family>.json, by name
    peak_bytes: int  # the unprofiled window's peak of allocated device memory
    architecture: ModuleType | None = None  # architectures/<name>.py of the configuration


def per_request(ctx: Context, value: float) -> float:
    return value / ctx.traced


def launches(ctx: Context, kind: str):
    if ctx.kind != kind:
        return None
    return per_request(ctx, ctx.trace.kernel_count())


def mfu(ctx: Context, kind: str, passes: float):
    """Percent of the bf16 dense peak: ``passes`` x the forward's operations
    per item x items completed in the unprofiled window, over its seconds."""
    if ctx.kind != kind or ctx.completed == 0:
        return None
    flops = passes * work.forward_flops(ctx.architecture, ctx.model) * ctx.items * ctx.completed
    return 100.0 * flops / ctx.window_s / work.PEAK_FLOPS["bf16"]


def family_bound_s(ctx: Context, family: str) -> float:
    """The least seconds, per request, of the work that the kernel family
    ``family`` carries on this path, as the configuration's architecture
    lists it: its entries grouped by kernel call (a tap fused into a conv's
    call shares its input, read once), each call's bound the larger of its
    operations over the peak and its bytes over the bandwidth. 0 where the
    architecture gives the family no work here."""
    arch = ctx.architecture
    layers = work.layer_by_name(arch, ctx.model)
    calls: dict[str, list] = {}
    for entry in arch.kernel_work(family, ctx.kind, ctx.task):
        if "loss" in entry:
            flops, nbytes, op = work.loss_work(ctx.model, entry["loss"], ctx.task)
            call = calls.setdefault(f"loss.{entry['loss']}", [0.0, 0.0, 0.0, op])
            call[0] += flops * ctx.items
            call[1] += nbytes * ctx.items
            continue
        layer = layers[entry["layer"]]
        flops, act, wbytes, op = work.pass_work(layer, entry["pass"])
        if entry.get("shares_input_of"):
            act -= work.input_bytes(layer)
        call = calls.setdefault(entry.get("shares_input_of") or f"{layer.name}.{entry['pass']}",
                                [0.0, 0.0, 0.0, op])
        call[0] += flops * ctx.items
        call[1] += act * ctx.items
        call[2] += wbytes  # weights: at least once per request
    return sum(work.bound_s(f, a + w, op) for f, a, w, op in calls.values())


def family_pattern(family: dict) -> re.Pattern:
    return re.compile("|".join(f"(?:{p})" for p in family["patterns"]))


def roofline(ctx: Context, kind: str):
    """Percent: the bound time of the work the hand kernels carry over
    their device time, summed over the kernel families present in the trace
    (a family with no kernel in the trace is left out, work and time; one
    present with no work on this architecture counts its time, bound 0)."""
    if ctx.kind != kind:
        return None
    bound = device = 0.0
    for name, family in ctx.families.items():
        seconds = per_request(ctx, ctx.trace.kernel_seconds(family_pattern(family)))
        if seconds > 0:
            bound += family_bound_s(ctx, name)
            device += seconds
    if device == 0:
        return None
    return 100.0 * bound / device


def elementwise_ms(ctx: Context, kind: str):
    if ctx.kind != kind:
        return None
    return 1e3 * per_request(ctx, ctx.trace.kernel_seconds(classes=ELEMENTWISE_CLASSES))


def idle_share(ctx: Context, kind: str):
    if ctx.kind != kind:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def peak_gib(ctx: Context, kind: str):
    if ctx.kind != kind:
        return None
    return ctx.peak_bytes / 2**30
