"""Percent of the program's model batches (``medseg.serve.forward`` spans)
that replayed a CUDA graph: those that hold a ``medseg.serve.replay`` span,
over all of them in the traced slice. None where the trace holds no replay
span (a program that issues every kernel from the host)."""

from portbench import spans


def read(ctx):
    if ctx.kind != "serve":
        return None
    replays = spans.intervals(ctx.trace, "medseg.serve.replay")
    forwards = spans.intervals(ctx.trace, "medseg.serve.forward")
    if not replays or not forwards:
        return None
    holding = sum(1 for s, e in forwards if any(s <= rs and re <= e for rs, re in replays))
    return 100.0 * holding / len(forwards)
