"""Device idle ms per volume while the host is inside the program's window
walk (``medseg.serve.walk``: the gathers of windows and weights, the
forward batches' dispatch and the adds, from the accumulator to the last
batch)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "serve", "medseg.serve.walk")
