"""Device idle ms per step while the host is inside ``medseg.train.backward``
(``zero_grad`` and ``loss.backward()``, remat's recompute included)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "train", "medseg.train.backward")
