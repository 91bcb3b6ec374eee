"""Device idle ms per step while the host is inside ``medseg.train.forward``
(the forward and the loss)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "train", "medseg.train.forward")
