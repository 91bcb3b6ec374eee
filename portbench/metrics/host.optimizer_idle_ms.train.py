"""Device idle ms per step while the host is inside ``medseg.train.optimizer``
(the zero-gradient fill and AdamW's step)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "train", "medseg.train.optimizer")
