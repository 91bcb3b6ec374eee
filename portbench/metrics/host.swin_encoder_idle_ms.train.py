"""Device idle ms per step while the host is inside ``medseg.swin.encoder``
(the Swin encoder's forward: patch embedding, the four stages' window
attention, MLPs and mergings, the five taps). None without that span (an
architecture with no Swin encoder, or a program without the span)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "train", "medseg.swin.encoder")
