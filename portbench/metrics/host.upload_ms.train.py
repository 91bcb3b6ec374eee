"""Host ms per step inside ``medseg.train.upload``: the pageable copies of
the batch's images and labels to the device, and the CT labels' cast."""

from portbench import spans


def read(ctx):
    return spans.duration_ms(ctx, "train", "medseg.train.upload")
