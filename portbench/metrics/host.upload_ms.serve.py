"""Host ms per volume inside ``medseg.serve.upload``: the pageable copy of
the volume to the device, its permute and its pad."""

from portbench import spans


def read(ctx):
    return spans.duration_ms(ctx, "serve", "medseg.serve.upload")
