"""The host's ms to issue one model batch: the summed duration of the
program's ``medseg.serve.forward`` spans over their count in the trace."""

from portbench import spans


def read(ctx):
    return spans.mean_ms(ctx, "serve", "medseg.serve.forward")
