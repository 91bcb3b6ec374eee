"""The unprofiled window's peak of allocated device memory
(torch.cuda.max_memory_allocated after reset_peak_memory_stats), in GiB."""

from portbench import readings


def read(ctx):
    return readings.peak_gib(ctx, "train")
