"""Device clocks and memory readings that also run on the CPU, where the
tests drive a run with the chip check skipped (nothing is queued there and
no peak is read)."""

from __future__ import annotations

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
