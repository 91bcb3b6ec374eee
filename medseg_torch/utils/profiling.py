"""Step timing and throughput counters (counterpart of ``StepTimer`` and
``Throughput`` in ``medseg/utils/profiling.py``)."""

from __future__ import annotations

import time

import numpy as np
import torch


class StepTimer:
    """Accumulates wall-clock seconds per timed block (the reference's
    running time). ``device``: a CUDA device is synchronized before the
    clock is read at each end, so a block's time includes the device work it
    queued; on the CPU nothing is queued."""

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = None if device is None else torch.device(device)
        self.times: list[float] = []
        self._t0: float | None = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def total(self) -> float:
        return float(np.sum(self.times)) if self.times else 0.0

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.times, q)) if self.times else 0.0


class Throughput:
    """items/sec over a sliding window (patches/sec, volumes/sec)."""

    def __init__(self, window: int = 50) -> None:
        self.window = window
        self._stamps: list[tuple[float, int]] = []

    def update(self, n_items: int) -> None:
        self._stamps.append((time.perf_counter(), n_items))
        if len(self._stamps) > self.window:
            self._stamps.pop(0)

    @property
    def rate(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1][0] - self._stamps[0][0]
        items = sum(n for _, n in self._stamps[1:])
        return items / dt if dt > 0 else 0.0
