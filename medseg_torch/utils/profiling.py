"""Throughput counters (counterpart of ``Throughput`` in
``medseg/utils/profiling.py``)."""

from __future__ import annotations

import time


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
