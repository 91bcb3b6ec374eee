"""Step timing, throughput counters and profiler capture (counterpart of
``medseg/utils/profiling.py``): ``StepTimer``, ``Throughput``,
``trace(log_dir)``, a ``torch.profiler`` capture of the host and, where a
card is present, the device, and ``span(name)``, the named host ranges that
such a capture holds inside the program's requests.

The spans, recorded only while a profiler runs (``trace`` or any other
``torch.profiler.profile``), each a ``user_annotation`` on the profiler's
clock inside the caller's own ranges:

- ``medseg.serve.upload``: a volume to the device, permuted and padded
  (``ops.sliding_window.pad_volume``), once a volume;
- ``medseg.serve.walk``: the window walk, accumulator to last add
  (``ops.sliding_window._walk_batches``, ``ops.swi_zrow._walk_d_starts``),
  once a volume;
- ``medseg.serve.forward``: one model batch's forward inside the walk;
- ``medseg.serve.replay``: inside a forward on the card, the replay of the
  batch shape's CUDA graph (``kernels.unetr_of.GraphedForward``), once a
  replayed batch;
- ``medseg.serve.capture``: inside a forward on the card, the capture of
  that graph, once a batch shape (a shape's second batch);
- ``medseg.train.upload``: a batch to the device, CT labels cast to int32;
- ``medseg.train.forward``: the forward and the loss;
- ``medseg.train.backward``: ``zero_grad`` and ``loss.backward()``;
- ``medseg.train.optimizer``: ``apply_gradients`` (AdamW's step);

the last four once a ``make_train_step`` step. Inside a
``models.swin_unetr.SwinUNETR``'s forward:

- ``medseg.swin.encoder``: the Swin encoder's forward (patch embedding,
  the four stages, the five taps), once a forward;
- ``medseg.swin.attention``: one block's window-attention part (norm, pad,
  roll, partition, attention, reverse, crop), once a block a forward (8 at
  depths 2/2/2/2), and again in each recompute under remat.

Inside every ``models.blocks.InstanceNorm``'s forward (the conv blocks of
UNETR and Swin UNETR, on every path that runs them as modules):

- ``medseg.norm``: one instance norm with its leaky ReLU and residual add
  (``kernels.norm_of.instance_norm``), once a norm a forward, and again in
  each recompute under remat; on a CUDA tensor it holds one forward
  launch of the N1 kernels (``instnorm_fwd_*_kernel``).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the CUDA kernels where a card is present) into ``log_dir`` as a Chrome
    trace (``<host>_<pid>.<time>.pt.trace.json``), which TensorBoard's
    profiler plugin and Perfetto open; the trace holds the ``span`` ranges
    of the module docstring. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    runs; otherwise one shared null context, which costs a flag check."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN
