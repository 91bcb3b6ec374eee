"""``test_portbench_reference.py``'s float32 comparisons, of every
configuration, run with oneDNN's convolutions off, on ATen's own.

Those tests hold three of the program's float32 training steps to
the reference's at 1e-5 in the loss and 1e-3 in each weight's gradient.
One decoder leaky-ReLU pre-activation that lies within float32 rounding of
0 and takes one sign in the program and the other in the reference fails
that: its voxel's gradient differs 100-fold (slope 1 against 0.01), which
moves every weight upstream by ~1e-3, and AdamW's first steps move each
element by about lr whatever its size. Either backend is float32-accurate
conv by conv (both read ~3e-7 from float64 forward, 1e-7 to 3e-6 in the
gradients), but where the flips fall changes with the backend and the
thread count. On oneDNN, seed 7, tiny CT UNETR read a gradient gap of
1.07e-3 at 2 threads, tiny Swin UNETR a loss gap of 4.4e-5 at 1 and 8
threads. On ATen's kernels every tiny configuration passed at 1, 2, 4 and
8 threads (loss gaps 6e-8 to 6.7e-6, gradient gaps 6e-7 to 5.1e-4; a flip
still shows in some, under the limits). The other tests here, and the
tier-1 tests at tolerances that hold a flip, keep the default backend."""

from __future__ import annotations

import pytest
import torch


COMPARISONS = "portbench.tests.test_portbench_reference"


@pytest.fixture(autouse=True)
def aten_convolutions(request):
    if request.module.__name__ != COMPARISONS:
        yield
        return
    with torch.backends.mkldnn.flags(enabled=False):
        yield
