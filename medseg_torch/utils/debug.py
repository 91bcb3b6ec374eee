"""Debug modes (counterpart of ``medseg/utils/debug.py``).

- ``nan_checks()``: a NaN that a module's forward produces raises at that
  module (a global forward hook checks every floating output), and autograd's
  anomaly mode (``check_nan``) raises at the backward function that makes
  one, naming the forward operation that created it;
- ``strict_mode()``: the same for infinities too.

Both restore the previous state on exit (anomaly mode, its ``check_nan``,
and the hooks). Each check reads a flag back from the device, so a step
under them waits on every module: a tool for a loss that blows up, not for a
timed run. ``check_finite`` checks a step's outputs (its loss) the same way.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn.modules.module import register_module_forward_hook


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def check_finite(where: str, value, *, infs: bool = False) -> None:
    """Raise ``FloatingPointError`` if a floating tensor of ``value`` (a
    tensor, or a list, tuple or dict of them) holds a NaN (with ``infs``,
    also an infinity)."""
    for t in _tensors(value):
        if not t.is_floating_point():
            continue
        if bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in {where}")
        if infs and bool(torch.isinf(t).any()):
            raise FloatingPointError(f"infinity in {where}")


@contextlib.contextmanager
def _checks(infs: bool):
    enabled, check_nan = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()

    def hook(module, inputs, output):
        check_finite(f"the output of {type(module).__name__}", output, infs=infs)

    handle = register_module_forward_hook(hook)
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        handle.remove()
        torch.autograd.set_detect_anomaly(enabled, check_nan=check_nan)


@contextlib.contextmanager
def nan_checks():
    """NaNs raise where a module's forward or a backward function makes them."""
    with _checks(infs=False):
        yield


@contextlib.contextmanager
def strict_mode():
    """``nan_checks``, and infinities in a module's output raise too."""
    with _checks(infs=True):
        yield
