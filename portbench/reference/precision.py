"""The operand rounding of the reference: none in float32, fp8 for the control.

The configurations state bfloat16 compute; the nearest precision below it is
fp8. ``round_operand`` is applied to both operands of every matmul and conv
of the reference. In ``"fp8"`` it scales each tensor by its absolute maximum
onto the e4m3 range, rounds to ``torch.float8_e4m3fn`` and back, and in the
backward pass rounds the incoming gradient the same way onto e5m2 (the usual
fp8 training recipe: e4m3 forward, e5m2 gradients, one scale per tensor).
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "fp8")
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, _E5M2_MAX)


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision == "fp8":
        return _RoundFp8.apply(x)
    raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
