"""The 3x3x3 conv of the training step through the kernels (counterpart of
``medseg/kernels/conv3d.py``'s ``conv3x3x3_ofio`` custom VJP).

``Conv3x3x3Fn`` is a stride-1, zero-padded 3x3x3 conv without bias:

- forward: K1 (``conv_of.conv3x3x3_of``, no prologue), output in the compute
  dtype (its statistics are not used);
- backward: the data gradient is K1 again on the spatially flipped,
  io-transposed weight (exact for stride-1 zero-padded 3^3 convs), computed
  only when the input needs it; the filter gradient is K6
  (``conv_of.conv3x3x3_wgrad_of``, fp32), rounded to the weight's dtype.

``train_route`` is the shape predicate: the same on CPU (where the wrappers
run their plain versions) and on the card (where a width the kernels lack
raises). NCDHW needs no block-level layout trick, so the Function wraps each
conv.
"""

from __future__ import annotations

import torch

from medseg_torch.kernels import conv_of

OF_MIN_HW = 48 * 48  # smallest H*W routed to the kernels (the full-res and 48^3 stages)
MAX_C = 64  # widest input or output routed


def train_route(x_shape, c_out: int) -> bool:
    """Whether a 3x3x3 stride-1 conv of an (B, C, D, H, W) input to ``c_out``
    channels runs through ``Conv3x3x3Fn``."""
    _, c, _, h, w = x_shape
    return h * w >= OF_MIN_HW and c <= MAX_C and c_out <= MAX_C


class Conv3x3x3Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return conv_of.conv3x3x3_of(x, weight)[0]

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_flip = weight.flip(2, 3, 4).transpose(0, 1).contiguous()
            dx = conv_of.conv3x3x3_of(g, w_flip)[0]
        if ctx.needs_input_grad[1]:
            dw = conv_of.conv3x3x3_wgrad_of(x, g).to(weight.dtype)
        return dx, dw


def conv3x3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Same-pad 3x3x3 conv of x (B, C, D, H, W) with weight (CO, C, 3, 3, 3),
    both in the compute dtype; the output is in that dtype (fp32 sums, one
    rounding)."""
    return Conv3x3x3Fn.apply(x.contiguous(), weight.contiguous())
