"""The 3x3x3 convs of the training step through the kernels (counterpart of
``medseg/kernels/conv3d.py``'s ``conv3x3x3_ofio`` and ``conv3x3x3`` custom
VJPs).

``Conv3x3x3Fn`` is a stride-1, zero-padded 3x3x3 conv without bias:

- forward: K1 (``conv_of.conv3x3x3_of``, no prologue), output in the compute
  dtype (its statistics are not used);
- backward: the data gradient is K1 again on the spatially flipped,
  io-transposed weight (exact for stride-1 zero-padded 3^3 convs), computed
  only when the input needs it; the filter gradient is K6
  (``conv_of.conv3x3x3_wgrad_of``, fp32), rounded to the weight's dtype.

``train_route`` is its predicate, on the shape, the dtype and the device: the
JAX route's terms (H*W, the widths up to 64), and on a CUDA device the
widths of every kernel the forward and backward launch (``conv_of``'s width
table: K1 at C_in -> C_out, K1's data gradient at C_out -> C_in where the
input needs a gradient, K6), so that a width the kernels lack goes to the
library conv instead of raising. On the CPU the wrappers run their plain
versions, which take every width. NCDHW needs no block-level layout trick,
so the Function wraps each conv.

``FlatConvFn`` is the flat per-conv route, taken by the convs that
``train_route`` declines where ``flat_route`` accepts them (off unless
``MEDSEG_PALLAS_CONV=1``, as in the JAX package):

- forward: K9 (``conv_flat.conv3x3x3_flat``), output fp32;
- backward: what the JAX route's backward computes in XLA, outside any
  kernel: the fp32 conv's gradients on fp32 casts of x and the weight
  (library convs here), cast back to the operands' dtypes.
"""

from __future__ import annotations

import os

import torch

from medseg_torch.kernels import conv_flat, conv_of

OF_MIN_HW = 48 * 48  # smallest H*W routed to the kernels (the full-res and 48^3 stages)
MAX_C = 64  # widest input or output routed
# the flat per-conv route, read once from the JAX package's variable (default
# off); tests set the module constant
PALLAS_PER_CONV = os.environ.get("MEDSEG_PALLAS_CONV", "0") == "1"
LANE = 128  # the TPU lane width, in which the JAX predicate is written
FLAT_MIN_W = 48  # narrowest W the flat route takes (the JAX predicate's)


def _of_terms(x_shape, c_out: int) -> bool:
    """The JAX route's terms that the port keeps (``_of_ok`` without its TPU
    layout conditions)."""
    _, c, _, h, w = x_shape
    return h * w >= OF_MIN_HW and c <= MAX_C and c_out <= MAX_C


def train_route(x_shape, c_out: int, dtype: torch.dtype = torch.float32, *,
                input_grad: bool = True, device="cpu") -> bool:
    """Whether a 3x3x3 stride-1 conv of an (B, C, D, H, W) input to ``c_out``
    channels in ``dtype`` on ``device`` runs through ``Conv3x3x3Fn``;
    ``input_grad``: whether the input needs a gradient (K1's data gradient
    runs only then)."""
    if not _of_terms(x_shape, c_out):
        return False
    if torch.device(device).type != "cuda":
        return True
    c = x_shape[1]
    return (conv_of.conv_has_kernel("plain", c, c_out, dtype)
            and (not input_grad or conv_of.conv_has_kernel("plain", c_out, c, dtype))
            and conv_of.wgrad_has_kernel(c, c_out, dtype))


def _wp(w: int) -> int:
    """Lanes per y-row of the JAX kernel's flat layout (its VMEM budget and
    lane occupancy are written in them)."""
    if w + 2 <= 64:
        return 64
    return -(-(w + 2) // LANE) * LANE


def flat_supported(x_shape, c_out: int) -> bool:
    """The JAX package's ``flat_supported`` on an NCDHW shape, its terms
    kept (widths, W >= 48, a channel-reducing conv or a square one at high
    lane occupancy, the 64 MiB VMEM budget), so that one setting routes the
    same convs in both packages."""
    _, c, _, h, w = x_shape
    if c % 8 != 0 or c > 128 or c_out > 128 or c_out % 8 != 0:
        return False
    if w < FLAT_MIN_W:
        return False
    wp = _wp(w)
    occupancy = (w + 2) / wp
    if not (c > c_out or (c == c_out and occupancy >= 0.7)):
        return False
    lanes = (h + 2) * wp
    row_bytes = c * lanes * 2
    patch_bytes = 9 * c * h * wp * 2
    out_bytes = 3 * c_out * h * wp * 4
    return row_bytes * 6 + patch_bytes + out_bytes < 64 * 1024 * 1024


def flat_route(x_shape, c_out: int, *, device="cpu") -> bool:
    """Whether a 3x3x3 conv on ``device`` runs through ``FlatConvFn``: the
    route is on, the shape is one the JAX flat kernel takes, and the JAX
    route's terms of ``train_route`` decline it (``flat_supported and not
    _of_ok`` in the JAX package: a conv that ``train_route`` declines only
    for a width the kernels lack goes to the library conv, not here); on a
    CUDA device, K9 also has the widths."""
    if not (PALLAS_PER_CONV and flat_supported(x_shape, c_out) and not _of_terms(x_shape, c_out)):
        return False
    return torch.device(device).type != "cuda" or conv_flat.has_kernel(x_shape[1], c_out)


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


class FlatConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return conv_flat.conv3x3x3_flat(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(x.shape, weight.float(), g, padding=1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(x.float(), weight.shape, g, padding=1)
            dw = dw.to(weight.dtype)
        return dx, dw


def conv3x3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Same-pad 3x3x3 conv of x (B, C, D, H, W) with weight (CO, C, 3, 3, 3),
    both in the compute dtype; the output is in that dtype (fp32 sums, one
    rounding)."""
    return Conv3x3x3Fn.apply(x.contiguous(), weight.contiguous())


def conv3x3x3_flat(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The same conv through ``FlatConvFn``: output fp32."""
    return FlatConvFn.apply(x.contiguous(), weight.contiguous())
