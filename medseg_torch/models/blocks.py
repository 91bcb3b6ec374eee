"""UNETR convolutional building blocks, NCDHW ``nn.Module``s.

Counterpart of ``medseg/models/blocks.py``, with the same behaviour
contracts (MONAI 0.6.0 ``UnetResBlock``, ``UnetBasicBlock``,
``UnetrBasicBlock``, ``UnetrPrUpBlock``, ``UnetrUpBlock``, ``UnetOutBlock``).
Submodule names follow MONAI's, so ``state_dict`` keys are those of the
reference checkpoints (``encoder1.layer.conv1.conv.weight``, ...) that
``medseg.engine.checkpoint.convert_torch_state_dict`` parses. Every conv has
a bias, as the flax blocks do, so the parameter sets are identical.

Each block takes a compute ``dtype`` as the flax blocks do: parameters stay
fp32, each layer casts its operands (and its bias) to ``dtype`` (None: the
promoted type of input and parameters), norms compute fp32 statistics and
return their input's dtype. ``InstanceNorm`` takes the leaky ReLU and the
residual add that follow it (``kernels.norm_of.instance_norm``: on the CPU
PyTorch operations, the norm, its cast, the add and the activation in that
order; on a CUDA tensor the N1 kernels), inside a ``medseg.norm`` span. With gradients enabled, a 3x3x3 conv whose shape,
dtype and device ``kernels.conv3d.train_route`` accepts runs through
``Conv3x3x3Fn`` (K1 forward and data gradient, K6 filter gradient), its
output rounded to the compute dtype before the bias, as the JAX routed conv
does. With or without gradients, a 3x3x3 conv that
``kernels.conv3d.flat_route`` accepts runs through ``FlatConvFn`` (K9
forward, fp32 out), rounded the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from medseg_torch.utils.profiling import span

LEAKY_SLOPE = 0.01  # MONAI dynunet act: leakyrelu(negative_slope=0.01)
NORM_EPS = 1e-5  # torch InstanceNorm3d default eps


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


# after the names above, which kernels.conv_of and kernels.norm_of import
# from this module
from medseg_torch.kernels import conv3d, norm_of  # noqa: E402


def compute_dtype(dtype: torch.dtype | None, x: torch.Tensor, param: torch.Tensor) -> torch.dtype:
    """A layer's compute dtype: ``dtype``, else the promoted type of its
    input and parameter (flax's rule for ``dtype=None``)."""
    return dtype or torch.promote_types(x.dtype, param.dtype)


class InstanceNorm(nn.Module):
    """Affine instance norm over the spatial dims, per sample and channel,
    statistics in fp32 whatever the input dtype (flax ``InstanceNorm``),
    returned in the input's dtype; ``residual`` is added to it and ``leaky``
    applies the blocks' leaky ReLU after that."""

    def __init__(self, channels: int, eps: float = NORM_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, *, leaky: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        with span("medseg.norm"):
            return norm_of.instance_norm(x, self.weight, self.bias, self.eps, leaky=leaky,
                                         residual=residual)


class Conv3d(nn.Module):
    """Stride-1 3D conv with torch 'same' padding for odd kernels; the conv
    sits in a ``conv`` child as in MONAI's ``Convolution``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, kernel_size, padding=(kernel_size - 1) // 2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.conv.weight)
        x = x.to(dt)
        weight, bias = self.conv.weight.to(dt), self.conv.bias.to(dt)
        c_out, _, k = weight.shape[:3]
        if k == 3 and torch.is_grad_enabled() and conv3d.train_route(
                x.shape, c_out, dt, input_grad=x.requires_grad, device=x.device):
            return conv3d.conv3x3x3(x, weight) + bias.view(1, -1, 1, 1, 1)
        if k == 3 and conv3d.flat_route(x.shape, c_out, device=x.device):
            return conv3d.conv3x3x3_flat(x, weight).to(dt) + bias.view(1, -1, 1, 1, 1)
        return F.conv3d(x, weight, bias, padding=self.conv.padding)


class ConvTranspose3d(nn.Module):
    """ConvTranspose(k=2, s=2) used for all UNETR upsampling (doubles D/H/W)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.conv = nn.ConvTranspose3d(in_ch, out_ch, 2, 2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.conv.weight)
        return F.conv_transpose3d(
            x.to(dt), self.conv.weight.to(dt), self.conv.bias.to(dt), stride=2
        )


class UnetResBlock(nn.Module):
    """Residual conv block: (conv-norm-lrelu, conv-norm) + residual, projected
    by a 1x1x1 conv + norm when the channel count changes. Kernel 3, stride
    1: the only form UNETR uses."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.conv1 = Conv3d(in_ch, out_ch, dtype=dtype)
        self.conv2 = Conv3d(out_ch, out_ch, dtype=dtype)
        self.norm1 = InstanceNorm(out_ch)
        self.norm2 = InstanceNorm(out_ch)
        self.downsample = in_ch != out_ch
        if self.downsample:
            self.conv3 = Conv3d(in_ch, out_ch, 1, dtype=dtype)
            self.norm3 = InstanceNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.conv1(x), leaky=True)
        r = self.norm3(self.conv3(x)) if self.downsample else x
        return self.norm2(self.conv2(y), residual=r, leaky=True)


class UnetBasicBlock(nn.Module):
    """Non-residual variant: (conv-norm-lrelu) x2 (res_block=False path)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.conv1 = Conv3d(in_ch, out_ch, dtype=dtype)
        self.conv2 = Conv3d(out_ch, out_ch, dtype=dtype)
        self.norm1 = InstanceNorm(out_ch)
        self.norm2 = InstanceNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.conv1(x), leaky=True)
        return self.norm2(self.conv2(y), leaky=True)


def _conv_block(in_ch: int, out_ch: int, res_block: bool, dtype: torch.dtype | None) -> nn.Module:
    return (UnetResBlock if res_block else UnetBasicBlock)(in_ch, out_ch, dtype)


class UnetrBasicBlock(nn.Module):
    """Reference encoder1."""

    def __init__(self, in_ch: int, out_ch: int, res_block: bool = True,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.layer = _conv_block(in_ch, out_ch, res_block, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrPrUpBlock(nn.Module):
    """Progressive upsampler from the token grid: ``num_layer + 1``
    ConvTranspose(k=2, s=2) stages, the reference's ``conv_block=False`` form
    (transpose convs only)."""

    def __init__(self, in_ch: int, out_ch: int, num_layer: int,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.transp_conv_init = ConvTranspose3d(in_ch, out_ch, dtype)
        self.blocks = nn.ModuleList(
            ConvTranspose3d(out_ch, out_ch, dtype) for _ in range(num_layer)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.transp_conv_init(x)
        for blk in self.blocks:
            y = blk(y)
        return y


class UnetrUpBlock(nn.Module):
    """Decoder stage: upsample, concat ``[up ; skip]``, residual conv block."""

    def __init__(self, in_ch: int, out_ch: int, res_block: bool = True,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.transp_conv = ConvTranspose3d(in_ch, out_ch, dtype)
        self.conv_block = _conv_block(2 * out_ch, out_ch, res_block, dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UnetOutBlock(nn.Module):
    """1x1x1 conv to class logits."""

    def __init__(self, in_ch: int, n_classes: int, dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.conv = Conv3d(in_ch, n_classes, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
