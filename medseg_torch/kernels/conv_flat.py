"""The flat per-conv route's kernel (K9, counterpart of
``medseg/kernels/conv3d.py``'s ``conv3x3x3_flat``).

``conv3x3x3_flat(x, weight)``: a plain 3x3x3 stride-1 zero-padded conv of x
(B, C, D, H, W) with weight (CO, C, 3, 3, 3), both in the compute dtype
(fp32 or bf16), summed in fp32 and returned in fp32 (B, CO, D, H, W). No
prologue, residual tap or statistics. Two routes, picked by shape and dtype
alone:

- the tensor cores (``csrc/conv_tc.cu`` mode FLAT, ``conv_of.tc_route(C,
  CO, dtype, "flat")``): bf16 with C a multiple of 16 up to 128 and CO 16,
  32 or 64, the input staged asynchronously (cp.async) where W is a
  multiple of 8;
- the CUDA cores (``csrc/conv_flat.cu``): every other width the kernel
  takes, C a multiple of 8 up to 128 and CO a multiple of 16 up to 128, in
  one launch (``has_kernel``), and fp32.

It raises on any other width. On a CPU tensor the wrapper runs the plain
version; ``launches`` counts the kernel's launches and ``tc_launches`` those
that took the tensor cores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medseg_torch.kernels import _build, conv_of  # its helpers, used at call time

MAX_C = 128  # widest input or output the kernel takes
C_ALIGN = 8  # input channels per staged chunk (FCC of csrc/conv_flat.cu)
CO_TILES = (32, 16)  # output channels per block (the kernel's instantiations)


def has_kernel(c: int, c_out: int) -> bool:
    """Whether the kernel takes ``c`` -> ``c_out`` channels."""
    return (0 < c <= MAX_C and c % C_ALIGN == 0 and 0 < c_out <= MAX_C
            and any(c_out % t == 0 for t in CO_TILES))


def conv3x3x3_flat_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """fp32 math on the fp32 casts of the operands."""
    return F.conv3d(x.float(), weight.float(), padding=1)


def conv3x3x3_flat(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K9. Returns the fp32 conv of x with weight (see the module docstring)."""
    if x.device.type == "cpu":
        return conv3x3x3_flat_plain(x, weight)
    dev = conv_of._device_of(x)
    dt = x.dtype
    if dt not in conv_of._DTYPES:
        raise ValueError(f"compute dtype {dt} not supported (float32 or bfloat16)")
    bsz, c, d, h, w = x.shape
    c_out = weight.shape[0]
    if c % C_ALIGN or c > MAX_C:
        raise ValueError(f"C={c}: the flat conv kernel takes C a multiple of {C_ALIGN} up to {MAX_C}")
    if not has_kernel(c, c_out):
        raise ValueError(f"C_out={c_out}: the flat conv kernel takes C_out a multiple of "
                         f"{CO_TILES[-1]} up to {MAX_C}")
    conv_of._check(x, "x", (bsz, c, d, h, w), dt, dev)
    conv_of._check(weight, "weight", (c_out, c, 3, 3, 3), dt, dev)
    if conv_of.tc_route(c, c_out, dt, "flat"):
        out = conv_of.launch_flat_tc(x, weight)
        conv3x3x3_flat.launches += 1
        conv3x3x3_flat.tc_launches += 1
        return out
    tile = next(t for t in CO_TILES if c_out % t == 0)
    out = torch.empty((bsz, c_out, d, h, w), dtype=torch.float32, device=dev)
    err = _build.lib().medseg_conv_flat(
        dev.index, int(dt == torch.bfloat16), tile, x.data_ptr(), weight.data_ptr(), out.data_ptr(),
        bsz, c, c_out, d, h, w, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "flat conv kernel")
    conv3x3x3_flat.launches += 1
    return out


KERNELS = (conv3x3x3_flat,)
conv3x3x3_flat.launches = conv3x3x3_flat.tc_launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = fn.tc_launches = 0
