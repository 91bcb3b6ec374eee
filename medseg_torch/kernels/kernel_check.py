"""Each CUDA kernel against its plain PyTorch version, on the same inputs.

``kernel_cases`` builds seeded inputs for every kernel of the serving path
at the shapes the fused forward gives it (``full``^3 and ``full/2``^3
volumes, ``fs`` = feature_size 16, and K5 also at feature size 32's
(64+64)->64; K4 on one z-row batch of six windows, fp32 and bf16
accumulators); ``brats_cases`` does the same at the BraTS window
(128^3, four input channels, 8 padded classes); ``training_cases`` for the
kernels the training step adds (K6, K1's data gradient, K7 and K8);
``mri_training_cases`` for the BraTS training step's C_in = 4 convs (K1
and K6 at a narrow input); ``flat_cases`` for K9, the flat per-conv route of the pretraining path
(fp32 output, held to the same output tolerances as K1).
``run_case`` calls the wrapper (which launches the kernel on a CUDA device)
and the plain version, and returns the largest errors, the least time the
card could take for the work (``bound_ms``) and, when timed, the kernel's,
the plain version's and the library call's times; for a case that names
its device kernels (K7, K8), also their time from the profiler's trace
(``device_ms``), which no host cost of the wrapper can enter. ``chip_smoke.py`` runs it
at the main path's shapes, ``tests/test_torch_kernels_cuda.py`` at small
ones.

Tolerances (errors are max |kernel - plain| over max(1, max |plain|)):
outputs 1e-4 in fp32 (both sides sum in fp32, only the order differs) and
2e-2 in bf16 (one bf16 rounding of the output; the fp32 filter gradient
sums identically rounded operands), and 2e-2 for a bf16 accumulator
updated by K4 (one bf16 rounding of the sum); sums of shape (B,) or (B, C)
1e-3 (the kernels add in another order, some with atomics in a varying
one). K4 updates its
accumulator in place: each side runs on its own copy of it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Callable

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from medseg_torch.kernels import conv_flat, conv_of, loss_of, norm_of

OUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STATS_TOL = 1e-3
# NVIDIA H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Case:
    name: str
    kernel: Callable  # the wrapper
    plain: Callable
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)  # keyword inputs of both
    flops: float = 0.0  # operations the function needs on these inputs
    fp32_math: bool = False  # its operations run in fp32 whatever the operands' dtype
    # one PyTorch call computing the same function (contiguous, and
    # channels_last_3d where that layout applies), timed as a yardstick only
    library: Callable | None = None
    library_cl: Callable | None = None
    nbytes: float | None = None  # bytes the function must move, where not its inputs + outputs
    inplace: int | None = None  # index of the argument the function updates (its output)
    out_tol: float | None = None  # output tolerance, where not OUT_TOL[compute dtype]
    device_kernels: str | None = None  # pattern on the names of its device kernels


def _conv_flops(x: torch.Tensor, c_out: int, taps: int = 27) -> float:
    return 2.0 * taps * x.shape[1] * c_out * x[0, 0].numel() * x.shape[0]


def _conv_library(x: torch.Tensor, weight: torch.Tensor):
    """``F.conv3d`` of x with the weight (cuDNN), contiguous and in
    channels_last_3d; it leaves out any prologue, tap and statistics."""
    cl = torch.channels_last_3d
    x_cl, w_cl = x.to(memory_format=cl), weight.to(memory_format=cl)
    return (lambda: F.conv3d(x, weight, padding=1)), (lambda: F.conv3d(x_cl, w_cl, padding=1))


def kernel_cases(device, dtype: torch.dtype, *, batch: int = 4, full: int = 96) -> list[Case]:
    g = torch.Generator().manual_seed(0)
    half = full // 2
    fs = 16  # UNETR-B/16's feature size: the kernels' C_out are fs and 2*fs

    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dt)

    def weight(c_out, c_in, k=3):
        return randn(c_out, c_in, k, k, k, scale=(c_in * k**3) ** -0.5)

    def affine(c):
        a = (torch.rand((batch, c), generator=g) + 0.5).to(device)
        return a, randn(batch, c, scale=0.5, dt=torch.float32)

    def vol(c, s):
        return randn(batch, c, s, s, s)

    c = conv_of

    def conv_case(name, x, w, *affine, wres=None):
        lib, lib_cl = _conv_library(x, w)
        flops = _conv_flops(x, w.shape[0]) + (0 if wres is None else _conv_flops(x, w.shape[0], 1))
        kwargs = {} if wres is None else {"wres": wres}
        return Case(name, c.conv3x3x3_of, c.conv3x3x3_of_plain, (x, w, *affine), kwargs,
                    flops=flops, library=lib, library_cl=lib_cl)

    cases = [
        conv_case(f"enc1.conv1 1->{fs} @{batch}x{full}^3", vol(1, full), weight(fs, 1)),
        # the config-4 walk's batch of 6 windows (the conv's input volume)
        conv_case(f"enc1.conv1 1->{fs} @6x{full}^3 (config-4 batch)",
                  randn(6, 1, full, full, full), weight(fs, 1)),
        conv_case(f"enc1.conv1+conv3 4->{fs} @{batch}x{full}^3", vol(4, full), weight(fs, 4),
                  wres=weight(fs, 4, 1)),
        conv_case(f"enc1.conv2 {fs}->{fs} affine @{batch}x{full}^3", vol(fs, full),
                  weight(fs, fs), *affine(fs)),
        conv_case(f"{fs}->{fs} affine+conv3 @{batch}x{full}^3", vol(fs, full), weight(fs, fs),
                  *affine(fs), wres=weight(fs, fs, 1)),
        conv_case(f"dec3.conv2 {2 * fs}->{2 * fs} affine @{batch}x{half}^3", vol(2 * fs, half),
                  weight(2 * fs, 2 * fs), *affine(2 * fs)),
    ]
    xa, xb = vol(2 * fs, half), vol(2 * fs, half)
    w_cat, x_cat = weight(2 * fs, 4 * fs), torch.cat([xa, xb], dim=1)
    lib, lib_cl = _conv_library(x_cat, w_cat)  # on the concat, made outside the timing
    cases.append(Case(
        f"dec3.conv1 ({2 * fs}+{2 * fs})->{2 * fs} @{batch}x{half}^3", c.conv3x3x3_of_cat2,
        c.conv3x3x3_of_cat2_plain, (xa, xb, w_cat, weight(2 * fs, 4 * fs, 1)),
        flops=_conv_flops(x_cat, 2 * fs, 28), library=lib, library_cl=lib_cl,
    ))
    # feature size 32's dec3.conv1: (64+64) -> 64, on the tensor cores since
    # the width table reached C = 128 for K5
    xa, xb = vol(4 * fs, half), vol(4 * fs, half)
    w_cat, x_cat = weight(4 * fs, 8 * fs), torch.cat([xa, xb], dim=1)
    lib, lib_cl = _conv_library(x_cat, w_cat)
    cases.append(Case(
        f"dec3.conv1 ({4 * fs}+{4 * fs})->{4 * fs} (feature size 32) @{batch}x{half}^3",
        c.conv3x3x3_of_cat2, c.conv3x3x3_of_cat2_plain, (xa, xb, w_cat, weight(4 * fs, 8 * fs, 1)),
        flops=_conv_flops(x_cat, 4 * fs, 28), library=lib, library_cl=lib_cl,
    ))
    del x_cat
    for xc in (1, fs):
        cases.append(combine_case(f"dec2.conv1 ({fs}+{fs})->{fs} x{xc}ch @{batch}x{full}^3",
                                  vol(fs, full), vol(fs, full), vol(xc, full), *affine(fs),
                                  *affine(fs), weight(fs, 2 * fs), weight(fs, 2 * fs, 1)))
    k_pad = 16
    scale = (torch.rand((batch, 1, full, full, full), generator=g) * 0.5).to(device)
    z = vol(fs, full)
    cases.append(Case(
        f"out head {fs}->{k_pad} scaled @{batch}x{full}^3", c.outhead_of, c.outhead_of_plain,
        (z, vol(fs, full), *affine(fs), *affine(fs), randn(k_pad, fs, scale=fs**-0.5),
         randn(k_pad, scale=0.1, dt=torch.float32), scale),
        flops=2.0 * fs * k_pad * z[0, 0].numel() * batch,
    ))
    # K4 on one batch of the config-4 z-row walk: 2 h-rows x 3 w-windows
    # (w-starts 0, 48, 64 at 96^3), w-major as the walk orders them
    starts = [(8, 8 + gh * half, 8 + ws) for ws in (0, half, half + full // 6) for gh in range(2)]
    cases += outhead_row_cases(g, device, dtype, full, fs, k_pad, starts)
    # and a row whose last window starts at W - roi off 8 voxels (W = 178 at
    # 96^3: w-starts 0, 48, 82), as the walk's rows are wherever (W - roi) % 8 != 0
    last = half + 34 * full // 96
    starts = [(8, 8 + gh * half, 8 + ws) for ws in (0, half, last) for gh in range(2)]
    cases += outhead_row_cases(g, device, dtype, full, fs, k_pad, starts,
                               acc_dtypes=(torch.bfloat16,), label=f"x-starts 0/{half}/{last} ")
    return cases


def combine_case(name, up, y, x1, ay, by, ax, bx, weight, wres) -> Case:
    """K2 on these inputs; its library yardstick is ``F.conv3d`` over the
    concatenated ``[up ; y]`` (made outside the timing), without the
    prologue, the residual tap and the statistics."""
    lib, lib_cl = _conv_library(torch.cat([up, y], dim=1), weight)
    return Case(name, conv_of.conv3x3x3_of_combine, conv_of.conv3x3x3_of_combine_plain,
                (up, y, x1, ay, by, ax, bx, weight, wres),
                flops=_conv_flops(up, weight.shape[0], 28) * 2, library=lib, library_cl=lib_cl)


def outhead_row_cases(g, device, dtype, full, fs, k_pad, starts,
                      acc_dtypes=(torch.float32, torch.bfloat16), label="") -> list[Case]:
    """K4 on windows of ``full``^3 at ``starts`` (inside an accumulator that
    leaves an 8-voxel margin around their box), with accumulators of
    ``acc_dtypes`` holding random values."""
    bsz = len(starts)

    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dt)

    def affine():
        return (torch.rand((bsz, fs), generator=g) + 0.5).to(device), randn(bsz, fs, scale=0.5,
                                                                          dt=torch.float32)

    z, res = randn(bsz, fs, full, full, full), randn(bsz, fs, full, full, full)
    scale = (torch.rand((bsz, 1, full, full, full), generator=g) * 0.5).to(device)
    head = (randn(k_pad, fs, scale=fs**-0.5), randn(k_pad, scale=0.1, dt=torch.float32))
    lo, ext = conv_of._window_box(starts, (full,) * 3)
    acc_shape = (k_pad, *(a + e + 8 for a, e in zip(lo, ext)))
    n_vox = bsz * full**3
    cases = []
    for acc_dtype in acc_dtypes:
        acc = randn(*acc_shape, dt=acc_dtype)
        box = k_pad * ext[0] * ext[1] * ext[2] * acc.element_size()
        cases.append(Case(
            f"out head row {fs}->{k_pad} acc {str(acc_dtype)[6:]} {label}@{bsz}x{full}^3",
            conv_of.outhead_row_of, conv_of.outhead_row_of_plain,
            (z, res, *affine(), *affine(), *head, scale, torch.tensor(starts, dtype=torch.int32),
             acc),
            flops=2.0 * fs * k_pad * n_vox, inplace=10,
            nbytes=2 * z.numel() * z.element_size() + 4.0 * n_vox + 2 * box,
            out_tol=OUT_TOL[acc_dtype] if acc_dtype == torch.bfloat16 else None,
        ))
    return cases


def brats_cases(device, dtype: torch.dtype, *, batch: int = 4, full: int = 128) -> list[Case]:
    """The serving kernels at the BraTS window (BASELINE config 8: 128^3,
    four MRI channels, 4 classes padded to 8; sw_batch 4): enc1.conv1 with
    its conv3 tap from four channels, enc1.conv2, dec2.conv1 with the
    16-channel conv3 residual stream, dec3.conv1 and conv2 at 64^3, K3 and
    one K4 batch of 2 x 2 windows."""
    g = torch.Generator().manual_seed(2)
    half, fs, c_in, k_pad = full // 2, 16, 4, 8

    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dt)

    def weight(c_out, c, k=3):
        return randn(c_out, c, k, k, k, scale=(c * k**3) ** -0.5)

    def affine(c):
        return (torch.rand((batch, c), generator=g) + 0.5).to(device), randn(batch, c, scale=0.5,
                                                                           dt=torch.float32)

    def vol(c, s):
        return randn(batch, c, s, s, s)

    c = conv_of

    def conv(name, x, w, *aff, wres=None):
        lib, lib_cl = _conv_library(x, w)
        flops = _conv_flops(x, w.shape[0]) + (0 if wres is None else _conv_flops(x, w.shape[0], 1))
        return Case(name, c.conv3x3x3_of, c.conv3x3x3_of_plain, (x, w, *aff),
                    {} if wres is None else {"wres": wres}, flops=flops, library=lib,
                    library_cl=lib_cl)

    cases = [
        conv(f"brats enc1.conv1+conv3 {c_in}->{fs} @{batch}x{full}^3", vol(c_in, full),
             weight(fs, c_in), wres=weight(fs, c_in, 1)),
        conv(f"brats enc1.conv2 {fs}->{fs} affine @{batch}x{full}^3", vol(fs, full),
             weight(fs, fs), *affine(fs)),
        conv(f"brats dec3.conv2 {2 * fs}->{2 * fs} affine @{batch}x{half}^3", vol(2 * fs, half),
             weight(2 * fs, 2 * fs), *affine(2 * fs)),
    ]
    xa, xb = vol(2 * fs, half), vol(2 * fs, half)
    w_cat, x_cat = weight(2 * fs, 4 * fs), torch.cat([xa, xb], dim=1)
    lib, lib_cl = _conv_library(x_cat, w_cat)
    cases.append(Case(
        f"brats dec3.conv1 ({2 * fs}+{2 * fs})->{2 * fs} @{batch}x{half}^3", c.conv3x3x3_of_cat2,
        c.conv3x3x3_of_cat2_plain, (xa, xb, w_cat, weight(2 * fs, 4 * fs, 1)),
        flops=_conv_flops(x_cat, 2 * fs, 28), library=lib, library_cl=lib_cl,
    ))
    del x_cat
    cases.append(combine_case(f"brats dec2.conv1 ({fs}+{fs})->{fs} x{fs}ch @{batch}x{full}^3",
                              vol(fs, full), vol(fs, full), vol(fs, full), *affine(fs),
                              *affine(fs), weight(fs, 2 * fs), weight(fs, 2 * fs, 1)))
    z = vol(fs, full)
    cases.append(Case(
        f"brats out head {fs}->{k_pad} scaled @{batch}x{full}^3", c.outhead_of,
        c.outhead_of_plain,
        (z, vol(fs, full), *affine(fs), *affine(fs), randn(k_pad, fs, scale=fs**-0.5),
         randn(k_pad, scale=0.1, dt=torch.float32),
         (torch.rand((batch, 1, full, full, full), generator=g) * 0.5).to(device)),
        flops=2.0 * fs * k_pad * z[0, 0].numel() * batch,
    ))
    starts = [(0, h, w) for w in (0, half) for h in (0, half)]
    cases += [case for case in outhead_row_cases(g, device, dtype, full, fs, k_pad, starts)
              if case.args[-1].dtype == torch.bfloat16]
    for case in cases:
        case.name = case.name.replace("out head row", "brats out head row")
    return cases


def training_cases(device, dtype: torch.dtype, *, batch: int = 4, full: int = 96,
                   n_classes: int = 14) -> list[Case]:
    """The kernels the UNETR-B/16 training step adds, at its shapes: K6 for
    each routed conv's (C, CO), K1's data gradient at 16->32 (dec2.conv1) and
    32->64 (dec3.conv1: one launch on the tensor cores in bf16, two 32-wide
    launches on the CUDA cores in fp32), K7 and K8 on (batch, n_classes,
    full^3) logits, on 2 classes (the spleen and heart tasks) and on a
    ragged (full + 1)^3 volume (V % 8 == 1: one voxel at a time)."""
    g = torch.Generator().manual_seed(1)
    half = full // 2

    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dt)

    c = conv_of
    cases = []
    for layer, c_in, c_out, s in (
        ("enc1.conv1", 1, 16, full), ("enc1.conv2", 16, 16, full), ("dec2.conv1", 32, 16, full),
        ("dec2.conv2", 16, 16, full), ("dec3.conv1", 64, 32, half), ("dec3.conv2", 32, 32, half),
    ):
        x, cot = randn(batch, c_in, s, s, s), randn(batch, c_out, s, s, s)
        w_shape = (c_out, c_in, 3, 3, 3)
        cases.append(Case(
            f"wgrad {layer} {c_in}->{c_out} @{batch}x{s}^3", c.conv3x3x3_wgrad_of,
            c.conv3x3x3_wgrad_of_plain, (x, cot), flops=_conv_flops(x, c_out),
            library=lambda x=x, cot=cot, w_shape=w_shape: torch.nn.grad.conv3d_weight(
                x, w_shape, cot, padding=1),
        ))
    for layer, c_in, c_out, s in (("dec2.conv1", 32, 16, full), ("dec3.conv1", 64, 32, half)):
        cot = randn(batch, c_out, s, s, s)
        w_t = randn(c_out, c_in, 3, 3, 3, scale=(c_out * 27) ** -0.5).flip(2, 3, 4)
        w_t = w_t.transpose(0, 1).contiguous()  # the data gradient's weight
        lib, lib_cl = _conv_library(cot, w_t)
        cases.append(Case(
            f"bwd-data {layer} {c_out}->{c_in} @{batch}x{s}^3", c.conv3x3x3_of,
            c.conv3x3x3_of_plain, (cot, w_t), flops=_conv_flops(cot, c_in),
            library=lib, library_cl=lib_cl,
        ))
    for k, s in ((n_classes, full), (2, full), (n_classes, full + 1)):
        cases += loss_cases(g, device, dtype, batch, k, s)
    return cases


def mri_training_cases(device, dtype: torch.dtype, *, batch: int = 4,
                       full: int = 128) -> list[Case]:
    """The kernels the BraTS training step (four MRI channels, 128^3 crops,
    sigmoid DiceCE, so neither K7 nor K8) launches at C_in = 4, on the
    narrow-input tensor-core route in bf16 (the CUDA cores in fp32):
    enc1.conv1's forward (K1 4->16, no prologue) and its filter gradient (K6
    at C = 4)."""
    g = torch.Generator().manual_seed(5)
    c_in, c_out = 4, 16
    x = (torch.randn((batch, c_in, full, full, full), generator=g)).to(device=device, dtype=dtype)
    cot = torch.randn((batch, c_out, full, full, full), generator=g).to(device=device, dtype=dtype)
    w = (torch.randn((c_out, c_in, 3, 3, 3), generator=g) * (27 * c_in) ** -0.5).to(
        device=device, dtype=dtype)
    lib, lib_cl = _conv_library(x, w)
    w_shape = (c_out, c_in, 3, 3, 3)
    shape = f"{c_in}->{c_out} @{batch}x{full}^3"
    return [
        Case(f"brats step enc1.conv1 {shape}", conv_of.conv3x3x3_of, conv_of.conv3x3x3_of_plain,
             (x, w), flops=_conv_flops(x, c_out), library=lib, library_cl=lib_cl),
        Case(f"wgrad brats enc1.conv1 {shape}", conv_of.conv3x3x3_wgrad_of,
             conv_of.conv3x3x3_wgrad_of_plain, (x, cot), flops=_conv_flops(x, c_out),
             library=lambda: torch.nn.grad.conv3d_weight(x, w_shape, cot, padding=1)),
    ]


def loss_cases(g, device, dtype, batch: int, n_classes: int, edge: int) -> list[Case]:
    """K7 and K8 on (batch, n_classes, edge^3) logits (N(0, 4)) with uniform
    labels, K8 on random coefficients."""
    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dt)

    logits = randn(batch, n_classes, edge, edge, edge, scale=2.0)
    labels = torch.randint(0, n_classes, (batch, edge, edge, edge), generator=g,
                           dtype=torch.int32).to(device)
    n = batch * edge**3 * n_classes
    coefs = (randn(batch, n_classes, dt=torch.float32), randn(batch, n_classes, dt=torch.float32),
             (torch.rand((batch,), generator=g) + 0.5).to(device))
    shape = f"{n_classes} classes @{batch}x{edge}^3"
    return [
        Case(f"dice_ce_sums {shape}", loss_of.dice_ce_sums, loss_of.dice_ce_sums_plain,
             (logits, labels), flops=6.0 * n, fp32_math=True, device_kernels="dice_ce_sums"),
        Case(f"dice_ce_bwd {shape}", loss_of.dice_ce_bwd, loss_of.dice_ce_bwd_plain,
             (logits, labels, *coefs), flops=13.0 * n, fp32_math=True,
             device_kernels="dice_ce_bwd"),
    ]


def flat_cases(device, dtype: torch.dtype, *, batch: int = 4, full: int = 96) -> list[Case]:
    """K9 at the shape the flat route gives it on the pretraining path
    (decoder3.conv1 of a feature-size-32 UNETR, 128 -> 64 at ``full/2``^3,
    the concat of the upsample and the enc2 skip) and at the JAX predicate's
    table shapes, 32 -> 16 at ``full``^3 and 64 -> 32 at ``full/2``^3."""
    g = torch.Generator().manual_seed(3)
    half = full // 2
    cases = []
    for name, c_in, c_out, s in (
        (f"dec3.conv1 128->64 (feature size 32) @{batch}x{half}^3", 128, 64, half),
        (f"flat 32->16 @{batch}x{full}^3", 32, 16, full),
        (f"flat 64->32 @{batch}x{half}^3", 64, 32, half),
    ):
        x = torch.randn((batch, c_in, s, s, s), generator=g).to(device=device, dtype=dtype)
        w = (torch.randn((c_out, c_in, 3, 3, 3), generator=g) * (27 * c_in) ** -0.5).to(
            device=device, dtype=dtype)
        lib, lib_cl = _conv_library(x, w)
        cases.append(Case(name, conv_flat.conv3x3x3_flat, conv_flat.conv3x3x3_flat_plain, (x, w),
                          flops=_conv_flops(x, c_out), library=lib, library_cl=lib_cl))
    return cases


# (B, C, edge) of N1 on the main path: BraTS's, CT's and Swin's full
# resolution, CT's decoder3, the serving decoder5 and decoder4 (6 windows)
NORM_SHAPES = ((4, 16, 128), (4, 16, 96), (4, 48, 96), (4, 32, 48), (4, 128, 12), (6, 64, 24))


def _present(outputs: tuple) -> tuple:
    return tuple(t for t in outputs if t is not None)


def norm_cases(device, dtype: torch.dtype, shapes=NORM_SHAPES) -> list[Case]:
    """N1 (``norm_of``) at ``shapes``: the forward and the backward, each
    with the leaky ReLU and with the residual add and the leaky ReLU (the
    blocks' norm1 and norm2), on a conv-output-like x (an offset and a scale
    per channel). The backward takes the kernel forward's mean and rstd, on
    both sides. Library: ``F.instance_norm`` (cuDNN's batch norm over B*C
    planes; no residual or activation), its forward, and its backward from
    a graph built outside the timing."""
    g = torch.Generator().manual_seed(5)
    cases = []
    for b, c, e in shapes:
        shape = (b, c, e, e, e)
        shift = torch.randn((1, c, 1, 1, 1), generator=g) * 2.0
        x = (torch.randn(shape, generator=g) * 1.5 + shift).to(device=device, dtype=dtype)
        r = torch.randn(shape, generator=g).to(device=device, dtype=dtype)
        dy = torch.randn(shape, generator=g).to(device=device, dtype=dtype)
        w = (torch.rand((c,), generator=g) + 0.5).to(device)
        bias = (torch.randn((c,), generator=g) * 0.5).to(device)
        n = x.numel()
        xg, wg, bg = (t.detach().requires_grad_() for t in (x, w, bias))
        lib_out = F.instance_norm(xg, weight=wg, bias=bg, eps=norm_of.NORM_EPS)
        for epilogue, res in (("leaky", None), ("residual+leaky", r)):
            _, mean, rstd = norm_of.instance_norm_fwd(x, w, bias, res, True)
            name = f"{epilogue} {b}x{c}x{e}^3"
            cases.append(Case(
                f"instance_norm fwd {name}", norm_of.instance_norm_fwd,
                norm_of.instance_norm_fwd_plain, (x, w, bias, res, True), flops=10.0 * n,
                fp32_math=True, device_kernels="instnorm_",
                library=lambda x=x, w=w, bias=bias: F.instance_norm(x, weight=w, bias=bias,
                                                                    eps=norm_of.NORM_EPS)))
            cases.append(Case(
                f"instance_norm bwd {name}",
                lambda *a: _present(norm_of.instance_norm_bwd(*a)),
                lambda *a: _present(norm_of.instance_norm_bwd_plain(*a)),
                (dy, x, res, mean, rstd, w, bias, True), flops=12.0 * n, fp32_math=True,
                device_kernels="instnorm_",
                library=lambda out=lib_out, xg=xg, wg=wg, bg=bg, dy=dy: torch.autograd.grad(
                    out, (xg, wg, bg), dy, retain_graph=True)))
    return cases


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def roofline_ms(flops: float, nbytes: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time the card could take for ``flops`` operations of type
    ``dtype`` and ``nbytes`` bytes of HBM traffic: the larger of the
    operations over their peak rate and the bytes over the HBM bandwidth,
    in ms, and which of the two bounds it."""
    flop_s = flops / PEAK_FLOPS[dtype]
    byte_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(flop_s, byte_s), "operations" if flop_s >= byte_s else "bytes"


def bound_ms(case: Case, dtype: torch.dtype, outputs) -> tuple[float, str]:
    """The least time the card could take for the case's work
    (``roofline_ms``; its bytes: each input read once, each output written
    once)."""
    nbytes = case.nbytes
    if nbytes is None:
        nbytes = _nbytes(case.args) + _nbytes(case.kwargs.values()) + _nbytes(outputs)
    return roofline_ms(case.flops, nbytes, torch.float32 if case.fp32_math else dtype)


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    err = (got.float() - ref.float()).abs().max().item()
    return err / max(1.0, ref.float().abs().max().item())


def time_ms(fn: Callable, reps: int = 10) -> float:
    """Mean CUDA-event time of one call, after two warm calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# A profiler trace on the H100 (torch 2.11) lacks the kernel records of the
# launches of about its first millisecond, whose launch calls it holds, on a
# graphed walk and an eager one alike, and now and then some hundreds more.
TRACE_LEAD_SPINS = 16  # spin kernels a trace starts with, before ``run()``
TRACE_LEAD_S = 0.005  # and the host's wait after them
_LAUNCH_CALL = re.compile(r"LaunchKernel")


def _lost_records(events: list[dict], lead: int) -> int:
    """Launch calls, past the first ``lead``, whose kernel has no record in
    ``events`` (a trace's events: a kernel carries its launch call's
    correlation id)."""
    recorded = {e["args"].get("correlation") for e in events if e.get("cat") == "kernel"}
    calls = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and _LAUNCH_CALL.search(e["name"])), key=lambda e: e["ts"])
    return sum(e["args"].get("correlation") not in recorded for e in calls[lead:])


def trace_kernels(run: Callable, pattern: str = "") -> list[dict]:
    """The device kernels of one ``run()`` whose names match ``pattern``
    (all by default), as ``torch.profiler``'s trace events (``name``, ``ts``
    and ``dur`` in us). ``run()`` starts after ``TRACE_LEAD_SPINS`` spin
    kernels (``torch.cuda._sleep``, left out of the result) and
    ``TRACE_LEAD_S``, past the trace's first millisecond. A trace in which
    a launch call of ``run()`` has no kernel record is taken again, up to
    three times, the last returned as it is: a graph replay's kernels have
    no launch calls of their own, so only a comparison shows their losses."""
    torch.cuda.synchronize()
    kernels: list[dict] = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_LEAD_SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(TRACE_LEAD_S)
            run()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        kernels = [e for e in events if e.get("cat") == "kernel" and "spin_kernel" not in e["name"]
                   and re.search(pattern, e["name"])]
        if kernels and not _lost_records(events, TRACE_LEAD_SPINS):
            return kernels
    if kernels:
        return kernels
    raise RuntimeError(f"the profiler recorded no device kernel matching {pattern!r}")


def device_ms(fn: Callable, pattern: str, reps: int = 10,
              flush: Callable | None = None) -> float:
    """Mean device time per call of the kernels whose names match
    ``pattern``: the kernels' durations in ``torch.profiler``'s trace over
    ``reps`` calls after one warm call, so no host time enters it;
    ``flush()`` (not counted) runs before each call where given (read a
    buffer larger than the L2: a flush by writes leaves dirty lines that the
    timed kernel then pays to write back)."""
    fn()

    def run():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    return sum(e["dur"] for e in trace_kernels(run, pattern)) / 1e3 / reps


def run_case(case: Case, dtype: torch.dtype, *, timed: bool = False) -> dict:
    """Kernel vs plain on the case's inputs: relative errors (outputs and
    sums separately), the largest absolute output error, pass/fail, the
    bound, and with ``timed`` the mean times in ms of the kernel, the plain
    version and the library call (None where there is none)."""
    def call(fn):
        if case.inplace is None:
            return fn(*case.args, **case.kwargs)
        args = list(case.args)
        args[case.inplace] = args[case.inplace].clone()
        fn(*args, **case.kwargs)
        return args[case.inplace]

    got, ref = call(case.kernel), call(case.plain)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out_err = stats_err = max_abs_err = 0.0
    for g, r in zip(got, ref):
        if g.ndim <= 2:  # (B,) or (B, C) sums
            stats_err = max(stats_err, _rel_err(g, r))
        else:
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{case.name}: non-finite kernel output")
            out_err = max(out_err, _rel_err(g, r))
            max_abs_err = max(max_abs_err, (g.float() - r.float()).abs().max().item())
    bound, bound_by = bound_ms(case, dtype, ref)
    result = {
        "name": case.name,
        "out_err": out_err,
        "stats_err": stats_err,
        "max_abs_err": max_abs_err,
        "ok": out_err <= (case.out_tol or OUT_TOL[dtype]) and stats_err <= STATS_TOL,
        "bound_ms": bound,
        "bound_by": bound_by,
    }
    if timed:
        result["ms"] = time_ms(lambda: case.kernel(*case.args, **case.kwargs))
        result["plain_ms"] = time_ms(lambda: case.plain(*case.args, **case.kwargs))
        result["library_ms"] = None if case.library is None else time_ms(case.library)
        result["library_cl_ms"] = None if case.library_cl is None else time_ms(case.library_cl)
        result["device_ms"] = None if case.device_kernels is None else device_ms(
            lambda: case.kernel(*case.args, **case.kwargs), case.device_kernels)
    return result
