"""Each CUDA kernel against its plain PyTorch version, on the same inputs.

``kernel_cases`` builds seeded inputs for every kernel of the serving path
at the shapes the fused forward gives it (``full``^3 and ``full/2``^3
volumes, ``fs`` = feature_size); ``run_case`` calls the wrapper (which
launches the kernel on a CUDA device) and the plain version, and returns the
largest errors and both times. ``chip_smoke.py`` runs it at the main path's
shapes, ``tests/test_torch_kernels_cuda.py`` at small ones.

Tolerances (errors are max |kernel - plain| over max(1, max |plain|)):
outputs 1e-4 in fp32 (both sides sum in fp32, only the order differs) and
2e-2 in bf16 (one bf16 rounding of the output); statistics 1e-3 (the
kernel's atomics add in a varying order).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from medseg_torch.kernels import conv_of

OUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STATS_TOL = 1e-3


@dataclasses.dataclass
class Case:
    name: str
    kernel: Callable  # the wrapper
    plain: Callable
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)  # keyword inputs of both


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
    cases = [
        Case(f"enc1.conv1 1->{fs} @{batch}x{full}^3", c.conv3x3x3_of, c.conv3x3x3_of_plain,
             (vol(1, full), weight(fs, 1))),
        Case(f"enc1.conv1+conv3 4->{fs} @{batch}x{full}^3", c.conv3x3x3_of,
             c.conv3x3x3_of_plain, (vol(4, full), weight(fs, 4)), {"wres": weight(fs, 4, 1)}),
        Case(f"enc1.conv2 {fs}->{fs} affine @{batch}x{full}^3", c.conv3x3x3_of,
             c.conv3x3x3_of_plain, (vol(fs, full), weight(fs, fs), *affine(fs))),
        Case(f"{fs}->{fs} affine+conv3 @{batch}x{full}^3", c.conv3x3x3_of,
             c.conv3x3x3_of_plain, (vol(fs, full), weight(fs, fs), *affine(fs)),
             {"wres": weight(fs, fs, 1)}),
        Case(f"dec3.conv2 {2 * fs}->{2 * fs} affine @{batch}x{half}^3", c.conv3x3x3_of,
             c.conv3x3x3_of_plain, (vol(2 * fs, half), weight(2 * fs, 2 * fs), *affine(2 * fs))),
        Case(f"dec3.conv1 ({2 * fs}+{2 * fs})->{2 * fs} @{batch}x{half}^3", c.conv3x3x3_of_cat2,
             c.conv3x3x3_of_cat2_plain,
             (vol(2 * fs, half), vol(2 * fs, half), weight(2 * fs, 4 * fs), weight(2 * fs, 4 * fs, 1))),
    ]
    for xc in (1, fs):
        cases.append(Case(
            f"dec2.conv1 ({fs}+{fs})->{fs} x{xc}ch @{batch}x{full}^3", c.conv3x3x3_of_combine,
            c.conv3x3x3_of_combine_plain,
            (vol(fs, full), vol(fs, full), vol(xc, full), *affine(fs), *affine(fs),
             weight(fs, 2 * fs), weight(fs, 2 * fs, 1)),
        ))
    k_pad = 16
    scale = (torch.rand((batch, 1, full, full, full), generator=g) * 0.5).to(device)
    cases.append(Case(
        f"out head {fs}->{k_pad} scaled @{batch}x{full}^3", c.outhead_of, c.outhead_of_plain,
        (vol(fs, full), vol(fs, full), *affine(fs), *affine(fs), randn(k_pad, fs, scale=fs**-0.5),
         randn(k_pad, scale=0.1, dt=torch.float32), scale),
    ))
    return cases


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


def run_case(case: Case, dtype: torch.dtype, *, timed: bool = False) -> dict:
    """Kernel vs plain on the case's inputs: relative errors (outputs and
    statistics separately), the largest absolute output error, pass/fail, and with ``timed`` both mean times in ms."""
    got = case.kernel(*case.args, **case.kwargs)
    ref = case.plain(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out_err = stats_err = max_abs_err = 0.0
    for g, r in zip(got, ref):
        if g.ndim == 2:  # (B, C) sums
            stats_err = max(stats_err, _rel_err(g, r))
        else:
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{case.name}: non-finite kernel output")
            out_err = max(out_err, _rel_err(g, r))
            max_abs_err = max(max_abs_err, (g.float() - r.float()).abs().max().item())
    result = {
        "name": case.name,
        "out_err": out_err,
        "stats_err": stats_err,
        "max_abs_err": max_abs_err,
        "ok": out_err <= OUT_TOL[dtype] and stats_err <= STATS_TOL,
    }
    if timed:
        result["ms"] = time_ms(lambda: case.kernel(*case.args, **case.kwargs))
        result["plain_ms"] = time_ms(lambda: case.plain(*case.args, **case.kwargs))
    return result
