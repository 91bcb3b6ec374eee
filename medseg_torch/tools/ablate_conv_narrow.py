"""What bounds the narrow-input convs (``csrc/conv_narrow_tc.cu``), on one
NVIDIA GPU:

    python -m medseg_torch.tools.ablate_conv_narrow

Builds the kernel library, then two variants of it in which
``conv_narrow_tc.cu`` is compiled with ``MEDSEG_NARROW_ABLATE`` 1 (K1: no
output stores; K6: no cotangent loads, its operand 0) and 2 (no gather and
no MMAs: the halo staging and the big stream alone, the copy floor), and
times K1 and K6 through their wrappers on each at the narrow shapes of
``tools/time_routes.py`` (CUDA events, bf16; the variants' outputs are wrong
by design, only their times are read; wrapper time by CUDA events and the
device kernels' time in the profiler's trace), beside each case's bound
(``kernel_check``'s reckoning). Prints ``nvcc -Xptxas -v`` per
instantiation (registers, spills) and each route's blocks per SM
(``medseg_narrow_plan``). Writes ``chiprun_out/ablate_conv_narrow.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from medseg_torch.kernels import _build, conv_of, kernel_check
from medseg_torch.tools.ablate_conv_tc import build_variants, spills

VARIANTS = {"no stores / no cotangent": ["-DMEDSEG_NARROW_ABLATE=1"],
            "copy floor": ["-DMEDSEG_NARROW_ABLATE=2"]}
# the narrow kernels and their finishes, timed in the profiler's trace
DEVICE_KERNELS = r"conv_narrow_kernel|stats_finish|wgrad_narrow_kernel|wgrad_tc_reduce"
# (name, kernel, C, C_out, batch, edge): the narrow cases of time_routes.py
CASES = [
    ("K1 1->16 @4x96^3", "fwd", 1, 16, 4, 96),
    ("K1 1->16 @6x96^3", "fwd", 1, 16, 6, 96),
    ("K1 4->16 + conv3 @4x128^3", "fwd_res", 4, 16, 4, 128),
    ("K1 4->16 @4x128^3", "fwd", 4, 16, 4, 128),
    ("K6 1->16 @4x96^3", "wgrad", 1, 16, 4, 96),
    ("K6 4->16 @4x128^3", "wgrad", 4, 16, 4, 128),
]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_conv_narrow: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    paths, report = build_variants("conv_narrow_tc.cu", VARIANTS)
    result = {"card": card, "ptxas": spills(report), "plans": [], "times": []}
    for r in result["ptxas"]:
        print(f"[ptxas] {r['kernel']}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} B spill stores [{card}]", flush=True)
    _build._lib = _build.load(paths["kernel"])
    for which, residual, c_out, c in ((0, 0, 16, 1), (0, 1, 16, 4), (0, 0, 16, 4), (1, 0, 16, 1),
                                      (1, 0, 16, 4)):
        per_sm = conv_of.narrow_per_sm(0, which, residual, c_out, c)
        label = f"{'K1' if which == 0 else 'K6'} {c}->{c_out}{' + tap' if residual else ''}"
        result["plans"].append({"route": label, "blocks_per_sm": per_sm})
        print(f"[plan] {label:16s} {per_sm} block(s) of 8 warps per SM [{card}]", flush=True)
    g = torch.Generator().manual_seed(13)
    bf = torch.bfloat16
    inputs = []
    for name, kind, c, c_out, bsz, edge in CASES:
        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to(dev, bf)

        vol = (edge,) * 3
        x = rand(bsz, c, *vol)
        n_out = bsz * c_out * edge**3
        if kind == "wgrad":
            args, fn = (x, rand(bsz, c_out, *vol)), conv_of.conv3x3x3_wgrad_of
            nbytes = 2 * (x.numel() + n_out)
        else:
            kw = {"wres": rand(c_out, c, 1, 1, 1)} if kind == "fwd_res" else {}
            args = (x, rand(c_out, c, 3, 3, 3, scale=(27 * c) ** -0.5))
            fn = lambda *a, kw=kw: conv_of.conv3x3x3_of(*a, **kw)  # noqa: E731
            nbytes = 2 * (x.numel() + (2 if kw else 1) * n_out)
        bound = 1e3 * max(2.0 * 27 * c * c_out * bsz * edge**3 / kernel_check.PEAK_FLOPS[bf],
                          nbytes / kernel_check.HBM_BYTES_PER_S)
        inputs.append((name, fn, args, bound))
    for variant, path in paths.items():
        _build._lib = _build.load(path)
        conv_of.narrow_per_sm.cache_clear()  # the variants' occupancy may differ
        for name, fn, args, bound in inputs:
            ms = kernel_check.time_ms(lambda: fn(*args))
            dev = kernel_check.device_ms(lambda: fn(*args), DEVICE_KERNELS)
            result["times"].append({"variant": variant, "case": name, "ms": ms,
                                    "device_ms": dev, "bound_ms": bound})
            print(f"[ablate] {variant:26s} {name:28s} {ms:8.4f} ms, device {dev:8.4f} ms (bound "
                  f"{bound:.4f}, {bound / dev:.0%} of it) [{card}]", flush=True)
    _build._lib = _build.load(paths["kernel"])
    conv_of.narrow_per_sm.cache_clear()
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "ablate_conv_narrow.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
