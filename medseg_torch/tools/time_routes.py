"""K5 and K9 at the main path's shapes, timed on one tree of the repository,
so that two trees can be compared in one call on one card (parent, change,
change, parent):

    python medseg_torch/tools/time_routes.py [--tree DIR] [--label NAME]

Imports ``medseg_torch`` from ``DIR`` (default: the checkout holding this
file), builds that tree's kernels, and times each case's wrapper with CUDA
events (that tree's ``kernel_check.time_ms``: 10 calls after 2 warm calls),
beside ``F.conv3d`` on the same inputs (contiguous and channels_last_3d;
for K5 over the concatenated input, without its residual tap and
statistics; fp32 with TF32 off). The inputs come from one seeded generator,
the same in every tree. Prints one line per case with the route it took
(the tree's ``tc_launches``, where the wrapper has them) and writes
``chiprun_out/time_routes_<label>.json``. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

# (name, kernel, C, C_out, batch, edge, dtype): K5's C counts both streams
CASES = [
    ("K5 (32+32)->32 @4x48^3", "cat2", 64, 32, 4, 48, torch.bfloat16),
    ("K5 (32+32)->32 BraTS @4x64^3", "cat2", 64, 32, 4, 64, torch.bfloat16),
    ("K5 (64+64)->64 @4x48^3", "cat2", 128, 64, 4, 48, torch.bfloat16),
    ("K9 128->64 @4x48^3", "flat", 128, 64, 4, 48, torch.bfloat16),
    ("K9 32->16 @4x96^3", "flat", 32, 16, 4, 96, torch.bfloat16),
    ("K9 64->32 @4x48^3", "flat", 64, 32, 4, 48, torch.bfloat16),
    ("K9 128->64 fp32 @4x48^3", "flat", 128, 64, 4, 48, torch.float32),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_routes: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from medseg_torch.kernels import _build, conv_flat, conv_of, kernel_check

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.lib()
    print(f"[time_routes {args.label}] {conv_of.__file__} [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(11)
    rows = []
    for name, kernel, c, c_out, bsz, edge, dt in CASES:
        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to(dev, dt)

        w = rand(c_out, c, 3, 3, 3, scale=(27 * c) ** -0.5)
        if kernel == "cat2":
            xa, xb = rand(bsz, c // 2, edge, edge, edge), rand(bsz, c // 2, edge, edge, edge)
            wres = rand(c_out, c, 1, 1, 1, scale=c ** -0.5)
            wrapper = conv_of.conv3x3x3_of_cat2
            call = lambda: wrapper(xa, xb, w, wres)  # noqa: E731
            x = torch.cat([xa, xb], dim=1)
            flops = 2.0 * 28 * c * c_out * bsz * edge**3
            nbytes = 2 * x.numel() * x.element_size()  # inputs read, out and res written
        else:
            x = rand(bsz, c, edge, edge, edge)
            wrapper = conv_flat.conv3x3x3_flat
            call = lambda: wrapper(x, w)  # noqa: E731
            flops = 2.0 * 27 * c * c_out * bsz * edge**3
            nbytes = x.numel() * x.element_size() + 4 * bsz * c_out * edge**3
        tc_before = getattr(wrapper, "tc_launches", 0)
        launches_before = wrapper.launches
        call()
        torch.cuda.synchronize()
        tc = getattr(wrapper, "tc_launches", 0) > tc_before
        launches = wrapper.launches - launches_before
        ms = kernel_check.time_ms(call)
        x_cl, w_cl = (t.to(memory_format=torch.channels_last_3d) for t in (x, w))
        lib_ms = kernel_check.time_ms(lambda: F.conv3d(x, w, padding=1))
        lib_cl_ms = kernel_check.time_ms(lambda: F.conv3d(x_cl, w_cl, padding=1))
        bound = 1e3 * max(flops / kernel_check.PEAK_FLOPS[dt],
                          nbytes / kernel_check.HBM_BYTES_PER_S)
        row = {"case": name, "tree": args.label, "route": "tensor cores" if tc else "cuda cores",
               "launches": launches, "ms": ms, "tflops": flops / ms / 1e9, "bound_ms": bound,
               "library_ms": lib_ms, "library_cl_ms": lib_cl_ms, "card": card}
        rows.append(row)
        print(f"[time_routes {args.label}] {name:30s} {row['route']:12s} x{launches} "
              f"{ms:8.3f} ms ({row['tflops']:6.1f} TFLOP/s) bound {bound:.3f} F.conv3d "
              f"{lib_ms:.3f} / channels_last {lib_cl_ms:.3f} [{card}]", flush=True)
        del x, w, x_cl, w_cl
        torch.cuda.empty_cache()
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"time_routes_{args.label}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
