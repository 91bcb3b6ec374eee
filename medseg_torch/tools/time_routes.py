"""K3, K4, K5, K7, K8 and K9 at the main path's shapes, timed on one tree of
the repository, so that two trees can be compared in one call on one card
(parent, change, change, parent):

    python medseg_torch/tools/time_routes.py [--tree DIR] [--label NAME] [--kernels K7,K8]

Imports ``medseg_torch`` from ``DIR`` (default: the checkout holding this
file), builds that tree's kernels, and times each case's wrapper with CUDA
events (that tree's ``kernel_check.time_ms``: 10 calls after 2 warm calls),
beside ``F.conv3d`` on the same inputs for the convs (contiguous and
channels_last_3d; for K5 over the concatenated input, without its residual
tap and statistics; fp32 with TF32 off); K3, K4, K7 and K8 have no library
call. K7 and K8 (the config-5 case in bf16 and fp32, 2 classes, a ragged
volume) are also timed by their device kernels' durations in the
profiler's trace (``kernel_check.device_ms`` of the tree holding this file,
for both trees), warm and with the 50 MB L2 flushed before each call, and
one DiceCE forward and backward (``dice_ce_fused``) is profiled for its
device launches, the kernels and the scalar glue of ``DiceCEFn``.
The inputs come from one seeded generator, the same in every tree. Prints
one line per case with the route it took (the tree's ``tc_launches``) and
its bound (``kernel_check``'s reckoning: each input read once, each output
written once; K4 also one read and one write of the windows' box), and
writes ``chiprun_out/time_routes_<label>.json``. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

BF, F32 = torch.bfloat16, torch.float32
# (name, kernel, C, C_out, batch, edge, dtype): K5's C counts both streams
CASES = [
    ("K5 (32+32)->32 @4x48^3", "cat2", 64, 32, 4, 48, BF),
    ("K5 (32+32)->32 BraTS @4x64^3", "cat2", 64, 32, 4, 64, BF),
    ("K5 (64+64)->64 @4x48^3", "cat2", 128, 64, 4, 48, BF),
    ("K9 128->64 @4x48^3", "flat", 128, 64, 4, 48, BF),
    ("K9 32->16 @4x96^3", "flat", 32, 16, 4, 96, BF),
    ("K9 64->32 @4x48^3", "flat", 64, 32, 4, 48, BF),
    ("K9 128->64 fp32 @4x48^3", "flat", 128, 64, 4, 48, F32),
]
# the config-4 z-row batch (2 h-rows x w-starts 0, 48, 64 at 96^3), the same
# row with the last window at 82 (W = 178: off 8 voxels), the BraTS batch
CONFIG4_STARTS = [(8, 8 + h, 8 + w) for w in (0, 48, 64) for h in (0, 48)]
OFFSET_STARTS = [(8, 8 + h, 8 + w) for w in (0, 48, 82) for h in (0, 48)]
BRATS_STARTS = [(0, h, w) for w in (0, 64) for h in (0, 64)]
# (name, kernel, C, K_pad, batch or starts, edge, compute dtype, accumulator dtype)
HEAD_CASES = [
    ("K3 16->16 scaled @4x96^3", "outhead", 16, 16, 4, 96, BF, None),
    ("K3 BraTS 16->8 scaled @4x128^3", "outhead", 16, 8, 4, 128, BF, None),
    ("K3 fp32 16->16 scaled @4x96^3", "outhead", 16, 16, 4, 96, F32, None),
    ("K4 16->16 acc bf16 @6x96^3", "outhead_row", 16, 16, CONFIG4_STARTS, 96, BF, BF),
    ("K4 16->16 acc fp32 @6x96^3", "outhead_row", 16, 16, CONFIG4_STARTS, 96, BF, F32),
    ("K4 16->16 acc bf16 x-starts 0/48/82 @6x96^3", "outhead_row", 16, 16, OFFSET_STARTS, 96,
     BF, BF),
    ("K4 BraTS 16->8 acc bf16 @4x128^3", "outhead_row", 16, 8, BRATS_STARTS, 128, BF, BF),
]
# (name, kernel, K, batch, volume, dtype): config 5's logits (4 x 14 x 96^3),
# the two-class tasks' and a ragged volume (V % 8 == 1: one voxel at a time)
LOSS_CASES = [
    (f"{kn} 14 classes{' fp32' if dt == F32 else ''} @4x96^3", kernel, 14, 4, (96, 96, 96), dt)
    for kernel, kn in (("sums", "K7"), ("bwd", "K8")) for dt in (BF, F32)
] + [
    (f"{kn} 2 classes @4x96^3", kernel, 2, 4, (96, 96, 96), BF)
    for kernel, kn in (("sums", "K7"), ("bwd", "K8"))
] + [
    (f"{kn} 14 classes ragged @4x97^3", kernel, 14, 4, (97, 97, 97), BF)
    for kernel, kn in (("sums", "K7"), ("bwd", "K8"))
]
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def conv_case(conv_of, conv_flat, rand, kernel, c, c_out, bsz, edge):
    """(wrapper, call, FLOP, bytes, library calls) of a K5 or K9 case."""
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
    x_cl, w_cl = (t.to(memory_format=torch.channels_last_3d) for t in (x, w))
    libs = (lambda: F.conv3d(x, w, padding=1), lambda: F.conv3d(x_cl, w_cl, padding=1))
    return wrapper, call, flops, nbytes, libs


def head_case(conv_of, rand, g, dev, kernel, c, k, batch, edge, acc_dtype):
    """(wrapper, call, FLOP, bytes) of a K3 or K4 case: the blend weight in
    [0, 0.5), K4's accumulator an 8-voxel margin around the windows' box."""
    bsz = batch if kernel == "outhead" else len(batch)
    vol = (edge,) * 3
    args = [rand(bsz, c, *vol), rand(bsz, c, *vol)]
    for _ in range(2):
        args += [(torch.rand((bsz, c), generator=g) + 0.5).to(dev), rand(bsz, c, scale=0.5,
                                                                        dt=F32)]
    args += [rand(k, c, scale=c ** -0.5), rand(k, scale=0.1, dt=F32),
             (torch.rand((bsz, 1, *vol), generator=g) * 0.5).to(dev)]
    n_vox = bsz * edge**3
    flops = 2.0 * c * k * n_vox
    z = args[0]
    if kernel == "outhead":
        wrapper = conv_of.outhead_of
        nbytes = 2 * z.numel() * z.element_size() + 4 * n_vox + k * n_vox * z.element_size()
        return wrapper, lambda: wrapper(*args), flops, nbytes
    lo, ext = conv_of._window_box(batch, vol)
    acc = rand(k, *(a + e + 8 for a, e in zip(lo, ext)), dt=acc_dtype)
    box = k * ext[0] * ext[1] * ext[2] * acc.element_size()
    wrapper = conv_of.outhead_row_of
    starts = torch.tensor(batch, dtype=torch.int32)
    nbytes = 2 * z.numel() * z.element_size() + 4 * n_vox + 2 * box
    return wrapper, lambda: wrapper(*args, starts, acc), flops, nbytes


def loss_case(loss_of, g, dev, kernel, k, bsz, vol, dt):
    """(wrapper, call, FLOP, bytes, inputs) of a K7 or K8 case: logits
    N(0, 4), labels uniform in [0, K), K8's coefficients random."""
    logits = (torch.randn((bsz, k, *vol), generator=g) * 2.0).to(dev, dt)
    labels = torch.randint(0, k, (bsz, *vol), generator=g, dtype=torch.int32).to(dev)
    n = logits.numel()
    nbytes = n * logits.element_size() + 4 * labels.numel()
    if kernel == "sums":
        wrapper = loss_of.dice_ce_sums
        return wrapper, lambda: wrapper(logits, labels), 6.0 * n, nbytes + 4 * bsz * (3 * k + 1), (
            logits, labels)
    coefs = (torch.randn((bsz, k), generator=g).to(dev), torch.randn((bsz, k), generator=g).to(dev),
             (torch.rand((bsz,), generator=g) + 0.5).to(dev))
    wrapper = loss_of.dice_ce_bwd
    return wrapper, lambda: wrapper(logits, labels, *coefs), 13.0 * n, (
        2 * nbytes - 4 * labels.numel() + 4 * (2 * bsz * k + bsz)), (logits, labels)


def loss_launches(loss_of, profile, trace, logits, labels) -> float:
    """Device kernels of one DiceCE forward and backward through the fused
    loss (K7, K8 and the scalar glue of ``DiceCEFn``), from the trace."""
    x = logits.detach().clone().requires_grad_()

    def step():
        x.grad = None
        loss_of.dice_ce_fused(x, labels).backward()

    step()
    return profile(step, 1, trace)["kernels_per_run"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--kernels", default="K3,K4,K5,K7,K8,K9",
                    help="the kernels whose cases run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_routes: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from medseg_torch.kernels import _build, conv_flat, conv_of, kernel_check, loss_of
    from medseg_torch.tools.profile_serving import OUT_DIR, profile

    # the device timing of the tree holding this file, the same for both trees
    spec = importlib.util.spec_from_file_location(
        "_kernel_check_of_this_tree", Path(__file__).resolve().parents[1] / "kernels" /
        "kernel_check.py")
    this_check = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = this_check  # dataclasses look their module up there
    spec.loader.exec_module(this_check)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.lib()
    print(f"[time_routes {args.label}] {conv_of.__file__} [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(11)
    wanted = set(args.kernels.split(","))
    rows = []
    for name, kernel, c, width, batch, edge, dt, *acc_dtype in CASES + HEAD_CASES:
        if name.split()[0] not in wanted:
            continue

        def rand(*shape, scale=1.0, dt=dt):
            return (torch.randn(shape, generator=g) * scale).to(dev, dt)

        libs = (None, None)
        if kernel in ("cat2", "flat"):
            wrapper, call, flops, nbytes, libs = conv_case(conv_of, conv_flat, rand, kernel, c,
                                                           width, batch, edge)
        else:
            wrapper, call, flops, nbytes = head_case(conv_of, rand, g, dev, kernel, c, width,
                                                     batch, edge, acc_dtype[0])
        tc_before = getattr(wrapper, "tc_launches", 0)
        launches_before = wrapper.launches
        call()
        torch.cuda.synchronize()
        tc = getattr(wrapper, "tc_launches", 0) > tc_before
        launches = wrapper.launches - launches_before
        ms = kernel_check.time_ms(call)
        lib_ms, lib_cl_ms = (None if lib is None else kernel_check.time_ms(lib) for lib in libs)
        flop_s = flops / kernel_check.PEAK_FLOPS[dt]
        byte_s = nbytes / kernel_check.HBM_BYTES_PER_S
        bound = 1e3 * max(flop_s, byte_s)
        row = {"case": name, "tree": args.label, "route": "tensor cores" if tc else "cuda cores",
               "launches": launches, "ms": ms, "tflops": flops / ms / 1e9, "bound_ms": bound,
               "bound_by": "operations" if flop_s >= byte_s else "bytes",
               "gbytes_per_s": nbytes / ms / 1e6, "library_ms": lib_ms,
               "library_cl_ms": lib_cl_ms, "card": card}
        rows.append(row)
        lib = "" if lib_ms is None else f" F.conv3d {lib_ms:.3f} / channels_last {lib_cl_ms:.3f}"
        print(f"[time_routes {args.label}] {name:44s} {row['route']:12s} x{launches} "
              f"{ms:8.3f} ms ({row['tflops']:6.1f} TFLOP/s, {row['gbytes_per_s']:6.0f} GB/s) "
              f"bound {bound:.3f} ({row['bound_by']}){lib} [{card}]", flush=True)
        del call, libs
        torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    l2 = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for name, kernel, k, bsz, vol, dt in LOSS_CASES:
        if name.split()[0] not in wanted:
            continue
        wrapper, call, flops, nbytes, (logits, labels) = loss_case(loss_of, g, dev, kernel, k, bsz,
                                                                   vol, dt)
        launches_before = wrapper.launches
        call()
        torch.cuda.synchronize()
        launches = wrapper.launches - launches_before
        ms = kernel_check.time_ms(call)
        pattern = f"dice_ce_{kernel}"
        dev_ms = this_check.device_ms(call, pattern)
        cold_ms = this_check.device_ms(call, pattern, flush=l2.sum)
        bound = 1e3 * max(flops / kernel_check.PEAK_FLOPS[F32],
                          nbytes / kernel_check.HBM_BYTES_PER_S)
        route = "voxel per thread"  # a tree without the 16-byte route
        if hasattr(loss_of, "vector_route"):
            route = ("16-byte words" if loss_of.vector_route(labels[0].numel(), dt, logits, labels)
                     else "one voxel at a time")
        row = {"case": name, "tree": args.label, "route": route, "launches": launches, "ms": ms,
               "device_ms": dev_ms, "device_cold_ms": cold_ms, "bound_ms": bound,
               "bound_by": "bytes", "gbytes_per_s": nbytes / cold_ms / 1e6, "card": card}
        if kernel == "bwd" and k == 14 and dt == BF and vol == (96, 96, 96):
            row["loss_launches_per_step"] = loss_launches(loss_of, profile,
                                                          OUT_DIR / f"trace_loss_{args.label}.json",
                                                          logits, labels)
        rows.append(row)
        step = row.get("loss_launches_per_step")
        print(f"[time_routes {args.label}] {name:44s} {route:20s} x{launches} "
              f"wrapper {ms:8.3f} ms, device {dev_ms:8.4f} ms warm / {cold_ms:8.4f} ms L2 flushed "
              f"({row['gbytes_per_s']:6.0f} GB/s), bound {bound:.4f} ({bound / cold_ms:.0%} of it)"
              + ("" if step is None else f"; DiceCE fwd+bwd {step:.0f} device launches")
              + f" [{card}]", flush=True)
        del call, logits, labels
        torch.cuda.empty_cache()
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"time_routes_{args.label}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
