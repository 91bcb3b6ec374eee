#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, no arguments

Builds the port's CUDA kernels from ``medseg_torch/kernels/csrc`` and drives
its serving path, whole-volume sliding-window inference of UNETR-B/16
(BASELINE config 4: a 512x512x160 one-channel CT volume, 14 classes, 96^3
windows, overlap 0.5, Gaussian blend, sw_batch 4), with random weights from
a seed. Phases, each raising on failure:

1. device: requires CUDA; prints the card's name and power limit; TF32 off
   for every fp32 reference;
2. build: the kernel library, timed;
3. every kernel against its plain PyTorch version at the path's shapes, fp32
   and bf16, with errors and CUDA-event times;
4. the fused forward (kernels, bf16) against the module forward (fp32) on
   one batch of four 96^3 windows;
5. ``Validator.infer_volume`` on a small volume against the plain forward,
   then on the config-4 volume (one warm run, one timed run whose kernel
   launches are counted).

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCES = {  # wrapper -> (CUDA source, TPU kernel it replaces)
    "conv3x3x3_of": ("medseg_torch/kernels/csrc/conv_of.cu", "medseg/kernels/conv_of.py:761"),
    "conv3x3x3_of_cat2": ("medseg_torch/kernels/csrc/conv_of.cu", "medseg/kernels/conv_of.py:1044"),
    "conv3x3x3_of_combine": ("medseg_torch/kernels/csrc/conv_of.cu", "medseg/kernels/conv_of.py:1205"),
    "outhead_of": ("medseg_torch/kernels/csrc/outhead_of.cu", "medseg/kernels/conv_of.py:1423"),
}
# the bf16 case of each kernel whose time stands in the kernel table: the
# shape config 4 runs most (kernel_check case names)
TIMED_CASE = {
    "conv3x3x3_of": "enc1.conv2 16->16 affine @4x96^3",
    "conv3x3x3_of_cat2": "dec3.conv1 (32+32)->32 @4x48^3",
    "conv3x3x3_of_combine": "dec2.conv1 (16+16)->16 x1ch @4x96^3",
    "outhead_of": "out head 16->16 scaled @4x96^3",
}
FWD_REL_L2_BOUND = 5e-2  # bf16 kernels vs fp32 module forward on random weights


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(card)  # as nvidia-smi prints it: name, power limit
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    return torch.device("cuda", 0), card


def phase_build() -> None:
    from medseg_torch.kernels import _build

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc: "
        f"{'cached' if _build.build_seconds is None else f'{_build.build_seconds:.1f} s'})")


def phase_kernels(device) -> dict:
    from medseg_torch.kernels import kernel_check

    table = {name: {"max_abs_err": 0.0} for name in KERNEL_SOURCES}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in kernel_check.kernel_cases(device, dtype):
            r = kernel_check.run_case(case, dtype, timed=True)
            entry = table[case.kernel.__name__]
            entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
            if dtype == torch.bfloat16 and case.name == TIMED_CASE[case.kernel.__name__]:
                entry["ms"], entry["plain_ms"] = r["ms"], r["plain_ms"]
            log(f"[kernel] {str(dtype)[6:]:8s} {case.name:44s} out_err {r['out_err']:.2e} "
                f"stats_err {r['stats_err']:.2e} kernel {r['ms']:8.3f} ms plain "
                f"{r['plain_ms']:8.3f} ms {'ok' if r['ok'] else 'FAIL'}")
            if not r["ok"]:
                failed.append((str(dtype), case.name))
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: {failed}")
    return table


def phase_forward(device, card: str):
    from medseg_torch.kernels import kernel_check
    from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights
    from medseg_torch.models.unetr import init_weights, unetr_b16

    g = torch.Generator().manual_seed(0)
    model = init_weights(unetr_b16(1, 14, 96, dtype=torch.bfloat16), g).to(device).eval()
    x = torch.randn((4, 1, 96, 96, 96), generator=g).to(device)
    weights = fused_weights(model)  # cast once, as the Validator does
    with torch.no_grad():
        ref = model(x, return_encoder_features=False)
    got = fast_apply_v3(model, x, weights)[:, :14]
    if not torch.isfinite(got).all():
        raise RuntimeError("fused forward: non-finite logits")
    err = rel_l2(got, ref)
    agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
    with torch.no_grad():
        fused_ms = kernel_check.time_ms(lambda: fast_apply_v3(model, x, weights), reps=5)
        plain_ms = kernel_check.time_ms(lambda: model(x, return_encoder_features=False), reps=5)
    log(f"[forward] UNETR-B/16 4x96^3: fused bf16 vs module fp32 rel L2 {err:.3e} "
        f"(bound {FWD_REL_L2_BOUND}), argmax agreement {agree:.5f}; fused {fused_ms:.2f} ms, "
        f"module fp32 {plain_ms:.2f} ms per batch of 4 [{card}]")
    if not err <= FWD_REL_L2_BOUND:
        raise RuntimeError(f"fused forward rel L2 {err} above {FWD_REL_L2_BOUND}")
    return model


def phase_slice(model, device, card: str) -> dict:
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.kernels import conv_of
    from medseg_torch.ops.sliding_window import SlidingWindowSpec, sliding_window_inference

    spec = SlidingWindowSpec(roi=(96, 96, 96), overlap=0.5, sw_batch=4, mode="gaussian")
    validator = Validator(model, 14, "ct", spec, device=device)
    rng = np.random.default_rng(0)

    small = rng.standard_normal((128, 128, 96, 1), dtype=np.float32)
    got = validator.infer_volume(small)
    with torch.no_grad():
        ref = sliding_window_inference(
            small, lambda w: model(w, return_encoder_features=False), 14, spec, device=device
        )
    err = rel_l2(got, ref)
    log(f"[slice] 128x128x96 volume: Validator (kernels, bf16) vs plain fp32 SWI rel L2 {err:.3e}")
    if not err <= FWD_REL_L2_BOUND:
        raise RuntimeError(f"small-volume SWI rel L2 {err} above {FWD_REL_L2_BOUND}")

    volume = rng.standard_normal((512, 512, 160, 1), dtype=np.float32)
    validator.infer_volume(volume)  # warm
    torch.cuda.synchronize()
    conv_of.reset_launches()
    t0 = time.perf_counter()
    out = validator.infer_volume(volume)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in conv_of.KERNELS}
    if tuple(out.shape) != (512, 512, 160, 14) or out.dtype != torch.float32:
        raise RuntimeError(f"config-4 output {tuple(out.shape)} {out.dtype}")
    if not torch.isfinite(out).all():
        raise RuntimeError("config-4 output has non-finite values")
    log(f"[slice] config 4 512x512x160: {seconds:.3f} s/volume, {300 / seconds:.1f} windows/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]; launches {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    return launches


def main() -> int:
    device, card = phase_device()
    phase_build()
    table = phase_kernels(device)
    model = phase_forward(device, card)
    launches = phase_slice(model, device, card)
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": table[name]["max_abs_err"],
            "ms": table[name]["ms"], "plain_ms": table[name]["plain_ms"],
        }
        for name, (src, tpu) in KERNEL_SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
