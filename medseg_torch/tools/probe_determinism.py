"""Whether the port's kernels and its serving forward give the same bits
from call to call, on one NVIDIA GPU.

    python -m medseg_torch.tools.probe_determinism

Calls every case of ``kernel_check`` (the serving, BraTS, training and flat
kernels at the main path's shapes, fp32 and bf16) three times on the same
inputs and prints, per case, whether its outputs and its sums (the (B,) or
(B, C) statistics) agree bit for bit, and else their largest difference
relative to their largest magnitude. Then UNETR-B/16 (bf16, random weights
from a seed): the fused forward twice on one batch of four 96^3 windows, the
module forward twice, and ``Validator.infer_volume`` twice on a 192^3
volume (the z-row walk), with the largest logit difference and the share of
voxels whose argmax agrees. Each line carries the card's name and power
limit.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from medseg_torch.kernels import _build, kernel_check


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _call(case):
    args = list(case.args)
    if case.inplace is not None:
        args[case.inplace] = args[case.inplace].clone()
    out = case.kernel(*args, **case.kwargs)
    if case.inplace is not None:
        out = args[case.inplace]
    return [t.clone() for t in (out if isinstance(out, tuple) else (out,))]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / a.float().abs().max().clamp_min(1e-30)).item()


def kernels(device, card: str) -> None:
    for cases in (kernel_check.kernel_cases, kernel_check.brats_cases,
                  kernel_check.training_cases, kernel_check.mri_training_cases,
                  kernel_check.flat_cases):
        for dtype in (torch.float32, torch.bfloat16):
            for case in cases(device, dtype):
                runs = [_call(case) for _ in range(3)]
                torch.cuda.synchronize()
                report = {}
                for kind, pick in (("outputs", lambda t: t.ndim > 2), ("sums", lambda t: t.ndim <= 2)):
                    pairs = [(a, b) for run in runs[1:] for a, b in zip(runs[0], run) if pick(a)]
                    if pairs:
                        same = all(torch.equal(a, b) for a, b in pairs)
                        report[kind] = "bitwise" if same else f"differ {max(_rel(a, b) for a, b in pairs):.2e}"
                print(f"[kernel] {str(dtype)[6:]:8s} {case.name:52s} {report} [{card}]", flush=True)
            torch.cuda.empty_cache()


def forward(device, card: str) -> None:
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights
    from medseg_torch.models.unetr import init_weights, unetr_b16
    from medseg_torch.ops.sliding_window import SlidingWindowSpec

    g = torch.Generator().manual_seed(0)
    model = init_weights(unetr_b16(1, 14, 96, dtype=torch.bfloat16), g).to(device).eval()
    x = torch.randn((4, 1, 96, 96, 96), generator=g).to(device)
    weights = fused_weights(model)
    with torch.no_grad():
        fused = [fast_apply_v3(model, x, weights).float() for _ in range(2)]
        module = [model(x, return_encoder_features=False).float() for _ in range(2)]
    volume = np.random.default_rng(0).standard_normal((192, 192, 192, 1), dtype=np.float32)
    spec = SlidingWindowSpec(roi=(96,) * 3, overlap=0.25, sw_batch=4, mode="constant",
                             bucket_multiple=32)
    validator = Validator(model, 14, "ct", spec, device=device)
    walk = [validator.infer_volume(volume) for _ in range(2)]
    for name, (a, b) in (("fused forward 4x96^3", fused), ("module forward 4x96^3", module),
                         ("Validator.infer_volume 192^3 (z-row walk)", walk)):
        agree = (a.argmax(-1 if a.ndim == 4 else 1) == b.argmax(-1 if b.ndim == 4 else 1))
        print(f"[forward] {name} twice: {'bitwise' if torch.equal(a, b) else 'differ'}, largest "
              f"logit difference {(a - b).abs().max().item():.3e} (largest logit "
              f"{a.abs().max().item():.3f}), argmax agreement {agree.float().mean().item():.7f} "
              f"[{card}]", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_determinism: needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    _build.lib()
    device = torch.device("cuda", 0)
    kernels(device, card)
    forward(device, card)


if __name__ == "__main__":
    main()
