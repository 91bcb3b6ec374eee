"""Whether the port's kernels and its serving forward give the same bits
from call to call, on one NVIDIA GPU.

    python -m medseg_torch.tools.probe_determinism

Calls every case of ``kernel_check`` (the serving, BraTS, training and flat
kernels at the main path's shapes, fp32 and bf16, so both routes of K1, K2,
K5, K6 and K9) three times on the same inputs and prints, per case, the
route it took and whether its outputs and its sums (the (B,) or (B, C)
statistics) agree bit for bit, and else their largest difference relative to
their largest magnitude. Then UNETR-B/16 (bf16, random weights from a seed):
the fused forward twice on one batch of four 96^3 windows, the module
forward twice, and ``Validator.infer_volume`` twice on a 192^3 volume (the
z-row walk), with the largest logit difference and the share of voxels
whose argmax agrees. Each line carries the card's name and power limit.
Exits with 1, after naming them, if any case is not bitwise reproducible.
``chip_smoke.py``'s determinism phase calls ``kernels`` (K1, K2, K5 and K6,
the narrow-input kernels of K1 and K6 among them) and ``fused_forward``.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from medseg_torch.kernels import _build, kernel_check

CASES = (kernel_check.kernel_cases, kernel_check.brats_cases, kernel_check.training_cases,
         kernel_check.mri_training_cases, kernel_check.flat_cases)


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


def kernels(device, card: str, names=None, calls: int = 3, cases_fns=CASES,
            label: str = "kernel") -> list[str]:
    """Each case (of the kernels named ``names``, or all) called ``calls``
    times in fp32 and in bf16; returns the cases whose outputs or sums were
    not the same bits every time."""
    failed = []
    for cases in cases_fns:
        for dtype in (torch.float32, torch.bfloat16):
            for case in cases(device, dtype):
                if names is not None and case.kernel.__name__ not in names:
                    continue
                tc_before = getattr(case.kernel, "tc_launches", 0)
                narrow_before = getattr(case.kernel, "narrow_launches", 0)
                runs = [_call(case) for _ in range(calls)]
                torch.cuda.synchronize()
                route = ("narrow tc" if getattr(case.kernel, "narrow_launches", 0) > narrow_before
                         else "tensor cores" if getattr(case.kernel, "tc_launches", 0) > tc_before
                         else "cuda cores")
                report = {}
                for kind, pick in (("outputs", lambda t: t.ndim > 2), ("sums", lambda t: t.ndim <= 2)):
                    pairs = [(a, b) for run in runs[1:] for a, b in zip(runs[0], run) if pick(a)]
                    if pairs:
                        same = all(torch.equal(a, b) for a, b in pairs)
                        report[kind] = "bitwise" if same else f"differ {max(_rel(a, b) for a, b in pairs):.2e}"
                        if not same:
                            failed.append(f"{str(dtype)[6:]} {case.name} {kind}")
                print(f"[{label}] {str(dtype)[6:]:8s} {case.name:52s} {route:12s} {report} "
                      f"[{card}]", flush=True)
            torch.cuda.empty_cache()
    return failed


def _report(name: str, a: torch.Tensor, b: torch.Tensor, card: str, label: str) -> bool:
    agree = (a.argmax(-1 if a.ndim == 4 else 1) == b.argmax(-1 if b.ndim == 4 else 1))
    same = torch.equal(a, b)
    print(f"[{label}] {name} twice: {'bitwise' if same else 'differ'}, largest "
          f"logit difference {(a - b).abs().max().item():.3e} (largest logit "
          f"{a.abs().max().item():.3f}), argmax agreement {agree.float().mean().item():.7f} "
          f"[{card}]", flush=True)
    return same


def fused_forward(model, x: torch.Tensor, card: str, label: str = "forward") -> bool:
    """The fused forward twice on the batch ``x``: whether its logits are
    the same bits both times."""
    from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights

    weights = fused_weights(model)
    with torch.no_grad():
        a, b = (fast_apply_v3(model, x, weights).float() for _ in range(2))
    return _report(f"fused forward {x.shape[0]}x{x.shape[-1]}^3", a, b, card, label)


def forward(device, card: str) -> list[str]:
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.models.unetr import init_weights, unetr_b16
    from medseg_torch.ops.sliding_window import SlidingWindowSpec

    g = torch.Generator().manual_seed(0)
    model = init_weights(unetr_b16(1, 14, 96, dtype=torch.bfloat16), g).to(device).eval()
    x = torch.randn((4, 1, 96, 96, 96), generator=g).to(device)
    failed = [] if fused_forward(model, x, card) else ["fused forward"]
    with torch.no_grad():
        module = [model(x, return_encoder_features=False).float() for _ in range(2)]
    volume = np.random.default_rng(0).standard_normal((192, 192, 192, 1), dtype=np.float32)
    spec = SlidingWindowSpec(roi=(96,) * 3, overlap=0.25, sw_batch=4, mode="constant",
                             bucket_multiple=32)
    validator = Validator(model, 14, "ct", spec, device=device)
    walk = [validator.infer_volume(volume) for _ in range(2)]
    for name, (a, b) in (("module forward 4x96^3", module),
                         ("Validator.infer_volume 192^3 (z-row walk)", walk)):
        if not _report(name, a, b, card, "forward"):
            failed.append(name)
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_determinism: needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    _build.lib()
    device = torch.device("cuda", 0)
    failed = kernels(device, card) + forward(device, card)
    print(f"[determinism] {'every case bitwise' if not failed else f'NOT bitwise: {failed}'} "
          f"[{card}]", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
