"""Where K7's and K8's time goes (``csrc/loss_of.cu``), on one NVIDIA GPU:

    python -m medseg_torch.tools.ablate_loss

- builds the kernel library and a variant of it in which ``loss_of.cu`` is
  compiled with ``-DMEDSEG_LOSS_ABLATE=1``: the copy-only kernels, with the
  same 16-byte loads of logits and labels, K7's partial sums and finish and
  K8's 16-byte stores (the logits copied back), but no softmax and no sums.
  It times the K7 and K8 cases of ``tools/time_routes.py`` on both by the
  device kernels' durations in the profiler's trace, with the L2 flushed
  before each call (``kernel_check.device_ms``; an ablated variant's
  results are wrong by design, only its times are read), beside each case's
  bound;
- prints ``nvcc -Xptxas -v`` of ``loss_of.cu`` per instantiation
  (registers, spill stores, static shared memory).

Writes ``chiprun_out/ablate_loss.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from medseg_torch.kernels import _build, kernel_check, loss_of
from medseg_torch.tools.ablate_conv_tc import build_variants, spills
from medseg_torch.tools.time_routes import L2_FLUSH_BYTES, LOSS_CASES, loss_case

VARIANTS = {"copy only": ["-DMEDSEG_LOSS_ABLATE=1"]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_loss: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    paths, report = build_variants("loss_of.cu", VARIANTS)
    result = {"card": card, "ptxas": spills(report), "times": []}
    for r in result["ptxas"]:
        print(f"[ptxas] {r['kernel']}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} B spill stores, {r.get('smem')} B shared [{card}]",
              flush=True)
    g = torch.Generator().manual_seed(14)
    l2 = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cases = []
    for name, kernel, k, bsz, vol, dt in LOSS_CASES:
        _, call, flops, nbytes, _ = loss_case(loss_of, g, dev, kernel, k, bsz, vol, dt)
        bound = 1e3 * max(flops / kernel_check.PEAK_FLOPS[torch.float32],
                          nbytes / kernel_check.HBM_BYTES_PER_S)
        cases.append((name, call, f"dice_ce_{kernel}", bound))
    for variant, path in paths.items():
        _build._lib = _build.load(path)
        loss_of._blocks.cache_clear()  # the grid follows the variant's occupancy
        for name, call, pattern, bound in cases:
            ms = kernel_check.device_ms(call, pattern, flush=l2.sum)
            result["times"].append({"variant": variant, "case": name, "device_ms": ms,
                                    "bound_ms": bound})
            print(f"[ablate] {variant:10s} {name:36s} {ms:8.4f} ms, bound {bound:.4f} ms "
                  f"({bound / ms:.0%} of it) [{card}]", flush=True)
    _build._lib = _build.load(paths["kernel"])
    loss_of._blocks.cache_clear()
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "ablate_loss.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
