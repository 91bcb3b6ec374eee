"""Where K3's and K4's tensor-core time goes (``csrc/outhead_tc.cu``), on one
NVIDIA GPU:

    python -m medseg_torch.tools.ablate_outhead_tc [--variants NAME,...]

- builds the kernel library and variants of it in which ``outhead_tc.cu``
  is compiled with extra flags (``VARIANTS``): the copy-only kernels
  (``MEDSEG_OUTHEAD_ABLATE=1``: the same copies of z, res and the blend
  weight, the same shared memory and exits, K3's stores and K4's
  read-modify-write of the accumulator, but no combine and no MMA), the
  same without the exits' global accesses (=2) and everything but the
  copies (=3). It times the bf16 K3 and K4 cases of ``tools/time_routes.py``
  through their wrappers on each (CUDA events; an ablated variant's results
  are wrong by design, only its times are read), beside each case's bound;
- prints ``nvcc -Xptxas -v`` of ``outhead_tc.cu`` per instantiation
  (registers, spill stores).

Writes ``chiprun_out/ablate_outhead_tc.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from medseg_torch.kernels import _build, conv_of, kernel_check
from medseg_torch.tools.ablate_conv_tc import build_variants, spills
from medseg_torch.tools.time_routes import HEAD_CASES, head_case

VARIANTS = {  # name -> extra nvcc flags of outhead_tc.cu
    "copy only": ["-DMEDSEG_OUTHEAD_ABLATE=1"],
    "copy no exit": ["-DMEDSEG_OUTHEAD_ABLATE=2"],
    "no copies": ["-DMEDSEG_OUTHEAD_ABLATE=3"],
}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_outhead_tc: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="the variants to build")
    names = ap.parse_args().variants.split(",")
    dev = torch.device("cuda", 0)
    paths, report = build_variants("outhead_tc.cu", {n: VARIANTS[n] for n in names})
    result = {"card": card, "ptxas": spills(report), "times": []}
    for r in result["ptxas"]:
        print(f"[ptxas] {r['kernel']}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} B spill stores [{card}]", flush=True)
    g = torch.Generator().manual_seed(13)
    cases = []
    for name, kernel, c, k, batch, edge, dt, acc_dtype in HEAD_CASES:
        if dt != torch.bfloat16:
            continue

        def rand(*shape, scale=1.0, dt=dt):
            return (torch.randn(shape, generator=g) * scale).to(dev, dt)

        _, call, _, nbytes = head_case(conv_of, rand, g, dev, kernel, c, k, batch, edge, acc_dtype)
        cases.append((name, call, 1e3 * nbytes / kernel_check.HBM_BYTES_PER_S))
    for variant, path in paths.items():
        _build._lib = _build.load(path)
        for name, call, bound in cases:
            ms = kernel_check.time_ms(call)
            result["times"].append({"variant": variant, "case": name, "ms": ms,
                                    "bound_ms": bound})
            print(f"[ablate] {variant:18s} {name:44s} {ms:8.3f} ms, bound {bound:.3f} ms "
                  f"({bound / ms:.0%} of it) [{card}]", flush=True)
    _build._lib = _build.load(paths["kernel"])
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "ablate_outhead_tc.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
