"""Where the tensor-core conv's time goes (``csrc/conv_tc.cu``), on one
NVIDIA GPU:

    python -m medseg_torch.tools.ablate_conv_tc

- builds the kernel library, then two variants of it in which
  ``conv_tc.cu`` is compiled with ``MEDSEG_TC_ABLATE`` 1 (no MMAs: the
  staging, the waits and the epilogue remain) and 2 (also no channels-last
  staging: the halo copy alone, by cp.async or into registers), and
  times K5, K9 and K1 through their wrappers on each (CUDA events, bf16, the
  main path's shapes; the ablated outputs are wrong by design, only their
  times are read);
- prints ``nvcc -Xptxas -v`` of ``conv_tc.cu`` per instantiation
  (registers, spill stores);
- prints each route's launch plan (``medseg_conv_tc_plan``): blocks and
  warps per SM, shared memory per block, whether the weights are resident.

Writes ``chiprun_out/ablate_conv_tc.json``.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from medseg_torch.kernels import _build, conv_flat, conv_of
from medseg_torch.kernels.kernel_check import time_ms

VARIANTS = {0: "kernel", 1: "no MMA", 2: "halo copy only"}
# (name, wrapper, C, C_out, batch, edge, W): K5's C counts both streams
CASES = [
    ("K5 (32+32)->32 @4x48^3", "cat2", 64, 32, 4, 48, 48),
    ("K5 (64+64)->64 @4x48^3", "cat2", 128, 64, 4, 48, 48),
    ("K5 (32+32)->32 @4x48^2x46 (register staging)", "cat2", 64, 32, 4, 48, 46),
    ("K9 128->64 @4x48^3", "flat", 128, 64, 4, 48, 48),
    ("K9 32->16 @4x96^3", "flat", 32, 16, 4, 96, 96),
    ("K1 16->16 affine @4x96^3 (register staging)", "affine_leaky", 16, 16, 4, 96, 96),
]
# (label, mode, residual, C_out, staging, C, Cx) of each launch plan
PLANS = [
    ("K5 (32+32)->32 async", "cat2", 1, 32, 1, 64, 0),
    ("K5 (32+32)->32 registers", "cat2", 1, 32, 0, 64, 0),
    ("K5 (64+64)->64 async", "cat2", 1, 64, 1, 128, 0),
    ("K5 (64+64)->64 registers", "cat2", 1, 64, 0, 128, 0),
    ("K9 128->64 async", "flat", 0, 64, 1, 128, 0),
    ("K9 128->64 registers", "flat", 0, 64, 0, 128, 0),
    ("K9 32->16 async", "flat", 0, 16, 1, 32, 0),
    ("K9 64->32 async", "flat", 0, 32, 1, 64, 0),
    ("K1 16->16 affine", "affine_leaky", 0, 16, 0, 16, 0),
    ("K2 (16+16)->16 x1", "combine", 1, 16, 0, 32, 1),
]


def build_variants(source: str = "conv_tc.cu",
                   variants: dict | None = None) -> tuple[dict[str, Path], str]:
    """The library (``"kernel"``) and its variants, ``source`` compiled with
    each variant's extra nvcc flags (the other sources compiled once), and
    ptxas's report of ``source``, built in one parallel batch."""
    variants = variants or {name: [f"-DMEDSEG_TC_ABLATE={n}"] for n, name in VARIANTS.items() if n}
    paths = {"kernel": _build.library_path()}
    nvcc, flags, out = _build._nvcc(), _build.NVCC_FLAGS, _build.BUILD_DIR
    sources = sorted(_build.CSRC.glob("*.cu"))
    tc = _build.CSRC / source
    common = [out / f"ablate.{s.stem}.o" for s in sources if s != tc]
    cmds = [[nvcc, *flags, "-c", "-o", str(o), str(s)]
            for s, o in zip([s for s in sources if s != tc], common)]
    objects = {name: out / f"ablate{n}.{tc.stem}.o" for n, name in enumerate(variants)}
    for name, extra in variants.items():
        cmds.append([nvcc, *flags, *extra, "-c", "-o", str(objects[name]), str(tc)])
    ptxas = [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(out / f"ptxas.{tc.stem}.o"), str(tc)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds + [ptxas]]
    errs = [p.communicate()[1] for p in procs]
    for cmd, p, err in zip(cmds + [ptxas], procs, errs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
    links = []
    for n, name in enumerate(variants):
        paths[name] = out / f"libmedseg_kernels_{tc.stem}_ablate{n}.so"
        links.append([nvcc, *flags, "-shared", "-o", str(paths[name]), str(objects[name]),
                      *map(str, common)])
    _build._run_all(links)
    return paths, errs[-1]


def spills(report: str) -> list[dict]:
    """Per kernel of ptxas's report: registers, spill stores and loads,
    static shared memory."""
    demangle = shutil.which("cu++filt") or str(Path(_build._nvcc()).parent / "cu++filt")
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            rows.append({"kernel": name})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows and rows[-1]["kernel"] == name:
            rows[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == name:
            rows[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                rows[-1]["smem"] = int(m.group(1))
    if Path(demangle).exists():
        names = subprocess.run([demangle], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["kernel"] = n
    return [r for r in rows if "kernel<" in r["kernel"] or "_kernel" in r["kernel"]]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_conv_tc: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    paths, report = build_variants()
    result = {"card": card, "ptxas": spills(report), "plans": [], "times": []}
    for r in result["ptxas"]:
        print(f"[ptxas] {r['kernel']}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} B spill stores [{card}]", flush=True)
    lib = _build.load(paths["kernel"])
    for label, mode, res, c_out, staging, c, cx in PLANS:
        plan = (ctypes.c_int * 4)()
        _build.check(lib.medseg_conv_tc_plan(0, conv_of._MODES[mode], res, c_out, staging, c, cx,
                                             plan), label)
        per_sm, threads, smem, resident = list(plan)
        row = {"route": label, "blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32,
               "threads": threads, "smem": smem, "resident": bool(resident)}
        result["plans"].append(row)
        print(f"[plan] {label:26s} {per_sm} block(s) x {threads // 32} warps per SM, {smem} B "
              f"shared, weights {'resident' if resident else 'streamed'} [{card}]", flush=True)
    g = torch.Generator().manual_seed(12)
    bf = torch.bfloat16
    inputs = []
    for name, mode, c, c_out, bsz, edge, w in CASES:
        def rand(*shape, scale=1.0, dt=bf):
            return (torch.randn(shape, generator=g) * scale).to(dev, dt)

        wt = rand(c_out, c, 3, 3, 3, scale=(27 * c) ** -0.5)
        vol = (edge, edge, w)
        if mode == "cat2":
            args = (rand(bsz, c // 2, *vol), rand(bsz, c // 2, *vol), wt,
                    rand(c_out, c, 1, 1, 1, scale=c ** -0.5))
            fn = conv_of.conv3x3x3_of_cat2
        elif mode == "flat":
            args, fn = (rand(bsz, c, *vol), wt), conv_flat.conv3x3x3_flat
        else:
            a = (torch.rand((bsz, c), generator=g) + 0.5).to(dev)
            args = (rand(bsz, c, *vol), wt, a, rand(bsz, c, dt=torch.float32))
            fn = conv_of.conv3x3x3_of
        inputs.append((name, fn, args))
    for variant, path in paths.items():
        _build._lib = _build.load(path)
        for name, fn, args in inputs:
            ms = time_ms(lambda: fn(*args))
            result["times"].append({"variant": variant, "case": name, "ms": ms})
            print(f"[ablate] {variant:15s} {name:46s} {ms:8.3f} ms [{card}]", flush=True)
    _build._lib = _build.load(paths["kernel"])
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "ablate_conv_tc.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
