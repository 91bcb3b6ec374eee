"""Build and load the port's CUDA library.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into an object, one
process per source, all started together, and links the objects into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds, not minutes), under ``_build/`` beside this file, named by the
hash of the sources so that a change of any source rebuilds it. The library is loaded
with ``ctypes``; every pointer and the stream pass as ``c_void_p``. Each C
entry point returns a ``cudaError_t`` value, which ``check`` turns into an
exception. A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # device, bf16, mode, residual, c_out, x0, x1, x2, a0, b0, a1, b1, w, wres,
    # out, s, ss, res, rs, rss, part, slots, B, C, Ch, Cx, D, H, W, stream
    "medseg_conv3x3x3": [_I] * 5 + [_P] * 16 + [_I] * 8 + [_P],
    # device, bf16, scaled, z, r, az, bz, ar, br, kout, bias, scale, out, B,
    # C, K, V, stream
    "medseg_outhead": [_I] * 3 + [_P] * 10 + [_I] * 3 + [ctypes.c_longlong, _P],
    # device, bf16, acc_bf16, z, r, az, bz, ar, br, kout, bias, scale, acc,
    # B, C, K, rd, rh, rw, Dp, Hp, Wp, starts, box0, box, stream
    "medseg_outhead_row": [_I] * 3 + [_P] * 10 + [_I] * 9 + [_P] * 4,
    # device, z, r, az, bz, ar, br, kout, bias, scale, out, B, C, K, V, stream
    "medseg_outhead_tc": [_I] + [_P] * 10 + [_I] * 3 + [ctypes.c_longlong, _P],
    # device, acc_bf16, z, r, az, bz, ar, br, kout, bias, scale, acc, B, C, K,
    # rd, rh, rw, Dp, Hp, Wp, starts, box0, box, stream
    "medseg_outhead_row_tc": [_I] * 2 + [_P] * 10 + [_I] * 9 + [_P] * 4,
    # device, bf16, c_out, x, g, partial, dw, B, C, D, H, W, groups, stream
    "medseg_wgrad": [_I] * 3 + [_P] * 4 + [_I] * 6 + [_P],
    # device, mode, residual, c_out, staging, x0, x1, x2, a0, b0, a1, b1,
    # w_packed, wres_packed, out, s, ss, res, rs, rss, part, slots, B, C, Cx,
    # D, H, W, stream
    "medseg_conv_tc": [_I] * 5 + [_P] * 16 + [_I] * 7 + [_P],
    # device, mode, residual, c_out, staging, C, Cx, plan (4 ints out)
    "medseg_conv_tc_plan": [_I] * 7 + [_P],
    # device, c_out, x, g, partial, dw, B, C, D, H, W, groups, stream
    "medseg_wgrad_tc": [_I] * 2 + [_P] * 4 + [_I] * 6 + [_P],
    # device, residual, c_out, x, w_packed, wres_packed, out, s, ss, res, rs,
    # rss, part, slots, B, C, D, H, W, stream
    "medseg_conv_narrow": [_I] * 3 + [_P] * 10 + [_I] * 6 + [_P],
    # device, c_out, x, g, partial, dw, B, C, D, H, W, groups, stream
    "medseg_wgrad_narrow": [_I] * 2 + [_P] * 4 + [_I] * 6 + [_P],
    # device, which (0 forward, 1 filter gradient), residual, c_out, C,
    # per_sm (1 int out)
    "medseg_narrow_plan": [_I] * 5 + [_P],
    # device, bf16, co_tile, x, w, out, B, C, C_out, D, H, W, stream
    "medseg_conv_flat": [_I] * 3 + [_P] * 3 + [_I] * 6 + [_P],
    # device, which (0 sums, 1 bwd), bf16, K, B, V, blocks (1 int out)
    "medseg_dice_ce_grid": [_I] * 5 + [ctypes.c_longlong, _P],
    # device, bf16, logits, labels, out, partial, B, K, V, vec, blocks, stream
    "medseg_dice_ce_sums": [_I] * 2 + [_P] * 4 + [_I] * 2 + [ctypes.c_longlong, _I, _I, _P],
    # device, bf16, logits, labels, ca, cb, cec, dlogits, B, K, V, vec, blocks, stream
    "medseg_dice_ce_bwd": [_I] * 2 + [_P] * 6 + [_I] * 2 + [ctypes.c_longlong, _I, _I, _P],
    # device, bf16, act, res, x, r, gamma, beta, y, mean, rstd, part, B, C, V,
    # nchunks, threads, eps, vec, stream
    "medseg_instnorm_fwd": [_I] * 4 + [_P] * 8 + [_I, _I, ctypes.c_longlong, _I, _I,
                                                  ctypes.c_float, _I, _P],
    # device, bf16, act, res, dy, x, r, mean, rstd, gamma, beta, part, dx, dr,
    # dgamma, dbeta, B, C, V, nchunks, vec, stream
    "medseg_instnorm_bwd": [_I] * 4 + [_P] * 12 + [_I, _I, ctypes.c_longlong, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # time of the build this process ran, if any


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (neither on PATH nor under $CUDA_HOME/bin)")


def _run_all(cmds: list[list[str]]) -> None:
    """Runs the commands in parallel; raises with the stderr of each failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))


def library_path() -> Path:
    """Build the library if its sources changed; return its path."""
    global build_seconds
    target = BUILD_DIR / f"libmedseg_kernels_{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{target.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources, objects)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
        os.replace(tmp, target)
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return target


def load(path: Path) -> ctypes.CDLL:
    """A built library, its entry points typed."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.medseg_error_string.argtypes = [ctypes.c_int]
    handle.medseg_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = load(library_path())
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().medseg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
