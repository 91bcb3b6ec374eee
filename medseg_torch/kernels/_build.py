"""Build and load the port's CUDA library.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds, not
minutes), under ``_build/`` beside this file, named by the hash of the
sources so that a change of any source rebuilds it. The library is loaded
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
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # device, bf16, mode, residual, c_out, x0, x1, x2, a0, b0, a1, b1, w, wres,
    # out, s, ss, res, rs, rss, B, C, Ch, Cx, D, H, W, stream
    "medseg_conv3x3x3": [_I] * 5 + [_P] * 15 + [_I] * 7 + [_P],
    # device, bf16, scaled, z, r, az, bz, ar, br, kout, bias, scale, out, B,
    # C, K, V, stream
    "medseg_outhead": [_I] * 3 + [_P] * 10 + [_I] * 3 + [ctypes.c_longlong, _P],
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


def library_path() -> Path:
    """Build the library if its sources changed; return its path."""
    global build_seconds
    target = BUILD_DIR / f"libmedseg_kernels_{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0
    return target


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.medseg_error_string.argtypes = [ctypes.c_int]
        handle.medseg_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().medseg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
