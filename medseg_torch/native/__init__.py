"""The port's native host runtime: ctypes bindings for ``medseg_native.cc``.

A copy of the JAX package's C++/OpenMP library (gunzip, the Spacing
resamplers, intensity windowing, z-scoring, the foreground box) with the same
six Python functions. At first use ``g++`` builds the source beside this file
with the flags of the JAX package's Makefile into ``_build/``, under a name
that hashes the source, the flags, the compiler (its path and ``--version``)
and the host CPU (``-march=native`` makes the library specific to it); the
output is written under a temporary name and moved into place, so that
processes that start the build together each get a whole library. A failed
build (a missing ``zlib.h`` included) raises with g++'s stderr: the data chain
has no numpy fallback. Where the compiler driver cannot read ``libgomp.spec``
when it links with ``-fopenmp`` (a wrapped ``g++``), the source is compiled
with the same flags and linked with the OpenMP runtime by its soname,
``-l:libgomp.so.1``.

The library is loaded with ``ctypes.CDLL``, which releases the GIL for the
length of each call: this is what lets the loader's worker threads decode and
resample in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from functools import lru_cache
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "medseg_native.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# medseg/native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-fopenmp", "-std=c++17",
             "-Wall"]
LD_FLAGS = ["-shared", "-fopenmp", "-lz"]
GOMP_RUNTIME = "-l:libgomp.so.1"  # GNU OpenMP's runtime, where no libgomp.spec is found

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # time of the build this process ran, if any


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("g++ not found on PATH: the port's native library cannot be built")
    return found


@lru_cache(maxsize=None)
def _compiler_id(cxx: str) -> str:
    """The compiler's path and ``--version`` output."""
    proc = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return f"{cxx}\n{proc.stdout}"


def _cpu_features() -> str:
    """What ``-march=native`` reads: the CPU's model and feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [l for l in f if l.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return os.uname().machine


def library_path() -> Path:
    """Build the library if no build of this source, these flags, this
    compiler and this CPU exists; return its path."""
    global build_seconds
    cxx = _cxx()
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_compiler_id(cxx).encode())
    h.update(_cpu_features().encode())
    target = BUILD_DIR / f"libmedseg_native_{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{target.stem}.{os.getpid()}.{threading.get_ident()}.so.tmp"
    obj = tmp.with_suffix(".o")
    t0 = time.perf_counter()
    try:
        err = _run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS])
        if err is not None and "libgomp.spec" in err:
            # a wrapped driver that finds no libgomp.spec, which -fopenmp
            # reads when it links (nor the libgomp.so of -lgomp): compile with
            # the same flags, then link the OpenMP runtime by its soname
            err = _run([cxx, *CXX_FLAGS, "-c", str(SOURCE), "-o", str(obj)])
            if err is None:
                link = [f for f in LD_FLAGS if f != "-fopenmp"] + [GOMP_RUNTIME]
                err = _run([cxx, str(obj), "-o", str(tmp), *link])
        if err is not None:
            raise RuntimeError(err)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return target


def _run(cmd: list[str]) -> str | None:
    """None if the compiler command succeeds, else its command line and
    stderr."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode == 0:
        return None
    return f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"


def _typed(handle: ctypes.CDLL) -> ctypes.CDLL:
    c_ll, c_f, c_d = ctypes.c_longlong, ctypes.c_float, ctypes.c_double
    ptr_u8, ptr_f = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(c_f)
    ptr_d, ptr_ll = ctypes.POINTER(c_d), ctypes.POINTER(c_ll)
    handle.msn_inflate_gzip.restype = c_ll
    handle.msn_inflate_gzip.argtypes = [ptr_u8, c_ll, ptr_u8, c_ll]
    resample = [ptr_f, c_ll, c_ll, c_ll, c_ll, ptr_d, ptr_f, c_ll, c_ll, c_ll]
    for name in ("msn_trilinear_resample", "msn_nearest_resample"):
        getattr(handle, name).restype = None
        getattr(handle, name).argtypes = resample
    handle.msn_scale_intensity.restype = None
    handle.msn_scale_intensity.argtypes = [ptr_f, c_ll, c_f, c_f, c_f, c_f, ctypes.c_int]
    handle.msn_znorm_nonzero.restype = None
    handle.msn_znorm_nonzero.argtypes = [ptr_f, c_ll]
    handle.msn_foreground_bbox.restype = ctypes.c_int
    handle.msn_foreground_bbox.argtypes = [ptr_f, c_ll, c_ll, c_ll, c_ll, c_f, ptr_ll]
    return handle


def load() -> ctypes.CDLL:
    """The loaded library, built on the first call of the process."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _typed(ctypes.CDLL(str(library_path())))
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def inflate_gzip(data: bytes, out_size: int) -> bytes | None:
    """Decode a gzip (or zlib) stream of ``out_size`` bytes; None if it does
    not decode into that many."""
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(out_size, dtype=np.uint8)
    n = load().msn_inflate_gzip(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), out_size,
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def _resample(fn, src: np.ndarray, matrix: np.ndarray, out_shape) -> np.ndarray:
    src = np.ascontiguousarray(src, dtype=np.float32)
    m = np.ascontiguousarray(matrix, dtype=np.float64).reshape(12)
    out_shape = tuple(int(s) for s in out_shape)
    if src.ndim != 4 or len(out_shape) != 3:
        raise ValueError(f"resample: src must be (X, Y, Z, C) and out_shape three sizes, got "
                         f"{src.shape} -> {out_shape}")
    dst = np.empty(out_shape + (src.shape[3],), dtype=np.float32)
    fn(_fptr(src), *src.shape[:3], src.shape[3],
       m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _fptr(dst), *dst.shape[:3])
    return dst


def trilinear_resample(src: np.ndarray, matrix: np.ndarray, out_shape) -> np.ndarray:
    """src (X, Y, Z, C) float32; matrix 3x4 dst voxel -> src voxel; border
    clamped."""
    return _resample(load().msn_trilinear_resample, src, matrix, out_shape)


def nearest_resample(src: np.ndarray, matrix: np.ndarray, out_shape) -> np.ndarray:
    """As `trilinear_resample`, the nearest voxel (ties to even)."""
    return _resample(load().msn_nearest_resample, src, matrix, out_shape)


def scale_intensity(data: np.ndarray, a_min, a_max, b_min, b_max, clip=True) -> bool:
    """In-place windowed rescale of a C-contiguous float32 array; False (and
    nothing done) for any other array."""
    lib = load()
    if data.dtype != np.float32 or not data.flags.c_contiguous:
        return False
    lib.msn_scale_intensity(_fptr(data), data.size, a_min, a_max, b_min, b_max, int(clip))
    return True


def znorm_nonzero(data: np.ndarray) -> bool:
    """In-place z-score over the nonzero voxels of a C-contiguous float32
    array; False (and nothing done) for any other array."""
    lib = load()
    if data.dtype != np.float32 or not data.flags.c_contiguous:
        return False
    lib.msn_znorm_nonzero(_fptr(data), data.size)
    return True


def foreground_bbox(data: np.ndarray, threshold: float = 0.0):
    """``[x0, x1, y0, y1, z0, z1)`` of the voxels where any channel is above
    ``threshold`` (int64), or None if there is none."""
    lib = load()
    src = np.ascontiguousarray(data, dtype=np.float32)
    if src.ndim == 3:
        src = src[..., None]
    bbox = np.zeros(6, dtype=np.int64)
    found = lib.msn_foreground_bbox(
        _fptr(src), *src.shape[:3], src.shape[3], threshold,
        bbox.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    return bbox if found else None
