"""NIfTI-1 image I/O in numpy and gzip (a copy of ``medseg/data/nifti.py``
without its optional C++ gunzip accelerator, ``medseg/native``).

Implements the NIfTI-1 standard (348-byte header, single-file ``.nii``
magic ``n+1``): dims, dtype, pixdim, scl_slope/scl_inter scaling, and the
affine from sform (preferred), qform quaternion, or pixdim fallback, the same
precedence nibabel applies for these files.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray  # spatial array, (X, Y, Z) or (X, Y, Z, T/C)
    affine: np.ndarray  # 4x4 voxel -> world (RAS+ mm)
    filename: str | None = None

    @property
    def spacing(self) -> np.ndarray:
        return np.linalg.norm(self.affine[:3, :3], axis=0)


def _quaternion_to_rotation(b: float, c: float, d: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )


def _parse_header(hdr: bytes):
    if len(hdr) < HEADER_SIZE:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr != HEADER_SIZE:
        raise ValueError(f"not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    magic = hdr[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    dim = struct.unpack_from("<8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack_from("<h", hdr, 70)[0]
    bitpix = struct.unpack_from("<h", hdr, 72)[0]
    pixdim = struct.unpack_from("<8f", hdr, 76)
    vox_offset = struct.unpack_from("<f", hdr, 108)[0]
    scl_slope = struct.unpack_from("<f", hdr, 112)[0]
    scl_inter = struct.unpack_from("<f", hdr, 116)[0]
    qform_code = struct.unpack_from("<h", hdr, 252)[0]
    sform_code = struct.unpack_from("<h", hdr, 254)[0]
    quatern = struct.unpack_from("<6f", hdr, 256)  # b, c, d, x, y, z
    srow = np.array(struct.unpack_from("<12f", hdr, 280)).reshape(3, 4)

    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype])
    if dtype.itemsize * 8 != bitpix:
        raise ValueError(f"bitpix {bitpix} inconsistent with dtype {dtype}")

    affine = np.eye(4)
    if sform_code > 0:
        affine[:3, :] = srow
    elif qform_code > 0:
        rot = _quaternion_to_rotation(*quatern[:3])
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine[:3, :3] = rot * zooms
        affine[:3, 3] = quatern[3:]
    else:
        affine[:3, :3] = np.diag(pixdim[1:4])

    return shape, dtype, float(vox_offset), float(scl_slope), float(scl_inter), affine


def _read_bytes(path: str) -> bytes:
    """File bytes, gunzipped if needed."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] != b"\x1f\x8b":
        return blob
    return gzip.decompress(blob)


def read_nifti(path: str, *, dtype: np.dtype | None = None) -> NiftiImage:
    """Read a ``.nii`` / ``.nii.gz`` volume.

    Applies scl_slope/scl_inter scaling when nontrivial (output float32 then).
    Data is returned in on-disk (Fortran spatial) order as (X, Y, Z[, C]),
    matching what the reference pipeline gets from NiBabel's ``get_fdata``.
    """
    raw = _read_bytes(path)
    shape, disk_dtype, vox_offset, slope, inter, affine = _parse_header(raw[:HEADER_SIZE])
    count = int(np.prod(shape))
    offset = int(vox_offset) if vox_offset else HEADER_SIZE + 4
    data = np.frombuffer(raw, dtype=disk_dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data.astype(np.float32) * (slope if slope != 0.0 else 1.0) + inter
    if dtype is not None:
        data = data.astype(dtype, copy=False)
    return NiftiImage(data=np.ascontiguousarray(data), affine=affine, filename=path)


def write_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None) -> None:
    """Write a single-file NIfTI-1 (.nii or .nii.gz) with an sform affine."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    affine = np.eye(4) if affine is None else np.asarray(affine, dtype=np.float64)
    ndim = data.ndim
    if ndim > 7:
        raise ValueError("too many dimensions for NIfTI-1")
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    zooms = np.linalg.norm(affine[:3, :3], axis=0)
    pixdim = [1.0, float(zooms[0]), float(zooms[1]), float(zooms[2])] + [1.0] * 4
    pixdim = pixdim[:8]

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code: scanner
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"

    body = bytes(hdr) + b"\x00\x00\x00\x00" + np.asfortranarray(data).tobytes(order="F")
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(body)
    else:
        with open(path, "wb") as f:
            f.write(body)
