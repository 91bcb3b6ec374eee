"""Deterministic preprocessing transforms, host side (a copy of the host
chain of ``medseg/data/transforms.py``). ``respace`` resamples through the
port's C++/OpenMP library ``medseg_torch/native``, as the JAX package's does
through ``medseg/native``; the numpy samplers ``_trilinear_sample`` and
``_nearest_sample`` (`plain_resample`) are its plain versions, which the tests
and ``chip_smoke.py`` hold the library to.

Capability contracts are the MONAI 0.6 transforms the reference composes:

- ``LoadImaged`` -> `load` (the NIfTI reader of ``data/nifti.py``)
- ``AddChanneld`` / ``EnsureChannelFirstd`` -> `ensure_channel` (channels
  LAST, as in the JAX package)
- ``Orientationd(axcodes="RAS")`` -> `orient_ras`
- ``Spacingd(pixdim, mode=("bilinear","nearest"))`` -> `respace`
- ``ScaleIntensityRanged(a_min,a_max,b_min,b_max,clip)`` -> `scale_intensity_range`
- ``NormalizeIntensityd(nonzero=True, channel_wise=True)`` -> `normalize_intensity`
- ``CropForegroundd(source_key="image")`` -> `crop_foreground`
- ``ConvertToMultiChannelBasedOnBratsClassesd`` -> `brats_to_multichannel`

Sample dicts carry ``image``/``label`` arrays plus ``image_affine`` etc.,
mirroring MONAI's meta-dict convention. ``ops/resample.py`` holds the device
half of the validation chain.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from medseg_torch import native
from medseg_torch.data.nifti import read_nifti


# ---------------------------------------------------------------------------
# loading / layout
# ---------------------------------------------------------------------------

def load(sample: dict, keys: Sequence[str] = ("image", "label")) -> dict:
    """LoadImaged: read NIfTI files at ``sample[key]`` paths into arrays with
    ``{key}_affine`` and ``{key}_path`` metadata."""
    out = dict(sample)
    for key in keys:
        if key not in sample:
            continue
        img = read_nifti(sample[key], dtype=np.float32)
        out[key] = img.data
        out[f"{key}_affine"] = img.affine
        out[f"{key}_path"] = sample[key]
    return out


def ensure_channel(sample: dict, keys: Sequence[str] = ("image", "label")) -> dict:
    """AddChanneld/EnsureChannelFirstd equivalent for channels-last layout:
    3D (X,Y,Z) -> (X,Y,Z,1); 4D NIfTI (X,Y,Z,C) stays channels-last."""
    out = dict(sample)
    for key in keys:
        if key in out and out[key].ndim == 3:
            out[key] = out[key][..., None]
    return out


# ---------------------------------------------------------------------------
# orientation
# ---------------------------------------------------------------------------

def _io_orientation(affine: np.ndarray):
    """Axis/flip map from a voxel->world affine — nibabel ``io_orientation``'s
    exact algorithm (MONAI 0.6 ``Orientationd`` delegates to it): normalize
    the rotation-zoom block by column norms, take the closest shearless
    (orthogonal) matrix via SVD polar decomposition, then assign each input
    axis IN ORDER to the output axis of largest |component|, zeroing that
    output row so later input axes can't reuse it. The in-order/zeroing rule
    (not a global greedy) is what matches nibabel on oblique affines."""
    rzs = affine[:3, :3]
    zooms = np.sqrt(np.sum(rzs * rzs, axis=0))
    zooms[zooms == 0] = 1.0
    rs = rzs / zooms
    p_mat, s, qs = np.linalg.svd(rs)
    tol = s.max() * max(rs.shape) * np.finfo(s.dtype).eps
    keep = s > tol
    r_mat = np.dot(p_mat[:, keep], qs[keep])
    out = np.zeros((3, 2), dtype=np.int64)
    for in_ax in range(3):
        col = r_mat[:, in_ax]
        if np.allclose(col, 0):
            out[in_ax] = (in_ax, 1)  # degenerate axis: leave in place
            continue
        out_ax = int(np.argmax(np.abs(col)))
        out[in_ax] = (out_ax, -1 if col[out_ax] < 0 else 1)
        r_mat[out_ax, :] = 0
    return out


def orient_ras(sample: dict, keys: Sequence[str] = ("image", "label")) -> dict:
    """Orientationd(axcodes="RAS"): permute/flip voxel axes so axis 0 points
    Right, axis 1 Anterior, axis 2 Superior; update the affine accordingly."""
    out = dict(sample)
    for key in keys:
        if key not in out or f"{key}_affine" not in out:
            continue
        data = out[key]
        affine = np.asarray(out[f"{key}_affine"], dtype=np.float64)
        ornt = _io_orientation(affine)
        spatial_shape = data.shape[:3]

        # flip axes with negative direction
        flips = [int(ax) for ax, (_, sign) in enumerate(ornt) if sign < 0]
        if flips:
            data = np.flip(data, axis=flips)
        # permute so data axis k maps to world axis k
        perm = np.argsort(ornt[:, 0])
        extra = list(range(3, data.ndim))
        data = np.transpose(data, list(perm) + extra)

        # rebuild the affine: T = old_affine @ inv(transform applied to voxels)
        t_flip = np.eye(4)
        for ax in flips:
            t_flip[ax, ax] = -1.0
            t_flip[ax, 3] = spatial_shape[ax] - 1
        t_perm = np.zeros((4, 4))
        t_perm[3, 3] = 1.0
        for new_ax, old_ax in enumerate(perm):
            t_perm[old_ax, new_ax] = 1.0
        out[key] = np.ascontiguousarray(data)
        out[f"{key}_affine"] = affine @ t_flip @ t_perm
    return out


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

def _trilinear_sample(vol: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Sample (X,Y,Z,C) volume at float voxel coords (..., 3), border-clamped
    (torch grid_sample padding_mode="border" — the MONAI Spacing default)."""
    shape = np.array(vol.shape[:3])
    c = np.clip(coords, 0.0, (shape - 1).astype(np.float64))
    c0 = np.floor(c).astype(np.int64)
    c1 = np.minimum(c0 + 1, shape - 1)
    w = c - c0
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = (
                    c1[..., 0] if dx else c0[..., 0],
                    c1[..., 1] if dy else c0[..., 1],
                    c1[..., 2] if dz else c0[..., 2],
                )
                weight = (
                    (w[..., 0] if dx else 1 - w[..., 0])
                    * (w[..., 1] if dy else 1 - w[..., 1])
                    * (w[..., 2] if dz else 1 - w[..., 2])
                )
                term = vol[idx] * weight[..., None]
                out = term if out is None else out + term
    return out


def _nearest_sample(vol: np.ndarray, coords: np.ndarray) -> np.ndarray:
    shape = np.array(vol.shape[:3])
    idx = np.clip(np.round(coords), 0, shape - 1).astype(np.int64)
    return vol[idx[..., 0], idx[..., 1], idx[..., 2]]


def plain_resample(data: np.ndarray, matrix: np.ndarray, out_shape, mode: str) -> np.ndarray:
    """The numpy version of the library's resamplers: ``data`` (X, Y, Z[, C])
    sampled at ``matrix`` (3x4, output voxel -> input voxel) over the output
    grid, ``mode`` "nearest" or "trilinear"."""
    grid = np.stack(
        np.meshgrid(*[np.arange(int(s)) for s in out_shape], indexing="ij"), axis=-1
    ).astype(np.float64)
    coords = grid @ matrix[:3, :3].T + matrix[:3, 3]
    if mode == "nearest":
        return _nearest_sample(data, coords)
    if data.ndim == 3:  # _trilinear_sample expects a channel dim
        return _trilinear_sample(data[..., None], coords)[..., 0].astype(data.dtype)
    return _trilinear_sample(data, coords).astype(data.dtype)


def _native_resample(data: np.ndarray, matrix: np.ndarray, out_shape, mode: str) -> np.ndarray:
    """The library's resampler for ``mode`` on (X, Y, Z[, C]) data, float32
    out (the JAX package's ``_native_resample``)."""
    squeeze = data.ndim == 3
    src = np.ascontiguousarray(data[..., None] if squeeze else data, dtype=np.float32)
    if mode == "nearest":
        out = native.nearest_resample(src, matrix, out_shape)
    else:
        out = native.trilinear_resample(src, matrix, out_shape)
    return out[..., 0] if squeeze else out


def _zoom_affine(affine: np.ndarray, pixdim: np.ndarray) -> np.ndarray:
    """MONAI 0.6 ``zoom_affine(affine, scale, diagonal=False)``: keep the
    rotation (shear removed via Cholesky polar split rzs = R @ ZS), set the
    zooms to ``pixdim`` with the original diagonal signs, zero translation."""
    rzs = affine[:3, :3]
    zs = np.linalg.cholesky(rzs.T @ rzs).T
    rotation = rzs @ np.linalg.inv(zs)
    s = np.sign(np.diag(zs)) * np.abs(pixdim)
    new_affine = np.eye(4)
    new_affine[:3, :3] = rotation @ np.diag(s)
    return new_affine


def _compute_shape_offset(
    spatial_shape, in_affine: np.ndarray, out_affine: np.ndarray
):
    """MONAI 0.6 ``compute_shape_offset``: map the 8 input-corner voxel
    coordinates through in_affine then inv(out_affine); output shape is
    ``np.round(ptp(corners) + 1)`` per dim (NOT round(in*old/new) — for
    10 voxels at 1.5mm -> 1mm this gives 14, not 15). The output origin is
    the world coordinate of the input corner that is minimal in output voxel
    space; if no single corner is minimal (strongly oblique), center-align."""
    shape = np.asarray(spatial_shape, dtype=np.float64)
    corners_v = np.stack(
        np.meshgrid(*[(0.0, d - 1.0) for d in shape], indexing="ij"), axis=0
    ).reshape(3, -1)
    corners_v = np.concatenate([corners_v, np.ones((1, corners_v.shape[1]))])
    corners_w = in_affine @ corners_v  # world coords (homogeneous)
    corners_out = np.linalg.inv(out_affine) @ corners_w
    corners_out = corners_out[:-1] / corners_out[-1]
    out_shape = np.round(np.ptp(corners_out, axis=1) + 1.0)
    offset = None
    for i in range(corners_w.shape[1]):
        min_corner = np.min(corners_out - corners_out[:, i : i + 1], axis=1)
        if np.allclose(min_corner, 0.0, rtol=1e-3):
            offset = corners_w[:-1, i]
            break
    if offset is None:  # center-aligned fallback
        center_out = out_affine[:3, :3] @ ((out_shape - 1.0) / 2.0)
        offset = corners_w[:-1].mean(axis=1) - center_out
    return out_shape.astype(np.int64), offset


def respace(
    sample: dict,
    pixdim: Sequence[float] = (1.0, 1.0, 1.0),
    keys: Sequence[str] = ("image", "label"),
    modes: Sequence[str] = ("trilinear", "nearest"),
) -> dict:
    """Spacingd: resample to isotropic voxel spacing.

    Exact MONAI 0.6 ``Spacing`` semantics (`unetr_segmentation_3d.py:326-330`;
    SURVEY.md §7 names this THE Dice-parity risk): target affine from
    ``zoom_affine`` (rotation kept, shear removed, zooms = pixdim), output
    shape and origin from ``compute_shape_offset`` (corner-based), sampling
    through the voxel->voxel affine with border clamping — image trilinear,
    label nearest, through the C++/OpenMP library (float32 out). Cross-checked
    against torch ``grid_sample`` (MONAI's backend) in
    tests/test_spacing_golden_torch.py.
    """
    out = dict(sample)
    pixdim = np.asarray(pixdim, dtype=np.float64)
    for key, mode in zip(keys, modes):
        if key not in out or f"{key}_affine" not in out:
            continue
        data = out[key]
        affine = np.asarray(out[f"{key}_affine"], dtype=np.float64)
        in_shape = np.array(data.shape[:3])
        new_affine = _zoom_affine(affine, pixdim)
        new_shape, offset = _compute_shape_offset(in_shape, affine, new_affine)
        new_affine[:3, 3] = offset

        # output voxel -> input voxel coordinate map (affine composition)
        inv_old = np.linalg.inv(affine)
        m = inv_old @ new_affine  # 4x4: new voxel -> old voxel
        if np.array_equal(new_shape, in_shape) and np.allclose(m, np.eye(4)):
            continue  # resample would be the identity
        res = _native_resample(data, m[:3, :], new_shape, mode)
        out[key] = np.ascontiguousarray(res)
        out[f"{key}_affine"] = new_affine
    return out


# ---------------------------------------------------------------------------
# intensity
# ---------------------------------------------------------------------------

def scale_intensity_range(
    sample: dict,
    a_min: float = -175.0,
    a_max: float = 250.0,
    b_min: float = 0.0,
    b_max: float = 1.0,
    clip: bool = True,
    keys: Sequence[str] = ("image",),
) -> dict:
    """ScaleIntensityRanged: linear [a_min,a_max] -> [b_min,b_max] with clip
    (CT windowing, `unetr_segmentation_3d.py:332-339`)."""
    out = dict(sample)
    scale = (b_max - b_min) / (a_max - a_min)
    for key in keys:
        img = out[key].astype(np.float32)
        img = (img - a_min) * scale + b_min
        if clip:
            img = np.clip(img, b_min, b_max)
        out[key] = img
    return out


def normalize_intensity(
    sample: dict,
    nonzero: bool = True,
    channel_wise: bool = True,
    keys: Sequence[str] = ("image",),
) -> dict:
    """NormalizeIntensityd: z-score over (nonzero) voxels, per channel
    (MRI path, `unetr_segmentation_3d.py:456`)."""
    out = dict(sample)
    for key in keys:
        img = out[key].astype(np.float32)
        if not channel_wise:
            img = _znorm(img, nonzero)
        else:
            chans = [_znorm(img[..., c], nonzero) for c in range(img.shape[-1])]
            img = np.stack(chans, axis=-1)
        out[key] = img
    return out


def _znorm(x: np.ndarray, nonzero: bool) -> np.ndarray:
    mask = x != 0 if nonzero else np.ones_like(x, dtype=bool)
    if not mask.any():
        return x
    vals = x[mask]
    mean, std = vals.mean(), vals.std()
    if std == 0:
        std = 1.0
    y = x.copy()
    y[mask] = (vals - mean) / std
    return y


# ---------------------------------------------------------------------------
# cropping / labels
# ---------------------------------------------------------------------------

def crop_foreground(
    sample: dict,
    source_key: str = "image",
    keys: Sequence[str] = ("image", "label"),
    margin: int = 0,
) -> dict:
    """CropForegroundd: crop all keys to the bounding box of
    ``source > 0`` (`unetr_segmentation_3d.py:340`)."""
    out = dict(sample)
    src = out[source_key]
    fg = src > 0
    if fg.ndim == 4:
        fg = fg.any(axis=-1)
    if not fg.any():
        return out
    coords = np.nonzero(fg)
    starts = [max(int(c.min()) - margin, 0) for c in coords]
    stops = [min(int(c.max()) + 1 + margin, s) for c, s in zip(coords, fg.shape)]
    sl = tuple(slice(a, b) for a, b in zip(starts, stops))
    for key in keys:
        if key in out:
            out[key] = np.ascontiguousarray(out[key][sl])
    out["foreground_start"] = np.asarray(starts, dtype=np.int64)
    return out


def brats_to_multichannel(sample: dict, key: str = "label") -> dict:
    """ConvertToMultiChannelBasedOnBratsClassesd. A sample without ``key``
    (an image to segment, no label) passes unchanged; the JAX chain raises
    KeyError there, so its MRI inference chain cannot run."""
    out = dict(sample)
    if key not in out:
        return out
    label = out[key]
    if label.ndim == 4 and label.shape[-1] == 1:
        label = label[..., 0]
    bg = label == 0
    tc = (label == 2) | (label == 3)
    wt = (label == 1) | (label == 2) | (label == 3)
    et = label == 3
    out[key] = np.stack([bg, tc, wt, et], axis=-1).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

class Compose:
    """Minimal MONAI-style Compose over ``sample -> sample`` callables."""

    def __init__(self, transforms) -> None:
        self.transforms = list(transforms)

    def __call__(self, sample: dict) -> dict:
        for t in self.transforms:
            sample = t(sample)
        return sample
