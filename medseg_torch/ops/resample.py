"""Device half of the validation preprocessing: ``Spacingd`` resampling,
RAS orientation and the foreground crop as torch ops on the volume's device
(counterpart of ``medseg/ops/resample.py``; the JAX package has no kernel
here, and neither has the port).

Capability contract: MONAI 0.6 ``Spacingd`` as the reference uses it (image
trilinear, label nearest, border-clamped sampling through the voxel->voxel
affine); the host twin is ``data.transforms.respace``. The resample matrix
and the output geometry come from the host affines by the same
``_zoom_affine``/``_compute_shape_offset`` rules, so the device work is
dense math:

- **Separable path** (axis-aligned affines, the common case): per-axis
  (out_i, in_i) interpolation-weight matrices applied as three
  contractions; trilinear is the product of per-axis linear weights exactly.
- **Gather path** (oblique affines): the 8 corner voxels gathered with
  border-clamped indices, whose coordinates are computed on the host in fp64
  so that rounding at half boundaries matches the host chain.

The intensity window (``ScaleIntensityRanged``) is applied to the resampled
tensor in the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from medseg_torch.data.transforms import _compute_shape_offset, _io_orientation, _zoom_affine


def _axis_weights(scale: float, offset: float, n_out: int, n_in: int, mode: str) -> np.ndarray:
    """(n_out, n_in) interpolation matrix for out coord c = scale*i + offset,
    border-clamped (torch grid_sample padding_mode="border", the MONAI
    Spacing default)."""
    c = scale * np.arange(n_out, dtype=np.float64) + offset
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if mode == "nearest":
        idx = np.clip(np.round(c), 0, n_in - 1).astype(np.int64)
        w[np.arange(n_out), idx] = 1.0
        return w
    c = np.clip(c, 0.0, n_in - 1.0)
    c0 = np.floor(c).astype(np.int64)
    c1 = np.minimum(c0 + 1, n_in - 1)
    frac = (c - c0).astype(np.float32)
    np.add.at(w, (np.arange(n_out), c0), 1.0 - frac)
    np.add.at(w, (np.arange(n_out), c1), frac)
    return w


def _is_axis_aligned(matrix: np.ndarray, tol: float = 1e-9) -> bool:
    off = matrix[:3, :3].copy()
    np.fill_diagonal(off, 0.0)
    return bool(np.abs(off).max() <= tol)


def _apply_window(out: torch.Tensor, window) -> torch.Tensor:
    """ScaleIntensityRanged on the resampled tensor (one definition for the
    identity, separable and gather paths)."""
    if window is None:
        return out
    a_min, a_max, b_min, b_max, clip = window
    out = (out - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    if clip:
        out = out.clamp(min(b_min, b_max), max(b_min, b_max))
    return out


def _gather_coords(matrix: np.ndarray, out_shape, in_shape, mode: str):
    """Host fp64 corner indices and fractions for the gather path."""
    grid = np.stack(
        np.meshgrid(*[np.arange(n, dtype=np.float64) for n in out_shape], indexing="ij"),
        axis=-1,
    )
    coords = grid @ matrix[:3, :3].T + matrix[:3, 3]
    shape = np.asarray(in_shape, np.float64)
    if mode == "nearest":
        return np.clip(np.round(coords), 0, shape - 1).astype(np.int64), None, None
    c = np.clip(coords, 0.0, shape - 1.0)
    c0 = np.floor(c)
    frac = (c - c0).astype(np.float32)
    c0i = c0.astype(np.int64)
    c1i = np.minimum(c0i + 1, np.asarray(in_shape, np.int64) - 1)
    return c0i, c1i, frac


def affine_resample_device(vol: torch.Tensor, matrix: np.ndarray, out_shape, mode: str = "trilinear",
                           window: tuple | None = None) -> torch.Tensor:
    """Resample a (X, Y, Z[, C]) tensor on its device through ``matrix``
    ((3, 4) or (4, 4): out voxel -> in voxel, host data). Returns float32
    (X', Y', Z'[, C]); ``window`` = (a_min, a_max, b_min, b_max, clip)."""
    matrix = np.asarray(matrix, dtype=np.float64)
    squeeze = vol.ndim == 3
    v = (vol[..., None] if squeeze else vol).float()
    dev = v.device
    if _is_axis_aligned(matrix):
        wx, wy, wz = (
            torch.from_numpy(_axis_weights(matrix[i, i], matrix[i, 3], out_shape[i], v.shape[i], mode))
            .to(dev)
            for i in range(3)
        )
        out = torch.einsum("ax,xyzc->ayzc", wx, v)
        out = torch.einsum("by,ayzc->abzc", wy, out)
        out = torch.einsum("dz,abzc->abdc", wz, out)
    else:
        c0i, c1i, frac = _gather_coords(matrix, out_shape, v.shape[:3], mode)
        c0 = torch.from_numpy(c0i).to(dev)
        if mode == "nearest":
            out = v[c0[..., 0], c0[..., 1], c0[..., 2]]
        else:
            c1 = torch.from_numpy(c1i).to(dev)
            f = torch.from_numpy(frac).to(dev)
            out = None
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        ix = (c1 if dx else c0)[..., 0]
                        iy = (c1 if dy else c0)[..., 1]
                        iz = (c1 if dz else c0)[..., 2]
                        ww = (
                            (f[..., 0] if dx else 1 - f[..., 0])
                            * (f[..., 1] if dy else 1 - f[..., 1])
                            * (f[..., 2] if dz else 1 - f[..., 2])
                        )
                        term = v[ix, iy, iz] * ww[..., None]
                        out = term if out is None else out + term
    out = _apply_window(out, window)
    return out[..., 0] if squeeze else out


def respace_device(sample: dict, pixdim, keys=("image", "label"), modes=("trilinear", "nearest"),
                   window: tuple | None = None, device: torch.device | str = "cuda") -> dict:
    """Device twin of ``data.transforms.respace``: the same MONAI geometry
    (computed on the host), the resample on ``device``. ``window`` applies
    the CT intensity window to the image."""
    out = dict(sample)
    pixdim = np.asarray(pixdim, dtype=np.float64)
    for key, mode in zip(keys, modes):
        if key not in out or f"{key}_affine" not in out:
            continue
        data = torch.as_tensor(out[key]).to(device)
        affine = np.asarray(out[f"{key}_affine"], dtype=np.float64)
        in_shape = np.array(data.shape[:3])
        new_affine = _zoom_affine(affine, pixdim)
        new_shape, offset = _compute_shape_offset(in_shape, affine, new_affine)
        new_affine[:3, 3] = offset
        m = np.linalg.inv(affine) @ new_affine
        win = window if (key == "image" and window is not None) else None
        if np.array_equal(new_shape, in_shape) and np.allclose(m, np.eye(4)):
            res = _apply_window(data.float(), win)
        else:
            res = affine_resample_device(data, m, tuple(int(x) for x in new_shape), mode, window=win)
        out[key] = res
        out[f"{key}_affine"] = new_affine
    return out


def orient_ras_device(sample: dict, keys=("image", "label")) -> dict:
    """Device twin of ``data.transforms.orient_ras``: the permutation and
    flips come from the host affine, the array moves on its device."""
    out = dict(sample)
    for key in keys:
        if key not in out or f"{key}_affine" not in out:
            continue
        data = torch.as_tensor(out[key])
        affine = np.asarray(out[f"{key}_affine"], dtype=np.float64)
        ornt = _io_orientation(affine)
        spatial_shape = data.shape[:3]
        flips = [int(ax) for ax, (_, sign) in enumerate(ornt) if sign < 0]
        if flips:
            data = torch.flip(data, dims=flips)
        perm = np.argsort(ornt[:, 0])
        data = data.permute(*[int(p) for p in perm], *range(3, data.ndim))
        t_flip = np.eye(4)
        for ax in flips:
            t_flip[ax, ax] = -1.0
            t_flip[ax, 3] = spatial_shape[ax] - 1
        t_perm = np.zeros((4, 4))
        t_perm[3, 3] = 1.0
        for new_ax, old_ax in enumerate(perm):
            t_perm[old_ax, new_ax] = 1.0
        out[key] = data.contiguous()
        out[f"{key}_affine"] = affine @ t_flip @ t_perm
    return out


def _foreground_bounds(src: torch.Tensor):
    """Per-axis [lo, hi) of ``src > 0`` (any channel), fetched to the host;
    None when there is no foreground."""
    fg = src > 0
    if fg.ndim == 4:
        fg = fg.any(dim=-1)
    lines = [fg.any(dim=tuple(a for a in range(3) if a != ax)) for ax in range(3)]
    if not bool(lines[0].any()):
        return None
    bounds = []
    for line in lines:
        idx = torch.nonzero(line).flatten()
        bounds.append((int(idx.min()), int(idx.max()) + 1))
    return bounds


def crop_foreground_device(sample: dict, source_key: str = "image", keys=("image", "label"),
                           margin: int = 0) -> dict:
    """Device twin of ``data.transforms.crop_foreground``: the bounding box
    is reduced on the device (six integers fetched), the slice taken there.
    An all-background volume passes untouched."""
    out = dict(sample)
    src = torch.as_tensor(out[source_key])
    bounds = _foreground_bounds(src)
    if bounds is None:
        return out
    starts = [max(lo - margin, 0) for lo, _ in bounds]
    stops = [min(hi + margin, s) for (_, hi), s in zip(bounds, src.shape[:3])]
    sl = tuple(slice(a, b) for a, b in zip(starts, stops))
    for key in keys:
        if key in out:
            out[key] = torch.as_tensor(out[key])[sl].contiguous()
    out["foreground_start"] = np.asarray(starts, dtype=np.int64)
    return out
