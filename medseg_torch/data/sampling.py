"""Random crop sampling and augmentations, host side, numpy (a copy of
``medseg/data/sampling.py``).

Capability contracts (MONAI 0.6 random transforms at the reference's call
sites):

- ``RandCropByPosNegLabeld(spatial_size, pos=1, neg=1, num_samples=4,
  image_threshold=0)``: crop centers drawn 1:1 from foreground (label > 0)
  vs background (image > threshold, label == 0) voxels; ``num_samples``
  crops per volume that the loader flattens into the batch.
- ``RandSpatialCropSamplesd(roi_size, num_samples=2)``: the pretraining's
  "two transforms of the same volume".
- ``RandFlipd(axis, prob=0.1)`` x3, ``RandRotate90d(prob=0.1, max_k=3)``,
  ``RandShiftIntensityd(offsets=0.1, prob=0.5)``.

All randomness flows through an explicit ``np.random.Generator``, so crops
and augmentations are reproducible from a seed and draw the JAX package's
numbers. Volumes smaller than the crop are zero-padded symmetrically first
(MONAI 0.6 would raise); padding only triggers on degenerate inputs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _pad_to_min_size(arr: np.ndarray, size: Sequence[int]) -> np.ndarray:
    pads = []
    for dim, target in zip(arr.shape[:3], size):
        extra = max(target - dim, 0)
        pads.append((extra // 2, extra - extra // 2))
    if arr.ndim == 4:
        pads.append((0, 0))
    if any(lo or hi for lo, hi in pads):
        arr = np.pad(arr, pads)
    return arr


def _crop(arr: np.ndarray, start: Sequence[int], size: Sequence[int]) -> np.ndarray:
    sl = tuple(slice(s, s + z) for s, z in zip(start, size))
    return np.ascontiguousarray(arr[sl])


def _clamp_center(center: np.ndarray, size: Sequence[int], shape: Sequence[int]) -> np.ndarray:
    """Clamp a crop center so the window stays in bounds (MONAI
    correct_crop_centers contract)."""
    out = []
    for c, z, dim in zip(center, size, shape):
        half_lo = z // 2
        out.append(int(np.clip(c, half_lo, dim - z + half_lo)))
    return np.asarray(out)


def rand_crop_by_pos_neg_label(
    sample: dict,
    *,
    spatial_size: Sequence[int],
    num_samples: int = 4,
    pos: float = 1.0,
    neg: float = 1.0,
    image_key: str = "image",
    label_key: str = "label",
    image_threshold: float = 0.0,
    rng: np.random.Generator,
    keys: Sequence[str] = ("image", "label"),
) -> list[dict]:
    """Sample ``num_samples`` crops with pos/neg-balanced centers."""
    size = tuple(int(s) for s in spatial_size)
    out_base = dict(sample)
    for key in keys:
        out_base[key] = _pad_to_min_size(sample[key], size)
    label = out_base[label_key]
    image = out_base[image_key]
    shape = label.shape[:3]

    lab_fg = label > 0
    if lab_fg.ndim == 4:
        lab_fg = lab_fg.any(axis=-1)
    img_fg = image > image_threshold
    if img_fg.ndim == 4:
        img_fg = img_fg.any(axis=-1)
    fg = np.argwhere(lab_fg)
    bg = np.argwhere(img_fg & ~lab_fg)
    if fg.size == 0 and bg.size == 0:
        bg = np.argwhere(np.ones(shape, bool))
    pos_ratio = pos / (pos + neg) if (pos + neg) > 0 else 0.5

    crops = []
    for _ in range(num_samples):
        use_fg = rng.random() < pos_ratio
        pool = fg if (use_fg and fg.size) or not bg.size else bg
        center = pool[int(rng.integers(0, len(pool)))]
        center = _clamp_center(center, size, shape)
        start = [c - z // 2 for c, z in zip(center, size)]
        crop = dict(out_base)
        for key in keys:
            crop[key] = _crop(out_base[key], start, size)
        crop["crop_start"] = np.asarray(start, dtype=np.int64)
        crops.append(crop)
    return crops


def rand_spatial_crop_samples(
    sample: dict,
    *,
    roi_size: Sequence[int],
    num_samples: int = 2,
    rng: np.random.Generator,
    keys: Sequence[str] = ("image", "label"),
) -> list[dict]:
    """``num_samples`` independent uniform-random fixed-size crops."""
    size = tuple(int(s) for s in roi_size)
    out_base = dict(sample)
    present = [k for k in keys if k in sample]
    for key in present:
        out_base[key] = _pad_to_min_size(sample[key], size)
    shape = out_base[present[0]].shape[:3]
    crops = []
    for _ in range(num_samples):
        start = [int(rng.integers(0, dim - z + 1)) for dim, z in zip(shape, size)]
        crop = dict(out_base)
        for key in present:
            crop[key] = _crop(out_base[key], start, size)
        crop["crop_start"] = np.asarray(start, dtype=np.int64)
        crops.append(crop)
    return crops


def rand_flip(
    sample: dict,
    *,
    axis: int,
    prob: float = 0.1,
    rng: np.random.Generator,
    keys: Sequence[str] = ("image", "label"),
) -> dict:
    if rng.random() >= prob:
        return sample
    out = dict(sample)
    for key in keys:
        if key in out:
            out[key] = np.ascontiguousarray(np.flip(out[key], axis=axis))
    return out


def rand_rotate90(
    sample: dict,
    *,
    prob: float = 0.1,
    max_k: int = 3,
    axes: tuple[int, int] = (0, 1),
    rng: np.random.Generator,
    keys: Sequence[str] = ("image", "label"),
) -> dict:
    """RandRotate90d: with ``prob``, rotate by k in 1..max_k quarter turns in
    the (0, 1) spatial plane (MONAI default spatial_axes)."""
    if rng.random() >= prob:
        return sample
    k = int(rng.integers(1, max_k + 1))
    out = dict(sample)
    for key in keys:
        if key in out:
            out[key] = np.ascontiguousarray(np.rot90(out[key], k=k, axes=axes))
    return out


def rand_scale_intensity(
    sample: dict,
    *,
    factors: float = 0.1,
    prob: float = 0.1,
    rng: np.random.Generator,
    keys: Sequence[str] = ("image",),
) -> dict:
    """RandScaleIntensityd: multiply by (1 + U(-factors, factors)) with prob.

    Part of the reference's import surface (`unetr_segmentation_3d.py:26`,
    imported though unused in its final CT chain); provided for completeness.
    """
    if rng.random() >= prob:
        return sample
    factor = 1.0 + float(rng.uniform(-factors, factors))
    out = dict(sample)
    for key in keys:
        out[key] = out[key] * np.float32(factor)
    return out


def rand_shift_intensity(
    sample: dict,
    *,
    offsets: float = 0.1,
    prob: float = 0.5,
    rng: np.random.Generator,
    keys: Sequence[str] = ("image",),
) -> dict:
    if rng.random() >= prob:
        return sample
    shift = float(rng.uniform(-offsets, offsets))
    out = dict(sample)
    for key in keys:
        out[key] = out[key] + np.float32(shift)
    return out
