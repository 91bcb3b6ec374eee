"""Transform pipelines, assembled as the reference composes them (a copy of
``medseg/data/pipelines.py``).

- ``train_transforms`` (CT or MRI/BraTS) and ``pretrain_transforms``: the
  deterministic host prefix, then random crops of the volume (pos/neg
  balanced for segmentation; ``num_samples`` uniform crops of the same
  volume, the "pair of transforms", for pretraining), then independent
  augmentations per crop; every random draw from the ``np.random.Generator``
  passed in, so a seed gives the JAX package's crops;
- ``val_transforms``: the host chain (numpy), CT or MRI/BraTS;
- ``val_transforms_device``: NIfTI decode and channel handling on the host,
  then respacing (the CT intensity window fused into it), RAS orientation,
  the foreground crop and, for MRI, the z-score normalization as torch ops on
  ``device`` (``ops/resample.py``). Its ``image`` comes out as a tensor on
  ``device``, (X, Y, Z, C).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from medseg_torch.config import DataConfig
from medseg_torch.data import transforms as T
from medseg_torch.data.sampling import (
    rand_crop_by_pos_neg_label,
    rand_flip,
    rand_rotate90,
    rand_shift_intensity,
    rand_spatial_crop_samples,
)


def _augmentations(cfg: DataConfig, rng: np.random.Generator):
    """The shared augmentation tail: 3 axis flips, rot90, intensity shift."""
    return [
        partial(rand_flip, axis=0, prob=cfg.flip_prob, rng=rng),
        partial(rand_flip, axis=1, prob=cfg.flip_prob, rng=rng),
        partial(rand_flip, axis=2, prob=cfg.flip_prob, rng=rng),
        partial(rand_rotate90, prob=cfg.rot90_prob, max_k=3, rng=rng),
        partial(
            rand_shift_intensity, offsets=cfg.shift_offset, prob=cfg.shift_prob, rng=rng
        ),
    ]


def _apply_each(crops: list[dict], fns) -> list[dict]:
    for fn in fns:
        crops = [fn(c) for c in crops]
    return crops


def _ct_deterministic(cfg: DataConfig):
    steps = [
        T.load,
        T.ensure_channel,
        partial(T.respace, pixdim=cfg.spacing),
        T.orient_ras,
        partial(
            T.scale_intensity_range,
            a_min=cfg.intensity_window[0],
            a_max=cfg.intensity_window[1],
        ),
    ]
    if cfg.crop_foreground:
        steps.append(T.crop_foreground)
    return steps


def _mri_deterministic(cfg: DataConfig):
    return [
        T.load,
        T.ensure_channel,
        T.brats_to_multichannel,
        partial(T.respace, pixdim=cfg.spacing),
        T.orient_ras,
    ]


def _pos_neg_crop(cfg: DataConfig, rng: np.random.Generator):
    return partial(
        rand_crop_by_pos_neg_label,
        spatial_size=(cfg.crop_size,) * 3,
        num_samples=cfg.num_crop_samples,
        pos=cfg.pos_neg_ratio[0],
        neg=cfg.pos_neg_ratio[1],
        image_threshold=0.0,
        rng=rng,
    )


def ct_train_transforms(cfg: DataConfig, rng: np.random.Generator, augment: bool = True) -> T.Compose:
    crop = _pos_neg_crop(cfg, rng)
    augs = _augmentations(cfg, rng) if augment else []
    return T.Compose(_ct_deterministic(cfg) + [lambda s: _apply_each(crop(s), augs)])


def mri_train_transforms(cfg: DataConfig, rng: np.random.Generator, augment: bool = True) -> T.Compose:
    crop = _pos_neg_crop(cfg, rng)
    # the z-score normalization comes after the augmentations, as the reference orders it
    augs = (_augmentations(cfg, rng) if augment else []) + [T.normalize_intensity]
    return T.Compose(_mri_deterministic(cfg) + [lambda s: _apply_each(crop(s), augs)])


def train_transforms(cfg: DataConfig, rng: np.random.Generator, augment: bool = True) -> T.Compose:
    return (ct_train_transforms(cfg, rng, augment) if cfg.task == "ct"
            else mri_train_transforms(cfg, rng, augment))


def pretrain_transforms(cfg: DataConfig, rng: np.random.Generator, num_samples: int = 2) -> T.Compose:
    """The pretraining chain: the deterministic prefix of the task, then
    ``num_samples`` random spatial crops of the same volume, then independent
    augmentations per crop (and, for MRI, the z-score normalization)."""
    crop = partial(
        rand_spatial_crop_samples, roi_size=(cfg.crop_size,) * 3, num_samples=num_samples, rng=rng,
    )
    if cfg.task == "ct":
        prefix = _ct_deterministic(cfg)
        augs = _augmentations(cfg, rng)
    else:
        prefix = _mri_deterministic(cfg)
        augs = _augmentations(cfg, rng) + [T.normalize_intensity]
    return T.Compose(prefix + [lambda s: _apply_each(crop(s), augs)])


def ct_val_transforms(cfg: DataConfig) -> T.Compose:
    return T.Compose(_ct_deterministic(cfg))


def mri_val_transforms(cfg: DataConfig) -> T.Compose:
    return T.Compose(_mri_deterministic(cfg) + [T.normalize_intensity])


def val_transforms(cfg: DataConfig) -> T.Compose:
    return ct_val_transforms(cfg) if cfg.task == "ct" else mri_val_transforms(cfg)


def ct_val_transforms_device(cfg: DataConfig, device: torch.device | str = "cuda") -> T.Compose:
    """CT validation preprocessing with respacing (the intensity window fused
    into its epilogue), orientation and the foreground crop on ``device``.
    Windowing commutes with orientation (elementwise), so the result matches
    the host chain transform for transform."""
    from medseg_torch.ops import resample as R

    steps = [
        T.load,
        T.ensure_channel,
        partial(
            R.respace_device,
            pixdim=cfg.spacing,
            window=(*cfg.intensity_window, 0.0, 1.0, True),
            device=device,
        ),
        R.orient_ras_device,
    ]
    if cfg.crop_foreground:
        steps.append(R.crop_foreground_device)
    return T.Compose(steps)


def mri_val_transforms_device(cfg: DataConfig, device: torch.device | str = "cuda") -> T.Compose:
    """MRI/BraTS validation preprocessing on ``device`` (the z-score
    normalization runs on the resampled tensor)."""
    from medseg_torch.ops import resample as R
    from medseg_torch.ops.post import normalize_intensity_device

    return T.Compose(
        [
            T.load,
            T.ensure_channel,
            T.brats_to_multichannel,
            partial(R.respace_device, pixdim=cfg.spacing, device=device),
            R.orient_ras_device,
            normalize_intensity_device,
        ]
    )


def val_transforms_device(cfg: DataConfig, device: torch.device | str = "cuda") -> T.Compose:
    return (
        ct_val_transforms_device(cfg, device)
        if cfg.task == "ct"
        else mri_val_transforms_device(cfg, device)
    )
