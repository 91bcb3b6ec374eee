"""Validation preprocessing pipelines, assembled as the reference composes
them (a copy of the validation chains of ``medseg/data/pipelines.py``; the
training chains come with the segmentation CLI).

- ``val_transforms``: the host chain (numpy), CT or MRI/BraTS;
- ``val_transforms_device``: NIfTI decode and channel handling on the host,
  then respacing (the CT intensity window fused into it), RAS orientation,
  the foreground crop and, for MRI, the z-score normalization as torch ops on
  ``device`` (``ops/resample.py``). Its ``image`` comes out as a tensor on
  ``device``, (X, Y, Z, C).
"""

from __future__ import annotations

from functools import partial

import torch

from medseg_torch.config import DataConfig
from medseg_torch.data import transforms as T


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
