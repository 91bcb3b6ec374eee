"""Augmentation on the device, per sample, inside the train step (the
counterpart of ``medseg/ops/augment.py``).

The reference augments each crop on the host inside its loader workers; the
host chain (``data/sampling.py``) does the same here. This module is the
device alternative: once the crops are on the device, the same chain runs
there on the whole batch, with the same probabilities and ranges:

- flip each spatial axis with p = 0.1;
- rot90 by k in 1..3 in the (D, H) plane with p = 0.1 (cubic D == H crops);
- intensity shift U(-0.1, 0.1) with p = 0.5 (image only).

Tensors are (B, C, D, H, W); labels (B, 1, D, H, W), (B, K, D, H, W) or
(B, D, H, W) go through the same flips and rotation. The JAX package draws
its decisions on the device from per-sample keys; here they are drawn per
sample on the host from an explicit CPU ``torch.Generator`` (the train
state's), so the step never waits on the device for them. The two packages'
random streams differ; each transform is the JAX one at the same decision.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Decision:
    """One sample's draw: which spatial axes (D, H, W) flip, the rot90
    count (0: none) and the intensity shift (0.0: none)."""

    flips: tuple[bool, bool, bool] = (False, False, False)
    k: int = 0
    shift: float = 0.0


def draw_decisions(
    generator: torch.Generator,
    batch: int,
    *,
    flip_prob: float = 0.1,
    rot_prob: float = 0.1,
    max_k: int = 3,
    shift_offsets: float = 0.1,
    shift_prob: float = 0.5,
) -> list[Decision]:
    """Per-sample decisions from ``generator`` (on the host)."""
    u = torch.rand((batch, 5), generator=generator, dtype=torch.float64).tolist()
    ks = torch.randint(1, max_k + 1, (batch,), generator=generator).tolist()
    shifts = torch.rand((batch,), generator=generator, dtype=torch.float64).tolist()
    return [
        Decision(
            flips=(ui[0] < flip_prob, ui[1] < flip_prob, ui[2] < flip_prob),
            k=k if ui[3] < rot_prob else 0,
            shift=(2.0 * s - 1.0) * shift_offsets if ui[4] < shift_prob else 0.0,
        )
        for ui, k, s in zip(u, ks, shifts)
    ]


def _geometry(x: torch.Tensor, d: Decision) -> torch.Tensor:
    """One sample's flips, then its rotation, over its last three dims."""
    dims = [dim for dim, flip in zip((-3, -2, -1), d.flips) if flip]
    if dims:
        x = torch.flip(x, dims)
    if d.k:
        x = torch.rot90(x, d.k, dims=(-3, -2))
    return x


def apply_decisions(
    image: torch.Tensor, label: torch.Tensor, decisions: list[Decision]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chain at fixed decisions, one per sample of the batch."""
    if any(d.k for d in decisions) and image.shape[-3] != image.shape[-2]:
        raise ValueError(f"rot90 needs cubic D == H crops, got {tuple(image.shape[-3:])}")
    images, labels = [], []
    for i, d in enumerate(decisions):
        img = _geometry(image[i], d)
        if d.shift:
            img = img + torch.tensor(d.shift, dtype=img.dtype)
        images.append(img)
        labels.append(_geometry(label[i], d))
    return torch.stack(images), torch.stack(labels)


def augment_batch(
    generator: torch.Generator,
    image: torch.Tensor,
    label: torch.Tensor,
    *,
    flip_prob: float = 0.1,
    rot_prob: float = 0.1,
    max_k: int = 3,
    shift_offsets: float = 0.1,
    shift_prob: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference augmentation chain on the batch's device, with
    per-sample decisions drawn from ``generator``."""
    if rot_prob > 0 and image.shape[-3] != image.shape[-2]:
        raise ValueError(f"rot90 needs cubic D == H crops, got {tuple(image.shape[-3:])}")
    decisions = draw_decisions(
        generator, image.shape[0], flip_prob=flip_prob, rot_prob=rot_prob, max_k=max_k,
        shift_offsets=shift_offsets, shift_prob=shift_prob,
    )
    return apply_decisions(image, label, decisions)


def scale_intensity_range_device(
    image: torch.Tensor,
    a_min: float = -175.0,
    a_max: float = 250.0,
    b_min: float = 0.0,
    b_max: float = 1.0,
    clip: bool = True,
) -> torch.Tensor:
    """Device twin of ScaleIntensityRanged."""
    scale = (b_max - b_min) / (a_max - a_min)
    y = (image - a_min) * scale + b_min
    return y.clamp(b_min, b_max) if clip else y
