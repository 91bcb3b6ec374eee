"""Post-transforms and label converters (counterpart of ``medseg/ops/post.py``).

- ``AsDiscrete(argmax=True, to_onehot=True, n)`` / ``AsDiscrete(to_onehot=True, n)``;
- ``Activations(sigmoid=True)`` + ``AsDiscrete(threshold_values=True)`` for
  the BraTS path;
- ``ConvertFromMultiChannelToRGB``: the 4-channel BraTS mask to a label map;
- ``NormalizeIntensityd(nonzero=True, channel_wise=True)`` on the device.

All tensors channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Label indices ([B,] D, H, W[, 1]) -> one-hot ([B,] D, H, W, C) float32;
    a trailing singleton channel axis is squeezed first."""
    if labels.ndim >= 4 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    return F.one_hot(labels.long(), num_classes).float()


def argmax_onehot(logits: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``AsDiscrete(argmax=True, to_onehot=True)``: logits -> one-hot prediction."""
    return F.one_hot(logits.argmax(dim=-1), num_classes).float()


def sigmoid_threshold(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """``Activations(sigmoid=True)`` + ``AsDiscrete(threshold_values=True)``."""
    return (torch.sigmoid(logits) >= threshold).float()


def multichannel_to_label_map(mask: torch.Tensor) -> torch.Tensor:
    """4-channel [bg, TC, WT, ET] -> int32 map, priority WT=1 < TC=2 < ET=3
    (later assignments overwrite earlier ones)."""
    out = torch.zeros(mask.shape[:-1], dtype=torch.int32, device=mask.device)
    out = torch.where(mask[..., 2] > 0, 1, out)  # WT
    out = torch.where(mask[..., 1] > 0, 2, out)  # TC
    return torch.where(mask[..., 3] > 0, 3, out).to(torch.int32)  # ET


def _znorm_device(x: torch.Tensor) -> torch.Tensor:
    """z-score over the nonzero voxels of one channel; unchanged when all
    are zero, std 0 taken as 1."""
    mask = x != 0
    n = mask.sum().clamp_min(1)
    mean = torch.where(mask, x, 0.0).sum() / n
    var = torch.where(mask, (x - mean) ** 2, 0.0).sum() / n
    std = var.sqrt()
    std = torch.where(std == 0, 1.0, std)
    y = torch.where(mask, (x - mean) / std, x)
    return torch.where(mask.any(), y, x)


def normalize_intensity_device(sample: dict, keys=("image",)) -> dict:
    """NormalizeIntensityd(nonzero=True, channel_wise=True) on the tensor's
    device, channels last."""
    out = dict(sample)
    for key in keys:
        img = torch.as_tensor(out[key]).float()
        out[key] = torch.stack([_znorm_device(img[..., c]) for c in range(img.shape[-1])], dim=-1)
    return out
