"""Post-transforms and label converters (counterpart of ``medseg/ops/post.py``).

- ``AsDiscrete(argmax=True, to_onehot=True, n)`` / ``AsDiscrete(to_onehot=True, n)``;
- ``Activations(sigmoid=True)`` + ``AsDiscrete(threshold_values=True)`` for
  the BraTS path.

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
