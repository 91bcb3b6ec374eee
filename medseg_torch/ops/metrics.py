"""Dice with the MONAI accumulate/aggregate protocol: the device half of
``medseg/ops/metrics.py``.

``dice_scores`` is per-(sample, class) binary dice ``2|X∩Y| / (|X|+|Y|)``,
NaN when both masks are empty; ``DiceAccumulator.aggregate`` reduces with
nanmean over samples and classes ("mean") or over samples per class
("mean_batch").
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def dice_scores(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary dice per (sample, class) from channels-last one-hot masks.

    Returns (B, C) float32 with NaN where both masks are empty.
    """
    pred = pred.float()
    target = target.float()
    spatial = tuple(range(1, pred.ndim - 1))
    inter = (pred * target).sum(dim=spatial)
    denom = pred.sum(dim=spatial) + target.sum(dim=spatial)
    nan = torch.full_like(denom, float("nan"))
    return torch.where(denom > 0, 2.0 * inter / denom.clamp_min(1.0), nan)


def _nan_reduce(values: np.ndarray, reduction: str) -> np.ndarray:
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices -> NaN
        if reduction == "mean":
            return np.float32(np.nanmean(values))
        if reduction == "mean_batch":
            return np.nanmean(values, axis=0).astype(np.float32)
    raise ValueError(f"unknown reduction {reduction!r}")


class DiceAccumulator:
    """``__call__`` accumulates, ``aggregate`` reduces, ``reset`` clears."""

    def __init__(self) -> None:
        self._buffer: list[np.ndarray] = []

    def reset(self) -> None:
        self._buffer.clear()

    def __call__(self, y_pred: torch.Tensor, y: torch.Tensor) -> None:
        self._buffer.append(dice_scores(y_pred, y).cpu().numpy())

    def aggregate(self, reduction: str = "mean") -> np.ndarray:
        if not self._buffer:
            raise RuntimeError("aggregate() called before any accumulation")
        return _nan_reduce(np.concatenate(self._buffer, axis=0), reduction)
