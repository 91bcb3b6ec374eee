"""Validation metrics with the MONAI accumulate/aggregate protocol (the
counterpart of ``medseg/ops/metrics.py``).

- ``dice_scores``: per-(sample, class) binary dice ``2|X∩Y| / (|X|+|Y|)``,
  NaN when both masks are empty.
- ``confusion_counts``: per-(sample, class) [tp, fp, tn, fn], counted as
  integers on the device; ``ConfusionAccumulator`` turns them into precision
  ``tp/(tp+fp)`` or sensitivity ``tp/(tp+fn)`` at aggregate time, NaN on 0/0.
- ``hausdorff_distance``: the largest of the nearest-edge Euclidean distances
  between the edge voxels of two binary masks, in voxel units (HD100, or a
  percentile of the directed distances), NaN when either mask is empty.
  The JAX package runs scipy's distance transform on the host; here an
  exact squared distance transform runs on the masks' device over the box
  that holds both edge sets: the nearest edge along the last axis from
  running maxima and minima of the edge indices, then two min-plus passes
  over the other axes, each over integer squared coordinate differences, in
  chunks. Every squared distance is an exact integer; the square root is
  taken in double precision on the host, as scipy's is.

``aggregate`` reduces with nanmean over samples and classes ("mean") or
over samples per class ("mean_batch"). Masks are channels-last,
(B, D, H, W, C).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

__all__ = [
    "dice_scores",
    "confusion_counts",
    "DiceAccumulator",
    "ConfusionAccumulator",
    "HausdorffAccumulator",
    "hausdorff_distance",
]

# above every squared distance of a box with sides below 2**13 (3 * side**2
# < 2**28), so that INF plus two squared offsets stays below 2**31
_INF = 1 << 29
# elements of one min-plus chunk, (lines, L, L) int32: 256 MiB
_CHUNK_ELEMENTS = 1 << 26


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


def confusion_counts(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, C, 4) int64 [tp, fp, tn, fn] counts from channels-last binary
    masks."""
    p, t = pred.bool(), target.bool()
    spatial = tuple(range(1, p.ndim - 1))
    tp = (p & t).sum(dim=spatial)
    fp = (p & ~t).sum(dim=spatial)
    fn = (~p & t).sum(dim=spatial)
    tn = math.prod(p.shape[1:-1]) - tp - fp - fn
    return torch.stack([tp, fp, tn, fn], dim=-1)


def _nan_reduce(values: np.ndarray, reduction: str) -> np.ndarray:
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices -> NaN
        if reduction == "mean":
            return np.float32(np.nanmean(values))
        if reduction == "mean_batch":
            return np.nanmean(values, axis=0).astype(np.float32)
    raise ValueError(f"unknown reduction {reduction!r}")


class _Accumulator:
    """``__call__`` accumulates, ``aggregate`` reduces, ``reset`` clears."""

    def __init__(self) -> None:
        self._buffer: list[np.ndarray] = []

    def reset(self) -> None:
        self._buffer.clear()

    def _stacked(self) -> np.ndarray:
        if not self._buffer:
            raise RuntimeError("aggregate() called before any accumulation")
        return np.concatenate(self._buffer, axis=0)


class DiceAccumulator(_Accumulator):
    def __call__(self, y_pred: torch.Tensor, y: torch.Tensor) -> None:
        self._buffer.append(dice_scores(y_pred, y).cpu().numpy())

    def aggregate(self, reduction: str = "mean") -> np.ndarray:
        return _nan_reduce(self._stacked(), reduction)


class ConfusionAccumulator(_Accumulator):
    """Accumulates (B, C, 4) counts; the metric is computed at aggregate
    time."""

    def __init__(self, metric_name: str = "precision") -> None:
        super().__init__()
        if metric_name not in ("precision", "sensitivity"):
            raise ValueError(f"unsupported metric {metric_name!r}")
        self.metric_name = metric_name

    def __call__(self, y_pred: torch.Tensor, y: torch.Tensor) -> None:
        self._buffer.append(confusion_counts(y_pred, y).cpu().numpy())

    def aggregate(self, reduction: str = "mean") -> np.ndarray:
        counts = self._stacked()  # (N, C, 4)
        tp, fp, fn = counts[..., 0], counts[..., 1], counts[..., 3]
        denom = tp + (fp if self.metric_name == "precision" else fn)
        with np.errstate(invalid="ignore", divide="ignore"):
            metric = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
        return _nan_reduce(metric, reduction)


def _mask_edges(mask: torch.Tensor) -> torch.Tensor:
    """Edge voxels: the mask minus its erosion (6-connectivity). Outside the
    array counts as background, so mask voxels on the border are edges."""
    m = torch.as_tensor(mask).bool()
    eroded = m.clone()
    for axis in range(m.ndim):
        n = m.shape[axis]
        below = torch.zeros_like(m)
        below.narrow(axis, 1, n - 1).copy_(m.narrow(axis, 0, n - 1))
        above = torch.zeros_like(m)
        above.narrow(axis, 0, n - 1).copy_(m.narrow(axis, 1, n - 1))
        eroded &= below & above
    return m & ~eroded


def _nearest_along_last(feature: torch.Tensor) -> torch.Tensor:
    """Squared distance along the last axis to the nearest True voxel of the
    same line (int32; ``_INF`` where the line has none)."""
    n = feature.shape[-1]
    idx = torch.arange(n, device=feature.device)
    before = torch.where(feature, idx, -2 * n).cummax(dim=-1).values
    after = torch.where(feature, idx, 3 * n).flip(-1).cummin(dim=-1).values.flip(-1)
    d = torch.minimum(idx - before, after - idx)
    return torch.where(d < n, d * d, _INF).to(torch.int32)


def _min_plus(g: torch.Tensor, dim: int) -> torch.Tensor:
    """``out[i] = min_j g[j] + (i - j)**2`` along ``dim`` (int32), by
    broadcasting in chunks of lines."""
    moved = g.movedim(dim, -1)
    shape = moved.shape
    n = shape[-1]
    lines = moved.reshape(-1, n)
    idx = torch.arange(n, device=g.device, dtype=torch.int32)
    sq = (idx[:, None] - idx[None, :]).square()  # (i, j)
    out = torch.empty_like(lines)
    rows = max(1, _CHUNK_ELEMENTS // (n * n))
    for s in range(0, lines.shape[0], rows):
        out[s:s + rows] = (lines[s:s + rows, None, :] + sq).amin(dim=-1)
    return out.clamp_max_(_INF).reshape(shape).movedim(-1, dim)


def _squared_edt(feature: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance from every voxel to the nearest True
    voxel of ``feature`` (separable: the last axis, then each other axis)."""
    g = _nearest_along_last(feature)
    for dim in range(feature.ndim - 2, -1, -1):
        g = _min_plus(g, dim)
    return g


def _percentile(squared: torch.Tensor, q: float) -> float:
    """numpy's default (linear) percentile of the square roots of
    ``squared``; sorting squares keeps the order of their roots."""
    v = squared.flatten().sort().values
    pos = (v.numel() - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = min(lo + 1, v.numel() - 1)
    a, b = math.sqrt(v[lo].item()), math.sqrt(v[hi].item())
    return a + (b - a) * (pos - lo)


def hausdorff_distance(
    pred, target, percentile: float | None = None
) -> float:
    """Symmetric (max of directed) surface distance between binary masks.

    HD100 when ``percentile`` is None, MONAI ``HausdorffDistanceMetric``'s
    default. NaN if either mask is empty.
    """
    pe = _mask_edges(pred)
    te = _mask_edges(torch.as_tensor(target).to(pe.device))
    if not pe.any() or not te.any():
        return float("nan")
    # every edge voxel of both masks lies in this box, so the distances
    # computed inside it are the distances in the whole array
    both = pe | te
    box = []
    for axis in range(both.ndim):
        other = tuple(a for a in range(both.ndim) if a != axis)
        hit = both.any(dim=other).nonzero()
        box.append(slice(hit[0].item(), hit[-1].item() + 1))
    pe, te = pe[tuple(box)], te[tuple(box)]
    d_pt = _squared_edt(te)[pe]  # pred edge -> nearest target edge
    d_tp = _squared_edt(pe)[te]  # target edge -> nearest pred edge
    if percentile is None:
        return math.sqrt(max(d_pt.max().item(), d_tp.max().item()))
    return max(_percentile(d_pt, percentile), _percentile(d_tp, percentile))


class HausdorffAccumulator(_Accumulator):
    def __init__(self, percentile: float | None = None) -> None:
        super().__init__()
        self.percentile = percentile

    def __call__(self, y_pred: torch.Tensor, y: torch.Tensor) -> None:
        """y_pred/y: (B, D, H, W, C) binary, channels-last."""
        b, c = y_pred.shape[0], y_pred.shape[-1]
        out = np.empty((b, c), dtype=np.float32)
        for i in range(b):
            for j in range(c):
                out[i, j] = hausdorff_distance(y_pred[i, ..., j], y[i, ..., j], self.percentile)
        self._buffer.append(out)

    def aggregate(self, reduction: str = "mean") -> np.ndarray:
        return _nan_reduce(self._stacked(), reduction)
