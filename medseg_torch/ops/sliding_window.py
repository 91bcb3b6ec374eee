"""Sliding-window whole-volume inference (counterpart of
``medseg/ops/sliding_window.py``).

The MONAI 0.6.0 ``sliding_window_inference`` contract, as the JAX package
reproduces it: every spatial dim padded up to the ROI (half before), and
further up to a multiple of ``bucket_multiple`` where that is above 1 (the
serving CLI's 32, so that its grids equal the JAX ones); window starts
``k * int(roi * (1 - overlap))`` clipped to ``dim - roi``; each window
weighted by an importance map (constant, or a Gaussian with
``sigma = sigma_scale * roi``) and normalized by the accumulated importance;
padding cropped at the end. The grid, importance and count map are the same
numpy code as the JAX package's, so they agree exactly.

This is the flat walk: windows run ``sw_batch`` at a time (the grid padded
with zero-weight windows to a multiple of it, as in the JAX scan). The blend
weight ``importance * 1/count * validity`` is either multiplied here or
handed to ``apply_fn`` (``apply_takes_weight``, the fused forward folds it
into its out-head kernel). The overlap-add goes into a ``(K, D, H, W)``
accumulator in ``acc_dtype`` by tensor slicing. Grids that ``ppk_supported``
(alias ``zrow_supported``) accepts can take the exact z-row walk instead
(``ops/swi_zrow.py``).

``sliding_window_inference_sharded`` spreads the window batches over the
ranks of a data-parallel mesh (``medseg_torch.parallel``): the grid padded
to a multiple of ``sw_batch`` x ranks, each rank's contiguous block of
batches into its own fp32 accumulator, one all-reduce merges them.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from medseg_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SlidingWindowSpec:
    roi: tuple[int, int, int]
    overlap: float = 0.25
    sw_batch: int = 4
    mode: str = "constant"  # "constant" | "gaussian"
    sigma_scale: float = 0.125
    bucket_multiple: int = 1  # round padded dims up to a multiple of this


ACC_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _scan_interval(image_size: Sequence[int], roi: Sequence[int], overlap: float):
    out = []
    for dim, r in zip(image_size, roi):
        if r == dim:
            out.append(r)
        else:
            out.append(max(1, int(r * (1.0 - overlap))))
    return tuple(out)


def per_dim_window_starts(
    image_size: Sequence[int], roi: Sequence[int], overlap: float
) -> list[np.ndarray]:
    """Per-dimension window starts, MONAI ``dense_patch_slices`` semantics:
    ``k * interval`` clipped to ``dim - roi``, duplicates removed."""
    intervals = _scan_interval(image_size, roi, overlap)
    per_dim = []
    for dim, r, step in zip(image_size, roi, intervals):
        n = int(math.ceil((dim - r) / step)) + 1
        starts = np.minimum(np.arange(n) * step, dim - r)
        per_dim.append(np.unique(starts).astype(np.int64))
    return per_dim


def compute_window_starts(
    image_size: Sequence[int], roi: Sequence[int], overlap: float
) -> np.ndarray:
    """Dense window-start grid (the product of ``per_dim_window_starts``).
    Returns (N, 3) int32."""
    per_dim = per_dim_window_starts(image_size, roi, overlap)
    grid = np.stack(np.meshgrid(*per_dim, indexing="ij"), axis=-1).reshape(-1, len(per_dim))
    return grid.astype(np.int32)


def constant_importance(roi: Sequence[int]) -> np.ndarray:
    return np.ones(tuple(roi), dtype=np.float32)


def gaussian_importance(roi: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """Separable gaussian window weight, peak-normalized to 1, zeros clamped
    to the smallest positive value (MONAI ``compute_importance_map``)."""
    maps = []
    for r in roi:
        sigma = sigma_scale * r
        center = (r - 1) / 2.0
        x = np.arange(r, dtype=np.float64)
        maps.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    w = maps[0][:, None, None] * maps[1][None, :, None] * maps[2][None, None, :]
    w = w / w.max()
    w = np.maximum(w, np.min(w[w > 0]))
    return w.astype(np.float32)


def _pad_amounts(shape: Sequence[int], roi: Sequence[int], multiple: int):
    pads = []
    for dim, r in zip(shape, roi):
        target = max(dim, r)
        if multiple > 1:
            target = int(math.ceil(target / multiple) * multiple)
        extra = target - dim
        pads.append((extra // 2, extra - extra // 2))
    return pads


def _importance(roi, mode: str, sigma_scale: float) -> np.ndarray:
    return constant_importance(roi) if mode == "constant" else gaussian_importance(roi, sigma_scale)


@lru_cache(maxsize=32)
def _count_map_cached(padded_shape, roi, overlap, mode, sigma_scale) -> np.ndarray:
    starts = compute_window_starts(padded_shape, roi, overlap)
    imp = _importance(roi, mode, sigma_scale)
    count = np.zeros(padded_shape, dtype=np.float32)
    for s in starts:
        count[s[0] : s[0] + roi[0], s[1] : s[1] + roi[1], s[2] : s[2] + roi[2]] += imp
    return count


def ppk_supported(spatial, spec: SlidingWindowSpec) -> bool:
    """The routing predicate of the z-row walk (the JAX package's name, from
    its parity-plane layout): even roi, even pads, and every window start
    even (interval multiples and the clipped last starts)."""
    roi = tuple(spec.roi)
    if any(r % 2 for r in roi):
        return False
    pads = _pad_amounts(spatial, roi, spec.bucket_multiple)
    if any(lo % 2 or (lo + hi + s) % 2 for (lo, hi), s in zip(pads, spatial)):
        return False
    padded = tuple(s + lo + hi for s, (lo, hi) in zip(spatial, pads))
    starts = compute_window_starts(padded, roi, spec.overlap)
    return bool((starts % 2 == 0).all())


zrow_supported = ppk_supported


@lru_cache(maxsize=4)
def _device_grid_cached(padded_shape, roi, overlap, mode, sigma_scale, sw_batch, device,
                        n_ranks=1):
    """Grid constants, uploaded once per (shape, spec, device): starts
    padded with zero-weight windows to a multiple of ``sw_batch`` x
    ``n_ranks`` (host, (n_batches, sw_batch, 3)), validity (device,
    (n_batches, sw_batch)), importance and 1/count."""
    starts = compute_window_starts(padded_shape, roi, overlap)
    n = starts.shape[0]
    n_pad = (-n) % (sw_batch * n_ranks)
    starts = np.concatenate([starts, np.zeros((n_pad, 3), np.int32)], axis=0)
    valid = np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    n_batches = starts.shape[0] // sw_batch
    inv_count = 1.0 / _count_map_cached(padded_shape, roi, overlap, mode, sigma_scale)
    return (
        starts.reshape(n_batches, sw_batch, 3),
        torch.from_numpy(valid.reshape(n_batches, sw_batch)).to(device),
        torch.from_numpy(_importance(roi, mode, sigma_scale)).to(device),
        torch.from_numpy(inv_count).to(device),
    )


def sliding_window_inference(
    volume,
    apply_fn: Callable,
    n_classes: int,
    spec: SlidingWindowSpec,
    *,
    device: torch.device | str,
    apply_takes_weight: bool = False,
    acc_dtype: str = "fp32",
) -> torch.Tensor:
    """Whole-volume inference.

    Args:
      volume: (D, H, W, C) or (1, D, H, W, C), numpy or tensor.
      apply_fn: ``apply_fn(windows) -> logits`` mapping a (sw_batch, C, rd,
        rh, rw) window stack to (sw_batch, K', rd, rh, rw) logits, K' >=
        n_classes (extra channels are blended and cropped); with
        ``apply_takes_weight``, ``apply_fn(windows, wgt)`` receives the blend
        weight (sw_batch, 1, rd, rh, rw) and returns pre-weighted logits.
      n_classes: K.
      spec: grid/blending configuration.
      device: where the windows, the model and the accumulator live.
      acc_dtype: "fp32" (the MONAI contract) or "bf16" (each weighted window
        rounded to bf16 and added in bf16, as the JAX flat walk does).

    Returns:
      (D, H, W, K) float32 blended logits at the original size, on ``device``.
    """
    device = torch.device(device)
    vol, spatial, pads, padded, squeeze = pad_volume(volume, spec, device)
    starts, valid, imp, inv_count = _device_grid_cached(
        padded, tuple(spec.roi), spec.overlap, spec.mode, spec.sigma_scale, spec.sw_batch, device
    )
    acc = _walk_batches(vol, starts, valid, imp, inv_count, apply_fn, spec.roi, padded,
                        apply_takes_weight, ACC_DTYPES[acc_dtype])
    return crop_to_volume(acc, pads, spatial, n_classes, squeeze)


def pad_volume(volume, spec: SlidingWindowSpec, device):
    """(D, H, W, C) or (1, D, H, W, C) -> ((C, Dp, Hp, Wp) fp32 on
    ``device``, spatial, pads, padded, squeeze)."""
    with span("medseg.serve.upload"):
        vol = torch.as_tensor(volume)
        squeeze = vol.ndim == 5
        if squeeze:
            if vol.shape[0] != 1:
                raise ValueError("sliding_window_inference expects a single volume")
            vol = vol[0]
        spatial = tuple(int(s) for s in vol.shape[:3])
        pads = _pad_amounts(spatial, tuple(spec.roi), spec.bucket_multiple)
        padded = tuple(s + lo + hi for s, (lo, hi) in zip(spatial, pads))
        vol = vol.to(device=device, dtype=torch.float32).permute(3, 0, 1, 2)  # (C, D, H, W)
        if any(lo or hi for lo, hi in pads):
            vol = F.pad(vol, [p for lo_hi in reversed(pads) for p in lo_hi])  # last dim first
    return vol, spatial, pads, padded, squeeze


def _walk_batches(vol, starts, valid, imp, inv_count, apply_fn, roi, padded,
                  apply_takes_weight: bool, acc_dtype: torch.dtype) -> torch.Tensor:
    """The flat walk over the batches ``starts`` (host, (n, sw_batch, 3))
    with their validity (device, (n, sw_batch)): the (K', Dp, Hp, Wp)
    accumulator of their weighted logits, added window by window."""
    rd, rh, rw = roi

    def window(t: torch.Tensor, s) -> torch.Tensor:
        return t[..., s[0] : s[0] + rd, s[1] : s[1] + rh, s[2] : s[2] + rw]

    acc = None
    with span("medseg.serve.walk"):
        for starts_b, valid_b in zip(starts, valid):
            windows = torch.stack([window(vol, s) for s in starts_b])
            inv_w = torch.stack([window(inv_count, s) for s in starts_b])
            wgt = (imp[None] * inv_w * valid_b[:, None, None, None])[:, None]
            with span("medseg.serve.forward"):
                out = apply_fn(windows, wgt) if apply_takes_weight else apply_fn(windows)
            if not apply_takes_weight:
                out = out.float() * wgt
            if acc is None:
                acc = torch.zeros((out.shape[1],) + padded, dtype=acc_dtype, device=vol.device)
            for s, o in zip(starts_b, out):
                window(acc, s).add_(o.to(acc.dtype))
    return acc


def sliding_window_inference_sharded(
    volume,
    apply_fn: Callable,
    n_classes: int,
    spec: SlidingWindowSpec,
    mesh,
    *,
    apply_takes_weight: bool = False,
) -> torch.Tensor:
    """Whole-volume inference with the window grid sharded over the ranks
    of ``mesh`` (counterpart of the JAX ``sliding_window_inference_sharded``).

    The grid is padded with zero-weight windows to a multiple of
    ``spec.sw_batch`` x ranks, as the JAX walk pads it; rank r walks the
    r-th contiguous block of batches (the JAX ``P("data")`` layout) into an
    fp32 accumulator of its own, and one all-reduce sums the ranks'
    accumulators, so every rank returns the same logits. No halo exchange:
    windows overlap only in the accumulator. Every rank runs every batch of
    its block, padding windows included, so that each contributes an
    accumulator of the same shape.

    ``apply_fn`` and ``apply_takes_weight`` are those of
    ``sliding_window_inference``: False is the JAX "ndhwc"/"ndchw" form
    (logits, weighted here), True the "flatk" form the JAX ``Validator``
    uses (the fused forward's out head multiplies by the weight, K padded
    with ``class_pad``). The weight is importance x 1/count x validity per
    window, as in the unsharded walk; the JAX walk divides by the count
    after its psum instead, which is the same sum (the weight is linear).
    At one rank the result is the unsharded walk's (fp32 accumulator) bit
    for bit; at more, only the order of the fp32 additions differs.

    Returns (D, H, W, K) fp32 logits on ``mesh.device``.
    """
    device = mesh.device
    vol, spatial, pads, padded, squeeze = pad_volume(volume, spec, device)
    starts, valid, imp, inv_count = _device_grid_cached(
        padded, tuple(spec.roi), spec.overlap, spec.mode, spec.sigma_scale, spec.sw_batch, device,
        mesh.data,
    )
    per_rank = starts.shape[0] // mesh.data
    mine = slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)
    acc = _walk_batches(vol, starts[mine], valid[mine], imp, inv_count, apply_fn, spec.roi,
                        padded, apply_takes_weight, torch.float32)
    mesh.all_reduce_(acc)
    return crop_to_volume(acc, pads, spatial, n_classes, squeeze)


def crop_to_volume(acc: torch.Tensor, pads, spatial, n_classes: int, squeeze: bool) -> torch.Tensor:
    """(K', Dp, Hp, Wp) accumulator -> (D, H, W, K) fp32 at the original size
    (with a leading 1 when ``squeeze``)."""
    (d0, _), (h0, _), (w0, _) = pads
    d, h, w = spatial
    view = acc[:n_classes, d0 : d0 + d, h0 : h0 + h, w0 : w0 + w].permute(1, 2, 3, 0)
    out = torch.empty(view.shape, dtype=torch.float32, device=acc.device).copy_(view)  # one pass
    return out[None] if squeeze else out
