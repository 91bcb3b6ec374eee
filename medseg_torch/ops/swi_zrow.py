"""Sliding-window inference by the z-row walk (counterpart of
``medseg/ops/swi_zrow.py`` ``sliding_window_inference_zrow``).

The same MONAI contract as the flat walk (``ops/sliding_window.py``), walked
in the JAX package's order: the d-starts, then groups of ``h_group`` h-rows,
then the ``n_w`` w-windows of each row, so one model batch holds
``h_group * n_w`` windows (window ``wi`` of row ``gg`` at index
``wi * h_group + gg``) and ``spec.sw_batch`` is not used. The walk is exact:
no padding windows and no validity mask.

The blend weight ``importance * 1/count`` goes to ``apply_fn`` together with
the windows' starts and the volume accumulator, ``(K_pad, Dp, Hp, Wp)`` in
``acc_dtype``, and ``apply_fn`` adds the weighted logits into it: the fused
forward's out head does that in its kernel (K4, ``conv_of.outhead_row_of``),
so no per-window logits and no fold pass exist. The JAX walk's TPU layouts
(parity planes, z-packing), its W/H/D fold passes, its environment switches
and its mesh-sharded variant are not part of the port.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from medseg_torch.kernels.unetr_of import class_pad
from medseg_torch.ops.sliding_window import (
    ACC_DTYPES,
    SlidingWindowSpec,
    _count_map_cached,
    _importance,
    _pad_amounts,
    crop_to_volume,
    per_dim_window_starts,
    zrow_supported,
)

__all__ = ["sliding_window_inference_zrow", "zrow_supported"]

TARGET_BATCH = 8  # windows per model batch the walk aims for (the JAX default)


def _pick_h_group(nh: int, n_w: int, target_batch: int = TARGET_BATCH) -> int:
    """Largest divisor of nh keeping the model batch (h_group * n_w) within
    ``target_batch`` (1 when none does)."""
    best = 1
    for g in range(2, nh + 1):
        if nh % g == 0 and g * n_w <= target_batch:
            best = g
    return best


@lru_cache(maxsize=4)
def _device_constants_cached(padded, roi, overlap, mode, sigma_scale, device):
    """Importance map and reciprocal count map on the device, once per
    (shape, spec, device)."""
    inv_count = 1.0 / _count_map_cached(padded, roi, overlap, mode, sigma_scale)
    return (
        torch.from_numpy(_importance(roi, mode, sigma_scale)).to(device),
        torch.from_numpy(inv_count).to(device),
    )


def sliding_window_inference_zrow(
    volume,
    apply_fn: Callable,
    n_classes: int,
    spec: SlidingWindowSpec,
    *,
    device: torch.device | str,
    acc_dtype: str = "bf16",
) -> torch.Tensor:
    """Whole-volume inference by the z-row walk.

    Args:
      volume: (D, H, W, C) or (1, D, H, W, C), numpy or tensor; its grid
        must pass ``zrow_supported``.
      apply_fn: ``apply_fn(windows, wgt, starts, acc)`` adds the logits of
        the (B, C, rd, rh, rw) windows, times their blend weight wgt (B, 1,
        rd, rh, rw), into ``acc`` at ``starts`` ((B, 3) int32 on the host),
        as ``fast_apply_v3(..., out_scale=wgt, starts=starts, acc=acc)`` does.
      n_classes: K; the accumulator holds ``class_pad(K)`` channels.
      spec: grid/blending configuration (``sw_batch`` unused).
      device: where the windows and the accumulator live.
      acc_dtype: "bf16" or "fp32", the accumulator's dtype.

    Returns:
      (D, H, W, K) float32 blended logits at the original size, on ``device``.
    """
    device = torch.device(device)
    vol = torch.as_tensor(volume)
    squeeze = vol.ndim == 5
    if squeeze:
        if vol.shape[0] != 1:
            raise ValueError("sliding_window_inference expects a single volume")
        vol = vol[0]
    spatial = tuple(int(s) for s in vol.shape[:3])
    roi = tuple(spec.roi)
    if not zrow_supported(spatial, spec):
        raise ValueError("the z-row walk requires even roi/pads and even window starts; "
                         "use the flat walk (sliding_window_inference) for this grid")
    pads = _pad_amounts(spatial, roi, spec.bucket_multiple)
    padded = tuple(s + lo + hi for s, (lo, hi) in zip(spatial, pads))
    vol = vol.to(device=device, dtype=torch.float32).permute(3, 0, 1, 2)  # (C, D, H, W)
    if any(lo or hi for lo, hi in pads):
        vol = F.pad(vol, [p for lo_hi in reversed(pads) for p in lo_hi])
    d_starts, h_starts, w_starts = per_dim_window_starts(padded, roi, spec.overlap)
    h_group = _pick_h_group(len(h_starts), len(w_starts))
    imp, inv_count = _device_constants_cached(
        padded, roi, spec.overlap, spec.mode, spec.sigma_scale, device
    )
    rd, rh, rw = roi
    acc = torch.zeros((class_pad(n_classes),) + padded, dtype=ACC_DTYPES[acc_dtype],
                      device=device)
    for d0 in d_starts:
        for rows in np.asarray(h_starts).reshape(-1, h_group):
            starts = torch.tensor([(d0, h0, w0) for w0 in w_starts for h0 in rows],
                                  dtype=torch.int32)
            windows = torch.stack([vol[:, d : d + rd, h : h + rh, w : w + rw]
                                   for d, h, w in starts.tolist()])
            wgt = torch.stack([inv_count[d : d + rd, h : h + rh, w : w + rw]
                               for d, h, w in starts.tolist()])
            apply_fn(windows, (imp[None] * wgt)[:, None], starts, acc)
    return crop_to_volume(acc, pads, spatial, n_classes, squeeze)
