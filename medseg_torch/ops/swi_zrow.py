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
(parity planes, z-packing), its W/H/D fold passes and its environment
switches are not part of the port.

``sliding_window_inference_zrow_sharded`` splits the d-starts over the ranks
of a data-parallel mesh (``medseg_torch.parallel``): each rank walks its
block of d-starts into a full-depth accumulator of its own and one
all-reduce merges them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from medseg_torch.kernels.unetr_of import class_pad
from medseg_torch.ops.sliding_window import (
    ACC_DTYPES,
    SlidingWindowSpec,
    _count_map_cached,
    _importance,
    crop_to_volume,
    pad_volume,
    per_dim_window_starts,
    zrow_supported,
)
from medseg_torch.utils.profiling import span

__all__ = ["sliding_window_inference_zrow", "sliding_window_inference_zrow_sharded",
           "zrow_supported"]

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
    vol, spatial, pads, padded, squeeze = _zrow_volume(volume, spec, device)
    d_starts = per_dim_window_starts(padded, tuple(spec.roi), spec.overlap)[0]
    acc = _walk_d_starts(vol, d_starts, apply_fn, n_classes, spec, padded, acc_dtype)
    return crop_to_volume(acc, pads, spatial, n_classes, squeeze)


def _zrow_volume(volume, spec: SlidingWindowSpec, device):
    vol = torch.as_tensor(volume)
    spatial = tuple(int(s) for s in vol.shape[-4:-1])
    if not zrow_supported(spatial, spec):
        raise ValueError("the z-row walk requires even roi/pads and even window starts; "
                         "use the flat walk (sliding_window_inference) for this grid")
    return pad_volume(vol, spec, device)


def _walk_d_starts(vol, d_starts, apply_fn, n_classes: int, spec: SlidingWindowSpec, padded,
                   acc_dtype: str) -> torch.Tensor:
    """The z-row walk over ``d_starts`` into a (K_pad, Dp, Hp, Wp)
    accumulator of ``acc_dtype``: per d-start, groups of ``h_group`` h-rows,
    each with all its w-windows in one model batch."""
    roi = tuple(spec.roi)
    _, h_starts, w_starts = per_dim_window_starts(padded, roi, spec.overlap)
    h_group = _pick_h_group(len(h_starts), len(w_starts))
    imp, inv_count = _device_constants_cached(
        padded, roi, spec.overlap, spec.mode, spec.sigma_scale, vol.device
    )
    rd, rh, rw = roi
    with span("medseg.serve.walk"):
        acc = torch.zeros((class_pad(n_classes),) + padded, dtype=ACC_DTYPES[acc_dtype],
                          device=vol.device)
        for d0 in d_starts:
            for rows in np.asarray(h_starts).reshape(-1, h_group):
                starts = torch.tensor([(d0, h0, w0) for w0 in w_starts for h0 in rows],
                                      dtype=torch.int32)
                windows = torch.stack([vol[:, d : d + rd, h : h + rh, w : w + rw]
                                       for d, h, w in starts.tolist()])
                wgt = torch.stack([inv_count[d : d + rd, h : h + rh, w : w + rw]
                                   for d, h, w in starts.tolist()])
                wgt = (imp[None] * wgt)[:, None]
                with span("medseg.serve.forward"):
                    apply_fn(windows, wgt, starts, acc)
    return acc


def sliding_window_inference_zrow_sharded(
    volume,
    apply_fn: Callable,
    n_classes: int,
    spec: SlidingWindowSpec,
    mesh,
    *,
    acc_dtype: str = "bf16",
) -> torch.Tensor:
    """The z-row walk with its d-starts split over the ranks of ``mesh``
    (counterpart of the JAX ``sliding_window_inference_zrow_sharded``).

    The d-starts are padded to a multiple of the ranks with invalid entries
    (as the JAX walk pads them with validity 0), and rank r takes the r-th
    contiguous block, skipping the invalid ones (a zero-weight slab adds
    nothing). Each rank's ``apply_fn`` (K4 in the fused forward) adds its
    windows into a full-depth local accumulator of ``acc_dtype``; the ranks'
    accumulators are then summed by one all-reduce in fp32 for either
    ``acc_dtype`` (the JAX walk psums a bf16 accumulator in bf16; here a
    bf16 one is widened first, so the cross-rank sum rounds nowhere; gloo
    and NCCL both reduce bf16 as well).
    No halo exchange: slabs overlap only in the accumulator. At one rank
    the result is the unsharded walk's bit for bit; at more, the order of
    the additions where slabs of two ranks overlap differs.

    Returns (D, H, W, K) fp32 logits on ``mesh.device``.
    """
    vol, spatial, pads, padded, squeeze = _zrow_volume(volume, spec, mesh.device)
    d_starts = list(per_dim_window_starts(padded, tuple(spec.roi), spec.overlap)[0])
    per_rank = -(-len(d_starts) // mesh.data)  # padded to a multiple of the ranks
    mine = d_starts[mesh.rank * per_rank : (mesh.rank + 1) * per_rank]
    acc = _walk_d_starts(vol, mine, apply_fn, n_classes, spec, padded, acc_dtype).float()
    mesh.all_reduce_(acc)
    return crop_to_volume(acc, pads, spatial, n_classes, squeeze)
