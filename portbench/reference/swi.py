"""Whole-volume sliding-window inference, MONAI 0.6's contract, in plain
PyTorch and float32.

Each spatial dim is padded with zeros up to the window (half before), then up
to a multiple of ``bucket_multiple``; window starts are ``k * int(roi * (1 -
overlap))`` for the fewest k whose window reaches the end, the last clipped to
``dim - roi`` (``dense_patch_slices``); each window's logits are weighted by
the importance map and the sum is divided by the summed importance; the
padding is cropped. The Gaussian importance is separable, centred at
``(roi - 1) / 2`` with sigma ``sigma_scale * roi``, peak-normalised to 1,
zeros raised to the smallest positive value.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def pads(shape, roi: int, multiple: int) -> list[tuple[int, int]]:
    out = []
    for dim in shape:
        target = max(dim, roi)
        if multiple > 1:
            target = math.ceil(target / multiple) * multiple
        extra = target - dim
        out.append((extra // 2, extra - extra // 2))
    return out


def starts_1d(dim: int, roi: int, overlap: float) -> list[int]:
    step = roi if roi == dim else max(1, int(roi * (1.0 - overlap)))
    n = 1
    while (n - 1) * step + roi < dim:
        n += 1
    return sorted({min(k * step, dim - roi) for k in range(n)})


def window_starts(padded, roi: int, overlap: float) -> list[tuple[int, int, int]]:
    per_dim = [starts_1d(d, roi, overlap) for d in padded]
    return [(a, b, c) for a in per_dim[0] for b in per_dim[1] for c in per_dim[2]]


def importance(roi: int, mode: str, sigma_scale: float, device) -> torch.Tensor:
    if mode == "constant":
        return torch.ones((roi,) * 3, dtype=torch.float32, device=device)
    x = np.arange(roi, dtype=np.float64)
    g = np.exp(-0.5 * ((x - (roi - 1) / 2.0) / (sigma_scale * roi)) ** 2)
    w = g[:, None, None] * g[None, :, None] * g[None, None, :]
    w = w / w.max()
    w = np.maximum(w, w[w > 0].min())
    return torch.from_numpy(w.astype(np.float32)).to(device)


@torch.no_grad()
def infer(volume: torch.Tensor, forward: Callable, n_classes: int, serve: dict,
          batch: int) -> torch.Tensor:
    """Blended logits (D, H, W, K) fp32 of a (D, H, W, C) volume on the
    volume's device; ``forward`` maps (B, C, r, r, r) windows to (B, K, r, r, r)
    logits; ``serve`` is the configuration's ``serve`` group."""
    roi = serve["roi"]
    shape = tuple(volume.shape[:3])
    pad = pads(shape, roi, serve["bucket_multiple"])
    vol = volume.float().permute(3, 0, 1, 2)
    vol = F.pad(vol, [p for lo_hi in reversed(pad) for p in lo_hi])
    padded = tuple(vol.shape[1:])
    imp = importance(roi, serve["mode"], serve["sigma_scale"], vol.device)
    acc = torch.zeros((n_classes,) + padded, dtype=torch.float32, device=vol.device)
    weight = torch.zeros(padded, dtype=torch.float32, device=vol.device)
    starts = window_starts(padded, roi, serve["overlap"])
    for i in range(0, len(starts), batch):
        chunk = starts[i:i + batch]
        windows = torch.stack([vol[:, a:a + roi, b:b + roi, c:c + roi] for a, b, c in chunk])
        logits = forward(windows).float()
        for (a, b, c), lg in zip(chunk, logits):
            acc[:, a:a + roi, b:b + roi, c:c + roi] += lg * imp
            weight[a:a + roi, b:b + roi, c:c + roi] += imp
    acc /= weight
    (d0, _), (h0, _), (w0, _) = pad
    d, h, w = shape
    return acc[:, d0:d0 + d, h0:h0 + h, w0:w0 + w].permute(1, 2, 3, 0).contiguous()
