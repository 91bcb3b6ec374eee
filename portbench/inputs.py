"""Seeded volumes and training batches, made on the device and handed to the
program on the host, as its callers hand them.

Every seed gives the same sizes and the same amount of work; only the values
differ. Fields are smooth random fields (trilinear upsampling of coarse
noise) plus voxel noise, so that intensities and labels form regions as in
real scans:

- CT (task "ct"): intensities windowed to [0, 1] as the CT chain leaves them;
  training labels are ``out_channels`` classes as regions, the image a class
  intensity plus texture.
- MRI (task "mri"): four channels z-scored over a brain-shaped nonzero
  region, zero outside; training labels are nested tumour regions (whole
  tumour, core, enhancing) as the four channels [background, TC, WT, ET].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.params import stream_seed

INPUT_STREAM = 2


def _smooth(gen, shape, cell: int, device) -> torch.Tensor:
    """A (N, C, D, H, W) field with features about ``cell`` voxels wide,
    scaled to unit standard deviation."""
    n, c, d, h, w = shape
    low = torch.randn((n, c) + tuple(math.ceil(s / cell) + 1 for s in (d, h, w)), generator=gen,
                      device=device)
    up = F.interpolate(low, size=(d, h, w), mode="trilinear", align_corners=True)
    return up / up.std().clamp_min(1e-6)


def _noise(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def _brain(gen, shape, device) -> torch.Tensor:
    """(N, 1, D, H, W) mask: an ellipsoid with a wavy edge."""
    n, _, d, h, w = shape
    axes = [torch.linspace(-1.0, 1.0, s, device=device) for s in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    r = (zz / 0.85) ** 2 + (yy / 0.8) ** 2 + (xx / 0.82) ** 2
    return (r + 0.08 * _smooth(gen, (n, 1, d, h, w), 24, device) < 1.0).float()


def _znorm_inside(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum(dim=(2, 3, 4), keepdim=True).clamp_min(1.0)
    mean = (x * mask).sum(dim=(2, 3, 4), keepdim=True) / n
    var = ((x - mean) ** 2 * mask).sum(dim=(2, 3, 4), keepdim=True) / n
    return (x - mean) / var.sqrt().clamp_min(1e-6) * mask


def serve_pool(config: dict, traffic: dict, seed: int, device) -> list[torch.Tensor]:
    """``traffic["pool"]`` distinct volumes, each (D, H, W, C) fp32 on the
    host, channels last, of the configuration's ``serve.volume`` size."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, INPUT_STREAM))
    c = config["model"]["in_channels"]
    shape = (1, c) + tuple(config["serve"]["volume"])
    pool = []
    for _ in range(traffic["pool"]):
        if config["task"] == "ct":
            v = (0.45 + 0.15 * _smooth(gen, shape, 48, device)
                 + 0.08 * _smooth(gen, shape, 12, device)
                 + 0.03 * _noise(gen, shape, device)).clamp_(0.0, 1.0)
        else:
            mask = _brain(gen, shape, device)
            v = (0.4 * _smooth(gen, shape, 32, device) + 0.2 * _smooth(gen, shape, 8, device)
                 + 0.1 * _noise(gen, shape, device))
            v = _znorm_inside(v, mask)
        pool.append(v[0].permute(1, 2, 3, 0).contiguous().cpu())
    return pool


def _ct_batch(gen, k: int, shape, device):
    n, _, d, h, w = shape
    scores = _smooth(gen, (n, k, d, h, w), 16, device)
    scores[:, 0] += 0.8  # background is the largest class, as in abdominal CT
    label = scores.argmax(dim=1, keepdim=True)
    level = torch.rand((k,), generator=gen, device=device) * 0.8 + 0.1
    image = (level[label] + 0.05 * _smooth(gen, shape, 8, device)
             + 0.03 * _noise(gen, shape, device)).clamp_(0.0, 1.0)
    return image, label.float()


def _mri_batch(gen, c: int, shape, device):
    n, _, d, h, w = shape
    one = (n, 1, d, h, w)
    brain = _brain(gen, one, device)
    wt = (_smooth(gen, one, 20, device) > 0.6) & (brain > 0)
    tc = wt & (_smooth(gen, one, 12, device) > 0.2)
    et = tc & (_smooth(gen, one, 8, device) > 0.2)
    label = wt.long() + tc.long() + et.long()  # 0 background, 1 WT, 2 TC, 3 ET
    level = torch.randn((4, c), generator=gen, device=device)  # per region and channel
    image = (level[label[:, 0]].permute(0, 4, 1, 2, 3)
             + 0.3 * _smooth(gen, (n, c, d, h, w), 16, device))
    image = _znorm_inside(image + 0.1 * _noise(gen, (n, c, d, h, w), device), brain)
    channels = torch.cat([label == 0, tc, wt, et], dim=1).float()  # [bg, TC, WT, ET]
    return image, channels


def train_pool(config: dict, traffic: dict, seed: int, device) -> list[dict]:
    """``traffic["pool"]`` batches, every crop distinct: ``image`` (B, C, r,
    r, r) fp32 and ``label`` (B, 1, r, r, r) fp32 class indices (CT) or (B,
    4, r, r, r) fp32 channel masks (MRI), on the host, as the segmentation
    CLI's loader hands them to the step."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, INPUT_STREAM))
    m = config["model"]
    r = config["train"]["crop"]
    shape = (traffic["crops_per_step"], m["in_channels"], r, r, r)
    pool = []
    for _ in range(traffic["pool"]):
        if config["task"] == "ct":
            image, label = _ct_batch(gen, m["out_channels"], shape, device)
        else:
            image, label = _mri_batch(gen, m["in_channels"], shape, device)
        pool.append({"image": image.contiguous().cpu(), "label": label.contiguous().cpu()})
    return pool
