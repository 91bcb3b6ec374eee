"""MONAI 0.6 ``DiceCELoss`` in its two configurations, in float32.

- CT: ``DiceCELoss(to_onehot_y=True, softmax=True)`` on label indices.
- MRI (BraTS): ``DiceCELoss(to_onehot_y=False, sigmoid=True)`` on a
  multi-channel target; its cross-entropy term takes the target's argmax over
  channels as the class index (MONAI 0.6 does so whenever the target has as
  many channels as the logits).

Dice: ``1 - (2 sum(p t) + 1e-5) / (sum(t) + sum(p) + 1e-5)`` per sample and
class over the voxels, background included, averaged over samples and
classes. Cross-entropy: the mean over voxels of ``-log_softmax`` at the
class. The loss is their sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SMOOTH = 1e-5


def dice_ce(logits: torch.Tensor, target: torch.Tensor, task: str) -> torch.Tensor:
    """``logits`` (B, K, D, H, W); ``target`` (B, 1, D, H, W) label indices
    (CT) or (B, K, D, H, W) channel masks (MRI)."""
    logits = logits.float()
    k = logits.shape[1]
    if task == "ct":
        index = target[:, 0].long()
        probs = torch.softmax(logits, dim=1)
        onehot = F.one_hot(index, k).permute(0, 4, 1, 2, 3).float()
    elif task == "mri":
        onehot = target.float()
        probs = torch.sigmoid(logits)
        index = onehot.argmax(dim=1)
    else:
        raise ValueError(f"task {task!r} is not 'ct' or 'mri'")
    dims = (2, 3, 4)
    inter = (probs * onehot).sum(dims)
    dice = 1.0 - (2.0 * inter + SMOOTH) / (onehot.sum(dims) + probs.sum(dims) + SMOOTH)
    ce = -torch.log_softmax(logits, dim=1).gather(1, index.unsqueeze(1)).mean()
    return dice.mean() + ce
