"""Segmentation losses, NCDHW (counterpart of ``medseg/ops/losses.py``).

MONAI 0.6.0 ``DiceCELoss`` at the two reference configurations:

- CT / label-index path: ``DiceCELoss(to_onehot_y=True, softmax=True)``;
- BraTS / multi-label path: ``DiceCELoss(to_onehot_y=False, sigmoid=True)``.

Semantics, as the JAX package reproduces them:

- soft Dice, not squared-denominator, ``smooth_nr = smooth_dr = 1e-5``,
  background included, per-(sample, class) dice averaged over batch AND
  class, spatial reduction over D/H/W only;
- CE term: ``torch.nn.CrossEntropyLoss`` over voxels (mean). When the target
  has the prediction's channel count, MONAI argmaxes it to class indices
  first, also in the sigmoid/multi-label config (``_MULTILABEL_CE_ARGMAX``);
- total = dice + ce, equal weights, in fp32 whatever the logits' dtype.

Layout: predictions and multi-channel targets are ``(B, C, D, H, W)``;
label-index targets are ``(B, D, H, W)`` or ``(B, 1, D, H, W)``. This is the
CPU oracle of the fused CT loss (``medseg_torch.kernels.loss_of``) and the
MRI path's loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SMOOTH_NR = 1e-5
_SMOOTH_DR = 1e-5

# MONAI 0.6 DiceCELoss.ce() argmaxes a same-channel-count target even when the
# dice side is configured for (non-exclusive) multi-label sigmoid activation.
_MULTILABEL_CE_ARGMAX = True


def _squeeze_label_channel(labels: torch.Tensor) -> torch.Tensor:
    """(B, 1, D, H, W) label indices -> (B, D, H, W); others unchanged."""
    if labels.ndim == 5 and labels.shape[1] == 1:
        return labels[:, 0]
    return labels


def to_onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Label indices (B, D, H, W) or (B, 1, D, H, W) -> one-hot
    (B, C, D, H, W) float32."""
    labels = _squeeze_label_channel(labels)
    return F.one_hot(labels.long(), num_classes).movedim(-1, 1).float()


def dice_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    *,
    softmax: bool = False,
    sigmoid: bool = False,
    to_onehot_y: bool = False,
    include_background: bool = True,
    smooth_nr: float = _SMOOTH_NR,
    smooth_dr: float = _SMOOTH_DR,
) -> torch.Tensor:
    """Soft Dice loss, MONAI 0.6 ``DiceLoss`` semantics, classes at dim 1."""
    n_classes = logits.shape[1]
    probs = logits.float()
    if softmax:
        probs = torch.softmax(probs, dim=1)
    if sigmoid:
        probs = torch.sigmoid(probs)
    if to_onehot_y:
        target = to_onehot(target, n_classes)
    target = target.float()
    if not include_background:
        probs = probs[:, 1:]
        target = target[:, 1:]
    spatial = tuple(range(2, probs.ndim))
    intersection = (target * probs).sum(spatial)
    ground_o = target.sum(spatial)
    pred_o = probs.sum(spatial)
    f = 1.0 - (2.0 * intersection + smooth_nr) / (ground_o + pred_o + smooth_dr)
    return f.mean()  # over batch and class


def softmax_ce_with_label_indices(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss`` over voxels: mean of -log softmax at
    the label; labels (B, D, H, W) or (B, 1, D, H, W)."""
    labels = _squeeze_label_channel(labels)
    logp = torch.log_softmax(logits.float(), dim=1)
    picked = logp.gather(1, labels.long().unsqueeze(1))
    return -picked.mean()


def dice_ce_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    *,
    softmax: bool = False,
    sigmoid: bool = False,
    to_onehot_y: bool = False,
) -> torch.Tensor:
    """MONAI 0.6 ``DiceCELoss``: dice (as configured) + voxel CE, summed.

    ``target`` is label indices (B, D, H, W) or (B, 1, D, H, W) when
    ``to_onehot_y``, else a multi-channel float mask (B, C, D, H, W).
    """
    d = dice_loss(logits, target, softmax=softmax, sigmoid=sigmoid, to_onehot_y=to_onehot_y)
    if to_onehot_y:
        ce_target = target
    elif target.shape[1] == logits.shape[1] and _MULTILABEL_CE_ARGMAX:
        # MONAI 0.6 quirk: a same-channel-count target is argmaxed for the CE term
        ce_target = target.argmax(dim=1)
    else:
        ce_target = target[:, 0]
    return d + softmax_ce_with_label_indices(logits, ce_target)
