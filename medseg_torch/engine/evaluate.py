"""Validation: sliding-window inference + Dice (counterpart of
``medseg/engine/evaluate.py``).

Per volume: blended whole-volume logits through the fused serving forward
(``kernels.unetr_of.fast_apply_v3`` with the blend weight folded into its
out head), the task's post-transform, Dice accumulation; then mean and
per-class aggregates. The fused forward launches the CUDA kernels on a CUDA
device and runs their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights
from medseg_torch.ops.metrics import DiceAccumulator
from medseg_torch.ops.post import argmax_onehot, sigmoid_threshold, to_onehot
from medseg_torch.ops.sliding_window import SlidingWindowSpec, sliding_window_inference


@dataclasses.dataclass
class ValidationResult:
    mean_dice: float
    per_class_dice: np.ndarray


class Validator:
    """Sliding-window validator over a dataset of whole volumes.

    Args:
      model: ``medseg_torch.models.unetr.UNETR``; moved to ``device``. Its
        ``dtype`` (default fp32) is the kernels' compute dtype and the dtype
        of the window logits; the blend accumulates in fp32.
      n_classes: output channels.
      task: "ct" (argmax/one-hot post) or "mri" (sigmoid + threshold).
      spec: sliding-window grid/blending configuration.
      device: where the model, the windows and the accumulator live.
    """

    def __init__(self, model, n_classes: int, task: str, spec: SlidingWindowSpec, *,
                 device: torch.device | str) -> None:
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.n_classes = n_classes
        self.task = task
        self.spec = spec
        weights = fused_weights(self.model)  # the kernels' weights, cast once

        def apply_fn(windows, wgt):
            return fast_apply_v3(self.model, windows, weights, out_scale=wgt)

        self._apply_fn = apply_fn

    def infer_volume(self, image, spec: SlidingWindowSpec | None = None) -> torch.Tensor:
        """Blended whole-volume logits, (D, H, W, K) fp32 on the device."""
        return sliding_window_inference(
            image, self._apply_fn, self.n_classes, spec or self.spec,
            device=self.device, apply_takes_weight=True,
        )

    def predict_mask(self, image, spec: SlidingWindowSpec | None = None) -> torch.Tensor:
        logits = self.infer_volume(image, spec)
        if self.task == "ct":
            return argmax_onehot(logits, self.n_classes)
        return sigmoid_threshold(logits)

    def _post_label(self, label: torch.Tensor) -> torch.Tensor:
        if self.task == "ct":
            return to_onehot(label, self.n_classes)
        return label.float()  # BraTS labels already multi-channel

    def __call__(self, volumes: Iterable[dict]) -> ValidationResult:
        dice = DiceAccumulator()
        for batch in volumes:
            pred = self.predict_mask(batch["image"])[None]
            lab = self._post_label(torch.as_tensor(batch["label"], device=self.device))
            if lab.ndim == 4:
                lab = lab[None]
            dice(pred, lab)
        return ValidationResult(
            mean_dice=float(dice.aggregate("mean")),
            per_class_dice=dice.aggregate("mean_batch"),
        )
