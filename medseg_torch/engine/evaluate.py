"""Validation: sliding-window inference + metrics (counterpart of
``medseg/engine/evaluate.py``).

Per volume: blended whole-volume logits, the task's post-transform, Dice
accumulation (with ``all_metrics``, also precision, recall and Hausdorff,
all on the device); then mean and per-class aggregates. With the fast path (the
default) the windows go through the fused serving forward
(``kernels.unetr_of.fast_apply_v3``, blend weight folded into its out head),
where ``kernels.unetr_of.fast_path_supported`` accepts the window shape on
the device (as the JAX Validator checks ``fast_path_supported_v2``), routed
as the JAX Validator routes them without a mesh: grids that
``zrow_supported`` accepts take the z-row walk, whose out head (K4) adds the
windows straight into the volume accumulator; other grids take the flat
walk (K3 logits added by slicing). The fused forward launches the CUDA
kernels on a CUDA device and runs their plain versions on the CPU. Without
the fast path, or where the predicate is false (a width the kernels lack, a
window below 48^3 on the card), the module forward runs through the flat
walk with an fp32 accumulator (the JAX "ndhwc" route, which does not read
``acc_dtype``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from medseg_torch.kernels.unetr_of import fast_apply_v3, fast_path_supported, fused_weights
from medseg_torch.ops.metrics import ConfusionAccumulator, DiceAccumulator, HausdorffAccumulator
from medseg_torch.ops.post import argmax_onehot, sigmoid_threshold, to_onehot
from medseg_torch.ops.sliding_window import (
    SlidingWindowSpec,
    sliding_window_inference,
    zrow_supported,
)
from medseg_torch.ops.swi_zrow import sliding_window_inference_zrow


@dataclasses.dataclass
class ValidationResult:
    mean_dice: float
    per_class_dice: np.ndarray
    mean_precision: float | None = None
    per_class_precision: np.ndarray | None = None
    mean_recall: float | None = None
    per_class_recall: np.ndarray | None = None
    mean_hausdorff: float | None = None
    per_class_hausdorff: np.ndarray | None = None


class Validator:
    """Sliding-window validator over a dataset of whole volumes.

    Args:
      model: ``medseg_torch.models.unetr.UNETR``; moved to ``device``. Its
        ``dtype`` (default fp32) is the kernels' compute dtype and the dtype
        of the window logits.
      n_classes: output channels.
      task: "ct" (argmax/one-hot post) or "mri" (sigmoid + threshold).
      spec: sliding-window grid/blending configuration.
      use_fast_path: the fused forward (kernels) and the z-row/flat routing
        where ``fast_path_supported`` accepts the window (``use_fast_path``
        then says whether it did); False runs the module forward through the
        flat walk.
      acc_dtype: "fp32" (default, the MONAI contract) or "bf16": the blend
        accumulator of the fast path's walks.
      device: where the model, the windows and the accumulator live.
    """

    def __init__(self, model, n_classes: int, task: str, spec: SlidingWindowSpec, *,
                 use_fast_path: bool = True, acc_dtype: str = "fp32",
                 device: torch.device | str) -> None:
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.n_classes = n_classes
        self.task = task
        self.spec = spec
        window = (spec.sw_batch, self.model.in_channels, *spec.roi)
        self.use_fast_path = use_fast_path and fast_path_supported(self.model, window, self.device)
        self.acc_dtype = acc_dtype
        if self.use_fast_path:
            weights = fused_weights(self.model)  # the kernels' weights, cast once

            def apply_fn(windows, wgt):
                return fast_apply_v3(self.model, windows, weights, out_scale=wgt)

            def apply_acc(windows, wgt, starts, acc):
                fast_apply_v3(self.model, windows, weights, out_scale=wgt, starts=starts, acc=acc)

            self._apply_acc = apply_acc
        else:

            def apply_fn(windows):
                return self.model(windows, return_encoder_features=False)

        self._apply_fn = apply_fn

    @torch.no_grad()
    def infer_volume(self, image, spec: SlidingWindowSpec | None = None) -> torch.Tensor:
        """Blended whole-volume logits, (D, H, W, K) fp32 on the device."""
        spec = spec or self.spec
        if not self.use_fast_path:
            return sliding_window_inference(
                image, self._apply_fn, self.n_classes, spec, device=self.device,
            )
        spatial = tuple(int(v) for v in image.shape[-4:-1])
        if zrow_supported(spatial, spec):
            return sliding_window_inference_zrow(
                image, self._apply_acc, self.n_classes, spec, device=self.device,
                acc_dtype=self.acc_dtype,
            )
        return sliding_window_inference(
            image, self._apply_fn, self.n_classes, spec, device=self.device,
            apply_takes_weight=True, acc_dtype=self.acc_dtype,
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

    def __call__(self, volumes: Iterable[dict], *, all_metrics: bool = False) -> ValidationResult:
        """Metrics over ``volumes`` (dicts of a channels-last ``image`` and
        ``label``, each on the host or on any device): Dice, and with
        ``all_metrics`` precision, recall and Hausdorff (HD100)."""
        dice = DiceAccumulator()
        prec = ConfusionAccumulator("precision") if all_metrics else None
        rec = ConfusionAccumulator("sensitivity") if all_metrics else None
        hsd = HausdorffAccumulator() if all_metrics else None
        for batch in volumes:
            pred = self.predict_mask(batch["image"])[None]
            lab = self._post_label(torch.as_tensor(batch["label"]).to(self.device))
            if lab.ndim == 4:
                lab = lab[None]
            dice(pred, lab)
            if all_metrics:
                prec(pred, lab)
                rec(pred, lab)
                hsd(pred, lab)
        result = ValidationResult(
            mean_dice=float(dice.aggregate("mean")),
            per_class_dice=dice.aggregate("mean_batch"),
        )
        if all_metrics:
            result.mean_precision = float(prec.aggregate("mean"))
            result.per_class_precision = prec.aggregate("mean_batch")
            result.mean_recall = float(rec.aggregate("mean"))
            result.per_class_recall = rec.aggregate("mean_batch")
            result.mean_hausdorff = float(hsd.aggregate("mean"))
            result.per_class_hausdorff = hsd.aggregate("mean_batch")
        return result
