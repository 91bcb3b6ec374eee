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
``acc_dtype``). The fused forward is a ``kernels.unetr_of.GraphedForward``
(``Validator.graphed``): on a CUDA device a window batch shape's first batch
runs eagerly, its second is captured as a CUDA graph and every later one
replays it, bit for bit the eager forward; CPU tensors always run
``fast_apply_v3`` eagerly.

With a data-parallel ``mesh`` (``medseg_torch.parallel``), as the JAX
Validator with its mesh, every rank runs the same validation with the window
grid sharded over the ranks: the z-row walk's d-starts where the fast path
and ``zrow_supported`` hold (``sliding_window_inference_zrow_sharded``), the
flat walk's batches otherwise (``sliding_window_inference_sharded``). The
all-reduced logits are the same bits on every rank, so every rank computes
the same metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from medseg_torch.kernels.unetr_of import GraphedForward, fast_path_supported, fused_weights
from medseg_torch.ops.metrics import ConfusionAccumulator, DiceAccumulator, HausdorffAccumulator
from medseg_torch.ops.post import argmax_onehot, sigmoid_threshold, to_onehot
from medseg_torch.ops.sliding_window import (
    SlidingWindowSpec,
    sliding_window_inference,
    sliding_window_inference_sharded,
    zrow_supported,
)
from medseg_torch.ops.swi_zrow import (
    sliding_window_inference_zrow,
    sliding_window_inference_zrow_sharded,
)


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
      model: ``medseg_torch.models.unetr.UNETR`` or any other model whose
        ``forward(x, return_encoder_features=False)`` gives window logits
        (``models.swin_unetr.SwinUNETR``, always served through its module);
        moved to ``device``. Its ``dtype`` (default fp32) is the kernels'
        compute dtype and the dtype of the window logits.
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
      mesh: a ``medseg_torch.parallel.Mesh`` to shard the window grid over
        (every rank calls the Validator on the same volumes), or None.

    ``graphed``: the fast path's ``GraphedForward`` (its ``captures`` and
    ``replays``), None off the fast path.
    """

    def __init__(self, model, n_classes: int, task: str, spec: SlidingWindowSpec, *,
                 use_fast_path: bool = True, acc_dtype: str = "fp32",
                 device: torch.device | str, mesh=None) -> None:
        self.device = torch.device(device)
        self.mesh = mesh
        self.model = model.to(self.device).eval()
        self.n_classes = n_classes
        self.task = task
        self.spec = spec
        window = (spec.sw_batch, self.model.in_channels, *spec.roi)
        self.use_fast_path = use_fast_path and fast_path_supported(self.model, window, self.device)
        self.acc_dtype = acc_dtype
        self.graphed = None
        if self.use_fast_path:
            # both walks' forward: (windows, wgt) for K3, (..., starts, acc) for
            # K4; the kernels' weights cast once
            self.graphed = GraphedForward(self.model, fused_weights(self.model))
            apply_fn = self._apply_acc = self.graphed
        else:

            def apply_fn(windows):
                return self.model(windows, return_encoder_features=False)

        self._apply_fn = apply_fn

    @torch.no_grad()
    def infer_volume(self, image, spec: SlidingWindowSpec | None = None) -> torch.Tensor:
        """Blended whole-volume logits, (D, H, W, K) fp32 on the device."""
        spec = spec or self.spec
        if self.mesh is not None:
            return self._infer_sharded(image, spec)
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

    def _infer_sharded(self, image, spec: SlidingWindowSpec) -> torch.Tensor:
        spatial = tuple(int(v) for v in image.shape[-4:-1])
        if self.use_fast_path and zrow_supported(spatial, spec):
            return sliding_window_inference_zrow_sharded(
                image, self._apply_acc, self.n_classes, spec, self.mesh,
                acc_dtype=self.acc_dtype,
            )
        return sliding_window_inference_sharded(
            image, self._apply_fn, self.n_classes, spec, self.mesh,
            apply_takes_weight=self.use_fast_path,
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
