"""Typed configuration with named presets (a copy of ``medseg/config.py``).

The reference hard-codes its configuration across its two CLI scripts: crop
size and channels by dataset-name substring (``unetr_segmentation_3d.py:309-318``),
loss selection by CT-vs-MRI branch, and inline constants (5 folds, 25000
iterations / eval every 500, AdamW weight_decay=1e-5, ...). Every one of
those constants is a dataclass field here with the reference default, as in
the JAX package, whose copy this is.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """UNETR-B/16 (the only architecture the reference runs,
    `unetr_segmentation_3d.py:501-513`)."""

    in_channels: int = 1
    out_channels: int = 14
    crop_size: int = 96
    feature_size: int = 16
    hidden_size: int = 768
    mlp_dim: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    patch_size: int = 16
    dropout_rate: float = 0.0
    res_block: bool = True
    compute_dtype: Literal["float32", "bfloat16"] = "float32"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_dir: str = "./dataset"
    dataset_name: str = "abdomenCT"
    task: Literal["ct", "mri"] = "ct"  # CT -> softmax DiceCE; MRI/BraTS -> sigmoid
    n_folds: int = 5  # seg :295
    cv_seed: int = 12345  # seg :529
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)  # seg :328
    intensity_window: tuple[float, float] = (-175.0, 250.0)  # seg :334-335
    crop_size: int = 96
    num_crop_samples: int = 4  # RandCropByPosNegLabeld num_samples, seg :347
    pos_neg_ratio: tuple[float, float] = (1.0, 1.0)  # seg :345-346
    flip_prob: float = 0.10  # seg :354
    rot90_prob: float = 0.10  # seg :368
    shift_prob: float = 0.50  # seg :374
    shift_offset: float = 0.10  # seg :373
    num_workers: int = 4  # seg :587
    crop_foreground: bool = True  # CT path only (BraTS branch comments it out)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4  # CLI default, seg :285
    weight_decay: float = 1e-5  # seg :522
    max_iterations: int = 25000  # seg :599
    eval_num: int = 500  # seg :600
    batch_size: int = 1  # volumes per step; crops multiply this (seg :586-588)
    train_size: float = 1e6  # label-budget subsample, seg :284
    donate_state: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    learning_rate: float = 1e-4  # pre :311
    weight_decay: float = 1e-5  # pre :466
    temperature: float = 0.1  # pre :312
    loss: Literal["ranking", "contrastive"] = "ranking"  # pre :313
    num_partitions: int = 4  # pre :330
    batch_size: int = 2  # volumes; x2 crops -> device batch 4 (pre :331)
    max_iterations: int = 250  # pre :470
    eval_num: int = 10  # pre :471
    rtol: float = 1e-2  # convergence rule, pre :546-551
    convergence_window: int = 10  # mean over last 10 epoch losses
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    sw_overlap: float = 0.25  # seg :109 default
    sw_batch: int = 4  # seg :109
    sw_mode: Literal["constant", "gaussian"] = "constant"
    bucket_multiple: int = 32  # bound recompiles across heterogeneous volumes


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    pretrain: PretrainConfig = PretrainConfig()
    eval: EvalConfig = EvalConfig()

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _dataset_geometry(dataset_name: str, n_classes: int):
    """Crop size / channel count by dataset-name substring — the reference's
    dispatch rule (`unetr_segmentation_3d.py:309-318`)."""
    if "Task01" in dataset_name:
        return 128, 4, "mri"
    if "Task09" in dataset_name or "Task02" in dataset_name:
        return 96, 1, "ct"
    # abdomenCT/BTCV branch: reference sets crop 16 (token grid 1^3, a known
    # quirk flagged in SURVEY.md §2.1); we keep 96 as the sane default and
    # expose the quirk via `strict_reference_quirks`.
    return 96, 1, "ct"


def preset(dataset_name: str, n_classes: int, *, strict_reference_quirks: bool = False) -> ExperimentConfig:
    crop, in_ch, task = _dataset_geometry(dataset_name, n_classes)
    if strict_reference_quirks and task == "ct" and "Task" not in dataset_name:
        crop = 16  # reference abdomenCT branch, seg :316-318
    model = ModelConfig(
        in_channels=in_ch, out_channels=n_classes, crop_size=crop
    )
    data = DataConfig(
        dataset_name=dataset_name,
        task=task,
        crop_size=crop,
        crop_foreground=(task == "ct"),
    )
    return ExperimentConfig(model=model, data=data)


# Named presets mirroring the reference usage strings
# (`unetr_segmentation_3d.py:271-276`).
task01_brats = lambda: preset("Task01_BrainTumour", 4)
task02_heart = lambda: preset("Task02_Heart", 2)
task09_spleen = lambda: preset("Task09_Spleen", 2)
btcv14 = lambda: preset("abdomenCT", 14)
