"""Shared CLI plumbing (counterpart of ``medseg/cli/common.py``): dataset
setup, fold iteration, device placement, config overrides, the model."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from medseg_torch.data.dataset import CrossValidationFolds, kfold_split, load_decathlon_datalist
from medseg_torch.models.unetr import UNETR


def resolve_datalist(data_dir: str, dataset_name: str) -> list[dict]:
    """The "training" list of ``DATA_DIR/DATASET_NAME/dataset.json`` (an MSD
    task directory or a custom one of the same layout)."""
    json_path = os.path.join(data_dir, dataset_name, "dataset.json")
    if not os.path.exists(json_path):
        raise FileNotFoundError(
            f"expected Decathlon-format dataset at {json_path} "
            "(imagesTr/, labelsTr/, dataset.json with a 'training' list)"
        )
    return load_decathlon_datalist(json_path, True, "training")


def fold_datalists(
    datalist: list[dict], dataset_name: str, n_folds: int, seed: int
) -> list[tuple[list[dict], list[dict]]]:
    """Per-fold (train, val) lists: MSD tasks ("Task" in the name) take the
    seeded ``CrossValidation`` partition, custom datasets contiguous k-fold."""
    folds = []
    if "Task" in dataset_name:
        cv = CrossValidationFolds(datalist, nfolds=n_folds, seed=seed)
        for f in range(n_folds):
            train = cv.get_datalist([g for g in range(n_folds) if g != f])
            folds.append((train, cv.get_datalist(f)))
    else:
        for train_idx, val_idx in kfold_split(len(datalist), n_folds):
            folds.append(([datalist[i] for i in train_idx], [datalist[i] for i in val_idx]))
    return folds


def make_output_dir(root_dir: str, pretrained: str, dataset_name: str, fold: int) -> str:
    """``ROOT_DIR[_pretrained_ranking|_pretrained_contrast]/DATASET_NAME_<fold>``
    (the suffix from the pretrained path's name), created."""
    if "ranking" in pretrained:
        root_dir = root_dir + "_pretrained_ranking"
    elif "contrast" in pretrained:
        root_dir = root_dir + "_pretrained_contrast"
    out = os.path.join(root_dir, f"{dataset_name}_{fold}")
    os.makedirs(out, exist_ok=True)
    return out


def subsample_train(train_list: list[dict], train_size: float) -> list[dict]:
    """The label-budget subsample: the first ``train_size`` entries."""
    return train_list[: min(len(train_list), int(train_size))]


def device_put_batch(batch: dict, device: torch.device | str = "cuda") -> dict:
    """Numeric arrays of a collated batch to tensors on ``device``; 5-D
    arrays (a batch of channel-last volumes, as the host transforms give
    them) become NCDHW. Paths and other non-arrays stay on the host."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            t = torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            out[k] = t.movedim(-1, 1).contiguous() if t.ndim == 5 else t
        else:
            out[k] = v
    return out


def apply_overrides(cfg, args):
    """Apply CLI model-size / data overrides onto the dataset preset."""
    model = cfg.model
    crop = args.crop_size if args.crop_size else model.crop_size
    model = dataclasses.replace(
        model,
        crop_size=crop,
        feature_size=args.feature_size,
        hidden_size=args.hidden_size,
        mlp_dim=args.mlp_dim,
        num_heads=args.num_heads,
        num_layers=args.num_layers,
        out_channels=args.n_classes,
    )
    data = dataclasses.replace(cfg.data, crop_size=crop, num_workers=args.num_workers)
    return cfg.replace(model=model, data=data)


def build_model(args, cfg, *, remat: bool = True) -> UNETR:
    """The UNETR of the (possibly overridden) model config; ``--bf16``
    selects the bf16 compute dtype. ``remat`` recomputes the stages in the
    backward pass (nothing at inference)."""
    m = cfg.model
    return UNETR(
        in_channels=m.in_channels,
        out_channels=m.out_channels,
        img_size=(m.crop_size,) * 3,
        feature_size=m.feature_size,
        hidden_size=m.hidden_size,
        mlp_dim=m.mlp_dim,
        num_heads=m.num_heads,
        num_layers=m.num_layers,
        dtype=torch.bfloat16 if args.bf16 else None,
        remat=remat,
    )
