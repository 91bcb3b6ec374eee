"""Dataset handling (a copy of ``medseg/data/dataset.py``).

- ``load_decathlon_datalist``: parse a ``dataset.json`` list of {"image",
  "label"} entries (or bare image paths) into absolute paths;
- ``kfold_split``: sklearn ``KFold(shuffle=False)``, contiguous folds;
- ``partition_dataset_indices`` / ``CrossValidationFolds``: MONAI's
  ``CrossValidation`` (a seeded shuffle, then strided partitions);
- ``ListDataset`` / ``CacheDataset``: map-style datasets applying a
  transform (with ``cache_rate > 0`` the deterministic prefix is computed
  once);
- ``DecathlonDataset`` / ``validate_msd_layout``: MONAI's MSD task layout
  and sections, and the check of an extracted task directory;
- ``decollate_batch``: a batched dict back into per-sample dicts.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Sequence

import numpy as np


def load_decathlon_datalist(
    json_path: str,
    is_segmentation: bool = True,
    data_list_key: str = "training",
    base_dir: str | None = None,
) -> list[dict]:
    with open(json_path) as f:
        meta = json.load(f)
    if data_list_key not in meta:
        raise KeyError(f"{data_list_key!r} not found in {json_path}")
    base = base_dir if base_dir is not None else os.path.dirname(os.path.abspath(json_path))
    out = []
    for entry in meta[data_list_key]:
        if isinstance(entry, str):  # "test" lists may be bare image paths
            entry = {"image": entry}
        item = dict(entry)
        for key in ("image", "label"):
            if key in item and not os.path.isabs(item[key]):
                item[key] = os.path.join(base, item[key])
        out.append(item)
    return out


def kfold_split(n_items: int, n_splits: int = 5):
    """sklearn KFold(shuffle=False) contract: contiguous folds, the first
    ``n_items % n_splits`` folds one element larger. Yields (train, test)."""
    indices = np.arange(n_items)
    sizes = np.full(n_splits, n_items // n_splits, dtype=int)
    sizes[: n_items % n_splits] += 1
    current = 0
    for size in sizes:
        test = indices[current : current + size]
        train = np.concatenate([indices[:current], indices[current + size :]])
        yield train, test
        current += size


def partition_dataset_indices(
    n: int, num_partitions: int, shuffle: bool = True, seed: int = 0
) -> list[np.ndarray]:
    """MONAI 0.6 ``partition_dataset`` rule: optionally shuffle the indices
    with ``np.random.RandomState(seed)``, then partition i is the strided
    slice ``indices[i::num_partitions]``."""
    indices = np.arange(n)
    if shuffle:
        rs = np.random.RandomState(seed)
        rs.shuffle(indices)
    return [indices[i::num_partitions] for i in range(num_partitions)]


class CrossValidationFolds:
    """MONAI ``CrossValidation``: seeded shuffle, then strided partition into
    ``nfolds``; ``get_datalist(folds)`` concatenates the folds in order."""

    def __init__(self, datalist: Sequence[dict], nfolds: int = 5, seed: int = 12345):
        self.datalist = list(datalist)
        self.nfolds = nfolds
        self.partitions = [
            list(p)
            for p in partition_dataset_indices(len(self.datalist), nfolds, shuffle=True, seed=seed)
        ]

    def get_datalist(self, folds) -> list[dict]:
        if isinstance(folds, int):
            folds = [folds]
        out = []
        for f in folds:
            out.extend(self.datalist[i] for i in self.partitions[f])
        return out


class ListDataset:
    """Map-style dataset: datalist entry -> transform(entry)."""

    def __init__(self, data: Sequence[dict], transform: Callable | None = None):
        self.data = list(data)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int):
        sample = dict(self.data[idx])
        return self.transform(sample) if self.transform else sample


class CacheDataset(ListDataset):
    """With ``cache_rate=0.0`` (the reference's setting) a plain
    ``ListDataset``; with > 0, ``cache_transform`` (the deterministic prefix)
    runs once at construction for that fraction of the items and
    ``transform`` (the random suffix) on every access."""

    def __init__(
        self,
        data: Sequence[dict],
        transform: Callable | None = None,
        cache_rate: float = 0.0,
        cache_transform: Callable | None = None,
    ):
        super().__init__(data, transform)
        self.cache_transform = cache_transform
        n_cache = int(len(self.data) * cache_rate) if cache_transform else 0
        self._cache: dict[int, dict] = {}
        for i in range(n_cache):
            self._cache[i] = cache_transform(dict(self.data[i]))

    def __getitem__(self, idx: int):
        if idx in self._cache:
            sample = dict(self._cache[idx])
            return self.transform(sample) if self.transform else sample
        sample = dict(self.data[idx])
        if self.cache_transform:
            sample = self.cache_transform(sample)
        return self.transform(sample) if self.transform else sample


class DecathlonDataset(ListDataset):
    """MONAI ``DecathlonDataset`` layout and section handling.

    Expects the MSD on-disk layout ``root_dir/TaskXX_Name/{imagesTr,labelsTr,
    imagesTs,dataset.json}``. ``section`` selects:

    - "training"/"validation": the "training" datalist split by a seeded
      index shuffle (``np.random.RandomState(seed)``, seed default 0): the
      first ``int(len * val_frac)`` shuffled indices are "validation"
      (val_frac default 0.2), the rest "training" (the MONAI 0.6
      ``DecathlonDataset._split_datalist`` rule);
    - "test": the "test" list (bare imagesTs paths -> {"image": path}).

    ``properties`` holds the dataset.json header fields (labels, modality,
    tensorImageSize, ...). There is no download: ``download=True`` only adds
    to the message of the ``FileNotFoundError`` of a missing task. Under
    ``CrossValidationFolds`` the fold partition replaces this split, as
    MONAI's ``CrossValidation`` overrides ``_split_datalist``.
    """

    _PROPERTY_KEYS = (
        "name", "description", "reference", "licence", "tensorImageSize",
        "modality", "labels", "numTraining", "numTest",
    )

    def __init__(
        self,
        root_dir: str,
        task: str,
        section: str = "training",
        transform: Callable | None = None,
        download: bool = False,
        seed: int = 0,
        val_frac: float = 0.2,
    ):
        task_dir = os.path.join(root_dir, task)
        json_path = os.path.join(task_dir, "dataset.json")
        if not os.path.exists(json_path):
            hint = (
                " (download=True is not supported in this offline build; place "
                "the extracted MSD task at this path)"
                if download
                else ""
            )
            raise FileNotFoundError(f"MSD layout not found: {json_path}{hint}")
        with open(json_path) as f:
            meta = json.load(f)
        self.properties = {k: meta[k] for k in self._PROPERTY_KEYS if k in meta}
        self.section = section
        key = "test" if section == "test" else "training"
        datalist = load_decathlon_datalist(json_path, True, key)
        validate_msd_layout(task_dir, meta, datalist)
        super().__init__(self._split_datalist(datalist, seed, val_frac), transform)

    def _split_datalist(self, datalist: list[dict], seed: int, val_frac: float):
        if self.section == "test":
            return datalist
        indices = np.arange(len(datalist))
        np.random.RandomState(seed).shuffle(indices)
        val_len = int(len(datalist) * val_frac)
        keep = indices[:val_len] if self.section == "validation" else indices[val_len:]
        return [datalist[i] for i in keep]


def validate_msd_layout(task_dir: str, meta: dict, datalist: list[dict]) -> None:
    """Check an extracted MSD task directory (the offline stand-in for
    MONAI ``DecathlonDataset(download=True)``'s download, extract and verify
    step): ``imagesTr``/``labelsTr`` present, every datalist file on disk,
    the declared ``numTraining`` consistent with the list. Raises a
    ``RuntimeError`` naming what is missing."""
    problems: list[str] = []
    for sub in ("imagesTr", "labelsTr"):
        if not os.path.isdir(os.path.join(task_dir, sub)):
            problems.append(f"missing directory {sub}/")
    missing_files = [
        p for item in datalist for k in ("image", "label")
        if isinstance(p := item.get(k), str) and not os.path.exists(p)
    ]
    if missing_files:
        shown = ", ".join(os.path.basename(p) for p in missing_files[:5])
        more = f" (+{len(missing_files) - 5} more)" if len(missing_files) > 5 else ""
        problems.append(f"{len(missing_files)} datalist files missing: {shown}{more}")
    declared = meta.get("numTraining")
    n_train = len(meta.get("training", []))
    if isinstance(declared, int) and n_train and declared != n_train:
        problems.append(f"dataset.json declares numTraining={declared} but lists {n_train}")
    if problems:
        raise RuntimeError(
            f"MSD task at {task_dir} is incomplete or corrupt: " + "; ".join(problems)
            + ". Re-extract the task archive (download is unsupported offline)."
        )


def decollate_batch(batch: dict) -> list[dict]:
    """Split a batched dict into per-sample dicts (MONAI ``decollate_batch``)."""
    sizes = {len(v) for v in batch.values() if isinstance(v, (np.ndarray, list))}
    if not sizes:
        return [batch]
    n = max(sizes)
    out = []
    for i in range(n):
        item = {}
        for k, v in batch.items():
            if isinstance(v, (np.ndarray, list)) and len(v) == n:
                item[k] = v[i]
            else:
                item[k] = v
        out.append(item)
    return out
