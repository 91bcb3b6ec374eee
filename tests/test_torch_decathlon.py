"""The port's ``DecathlonDataset`` and ``validate_msd_layout`` against the
JAX package's on synthesized MSD task directories (after
``tests/test_dataset_loader.py``): the same sections for several seeds and
validation fractions, the test section as bare image paths, the
properties, and the same errors."""

import json
import os

import pytest
from test_dataset_loader import make_decathlon_dir

from medseg.data import dataset as jdataset
from medseg_torch.data import dataset as tdataset


@pytest.fixture
def task(tmp_path):
    root = make_decathlon_dir(tmp_path, n=10)
    with open(os.path.join(root, "dataset.json")) as f:
        meta = json.load(f)
    meta["test"] = [e["image"] for e in meta["training"][:3]]
    meta["labels"] = {"0": "background", "1": "organ"}
    meta["modality"] = {"0": "CT"}
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump(meta, f)
    return os.path.dirname(root)


@pytest.mark.parametrize("seed,val_frac", [(0, 0.2), (1, 0.2), (12345, 0.3), (7, 0.0), (3, 0.5)])
def test_sections_match_jax(task, seed, val_frac):
    for section in ("training", "validation", "test"):
        got = tdataset.DecathlonDataset(task, "TinyTask", section=section, seed=seed,
                                        val_frac=val_frac)
        want = jdataset.DecathlonDataset(task, "TinyTask", section=section, seed=seed,
                                         val_frac=val_frac)
        assert got.data == want.data, section
        assert got.properties == want.properties
    assert got.properties["labels"] == {"0": "background", "1": "organ"}
    assert [set(d) for d in got.data] == [{"image"}] * 3  # the test list's bare paths
    tr = tdataset.DecathlonDataset(task, "TinyTask", seed=seed, val_frac=val_frac)
    va = tdataset.DecathlonDataset(task, "TinyTask", section="validation", seed=seed,
                                   val_frac=val_frac)
    assert len(va) == int(10 * val_frac) and len(tr) + len(va) == 10


def test_transform_applies_per_item(task):
    ds = tdataset.DecathlonDataset(task, "TinyTask", transform=lambda d: {**d, "seen": True})
    assert ds[0]["seen"] and ds[0]["image"].endswith(".nii.gz")


@pytest.mark.parametrize("download", [False, True])
def test_missing_task_errors_match_jax(tmp_path, download):
    messages = []
    for module in (tdataset, jdataset):
        with pytest.raises(FileNotFoundError) as err:
            module.DecathlonDataset(str(tmp_path), "MissingTask", download=download)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert ("not supported" in messages[0]) == download


@pytest.mark.parametrize("damage", ["labels_dir", "file", "count"])
def test_layout_errors_match_jax(task, damage):
    root = os.path.join(task, "TinyTask")
    with open(os.path.join(root, "dataset.json")) as f:
        meta = json.load(f)
    if damage == "labels_dir":
        for name in os.listdir(os.path.join(root, "labelsTr")):
            os.remove(os.path.join(root, "labelsTr", name))
        os.rmdir(os.path.join(root, "labelsTr"))
    elif damage == "file":
        os.remove(os.path.join(root, meta["training"][0]["image"]))
    else:
        meta["numTraining"] = 99
    datalist = tdataset.load_decathlon_datalist(os.path.join(root, "dataset.json"))
    messages = []
    for module in (tdataset, jdataset):
        with pytest.raises(RuntimeError, match="incomplete or corrupt") as err:
            module.validate_msd_layout(root, meta, datalist)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert {"labels_dir": "missing directory labelsTr/", "file": "datalist files missing",
            "count": "numTraining=99 but lists 10"}[damage] in messages[0]
