"""The port's host data path against the JAX package's, exactly: the random
crops and augmentations (``data/sampling.py``), the training and
pretraining chains (``data/pipelines.py``), the folds and datasets
(``data/dataset.py``), ``collate`` and the ``DataLoader``'s batch order
(``data/loader.py``), and the CLI helpers of ``cli/common.py``. Every random
draw comes from an ``np.random.Generator`` seeded alike on both sides, so
equal seeds give equal arrays.
"""

import numpy as np
import pytest
import torch
from test_cli import make_dataset

from medseg.cli import common as jcommon
from medseg.config import preset as jpreset
from medseg.data import dataset as jds
from medseg.data import loader as jloader
from medseg.data import pipelines as jpipe
from medseg.data import sampling as js
from medseg_torch.cli import common as tcommon
from medseg_torch.config import preset as tpreset
from medseg_torch.data import dataset as tds
from medseg_torch.data import loader as tloader
from medseg_torch.data import pipelines as tpipe
from medseg_torch.data import sampling as ts


def _sample(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    img = rng.normal(0.5, 0.2, size=(20, 18, 16, 1)).astype(np.float32)
    lab = np.zeros((20, 18, 16, 1), np.float32)
    lab[4:10, 4:10, 4:10] = 1.0
    return {"image": img, "label": lab}


def _assert_same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


SAMPLERS = {
    "pos_neg": lambda m, rng: m.rand_crop_by_pos_neg_label(
        _sample(), spatial_size=(8, 8, 8), num_samples=4, rng=rng),
    "pos_neg_pad": lambda m, rng: m.rand_crop_by_pos_neg_label(
        _sample(), spatial_size=(24, 8, 20), num_samples=3, pos=2.0, neg=1.0, rng=rng),
    "spatial": lambda m, rng: m.rand_spatial_crop_samples(
        _sample(), roi_size=(8, 10, 12), num_samples=2, rng=rng),
    "flip": lambda m, rng: [m.rand_flip(_sample(), axis=a, prob=0.5, rng=rng) for a in (0, 1, 2)],
    "rot90": lambda m, rng: [m.rand_rotate90(_sample(), prob=0.7, rng=rng) for _ in range(4)],
    "scale": lambda m, rng: [m.rand_scale_intensity(_sample(), prob=0.7, rng=rng) for _ in range(4)],
    "shift": lambda m, rng: [m.rand_shift_intensity(_sample(), prob=0.7, rng=rng) for _ in range(4)],
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_samplers_match_jax(name):
    for seed in range(3):
        _assert_same(SAMPLERS[name](ts, np.random.default_rng(seed)),
                     SAMPLERS[name](js, np.random.default_rng(seed)))


@pytest.fixture(scope="module")
def datalist(tmp_path_factory):
    data_dir = make_dataset(tmp_path_factory.mktemp("data"), n=4)
    return data_dir, tcommon.resolve_datalist(data_dir, "TinyCT")


@pytest.mark.parametrize("chain", ["pretrain", "train"])
def test_chains_match_jax(datalist, chain):
    _, entries = datalist
    outs = []
    for pipe, preset in ((tpipe, tpreset), (jpipe, jpreset)):
        cfg = preset("TinyCT", 2).data
        cfg = type(cfg)(**{**cfg.__dict__, "crop_size": 16, "flip_prob": 0.5, "rot90_prob": 0.5})
        rng = np.random.default_rng(4)
        fn = (pipe.pretrain_transforms(cfg, rng, num_samples=2) if chain == "pretrain"
              else pipe.train_transforms(cfg, rng))
        outs.append([fn(dict(e)) for e in entries[:2]])
    got, want = outs
    assert len(got[0]) == (2 if chain == "pretrain" else 4)
    assert got[0][0]["image"].shape == (16, 16, 16, 1)
    _assert_same(got, want)


def test_folds_and_datalists_match_jax(datalist):
    data_dir, entries = datalist
    assert entries == jcommon.resolve_datalist(data_dir, "TinyCT")
    with pytest.raises(FileNotFoundError, match="dataset.json"):
        tcommon.resolve_datalist(data_dir, "Missing")
    items = [{"image": f"i{i}"} for i in range(11)]
    for name in ("TinyCT", "Task09_Spleen"):
        for k in (2, 5):
            assert tcommon.fold_datalists(items, name, k, 12345) == \
                jcommon.fold_datalists(items, name, k, 12345)
    assert tcommon.subsample_train(items, 3.7) == jcommon.subsample_train(items, 3.7)
    for n, k in ((10, 5), (11, 3), (4, 2)):
        for (a, b), (c, d) in zip(tds.kfold_split(n, k), jds.kfold_split(n, k)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        for a, b in zip(tds.partition_dataset_indices(n, k, seed=3),
                        jds.partition_dataset_indices(n, k, seed=3)):
            np.testing.assert_array_equal(a, b)
    cv_t, cv_j = tds.CrossValidationFolds(items, 5), jds.CrossValidationFolds(items, 5)
    assert cv_t.get_datalist([0, 2]) == cv_j.get_datalist([0, 2]) and \
        cv_t.get_datalist(4) == cv_j.get_datalist(4)


def test_cache_dataset_and_decollate_match_jax():
    items = [{"image": np.full((2, 2, 2, 1), float(i), np.float32)} for i in range(5)]
    prefix = lambda s: {**s, "image": s["image"] * 2}  # noqa: E731
    suffix = lambda s: {**s, "image": s["image"] + 1}  # noqa: E731
    t = tds.CacheDataset(items, transform=suffix, cache_rate=0.6, cache_transform=prefix)
    j = jds.CacheDataset(items, transform=suffix, cache_rate=0.6, cache_transform=prefix)
    assert len(t._cache) == len(j._cache) == 3
    _assert_same([t[i] for i in range(5)], [j[i] for i in range(5)])
    _assert_same([tds.ListDataset(items)[1]], [jds.ListDataset(items)[1]])
    batch = {"image": np.arange(24.0).reshape(3, 8), "path": ["a", "b", "c"], "k": 1}
    _assert_same(tds.decollate_batch(batch), jds.decollate_batch(batch))


def test_collate_matches_jax():
    rng = np.random.default_rng(5)
    items = [[{"image": rng.normal(size=(4, 4, 4, 1)).astype(np.float32), "path": f"p{i}"}
              for _ in range(2)] for i in range(2)]
    items.append({"image": rng.normal(size=(4, 4, 4, 1)).astype(np.float32), "path": "q"})
    got, want = tloader.collate(items), jloader.collate(items)
    assert got["image"].shape == (5, 4, 4, 4, 1)
    _assert_same(got, want)
    assert tloader.collate([]) == jloader.collate([]) == {}


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batch_order_matches_jax(drop_last):
    data = [{"image": np.full((2, 2, 2, 1), float(i), np.float32)} for i in range(11)]
    orders = []
    for mod, ds in ((tloader, tds), (jloader, jds)):
        loader = mod.DataLoader(ds.ListDataset(data), batch_size=3, shuffle=True, seed=7,
                                num_workers=2, drop_last=drop_last)
        assert len(loader) == (3 if drop_last else 4)
        orders.append([[b["image"][:, 0, 0, 0, 0].tolist() for b in loader] for _ in range(2)])
    assert orders[0] == orders[1]
    assert orders[0][0] != orders[0][1]  # the next epoch is shuffled anew


def test_loader_propagates_worker_errors():
    class Boom:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(tloader.DataLoader(Boom(), batch_size=1))


def test_device_put_batch_makes_ncdhw_tensors():
    batch = {"image": np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5, 1),
             "crop_start": np.zeros((2, 3), np.int64), "image_path": ["a", "b"]}
    out = tcommon.device_put_batch(batch, "cpu")
    assert out["image"].shape == (2, 1, 3, 4, 5) and out["image"].is_contiguous()
    torch.testing.assert_close(out["image"][:, 0], torch.from_numpy(batch["image"][..., 0]))
    assert out["crop_start"].dtype == torch.int64 and out["image_path"] == ["a", "b"]
