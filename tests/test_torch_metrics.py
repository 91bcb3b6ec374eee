"""The port's validation metrics (``medseg_torch.ops.metrics``) against the
JAX package's (``medseg.ops.metrics``) on the same seeded numpy masks, and
the port's ``Validator(all_metrics=True)`` against the JAX accumulators fed
the port's own masks.

Counts and edges must be equal exactly. Hausdorff (the port's exact
squared distance transform on the device against scipy's on the host) must
match to 1e-5, at ``percentile=None`` and at 95, on random masks, masks
touching the array border, single voxels, the known distances of
``tests/test_metrics.py`` and with either mask empty (NaN on both sides);
the min-plus passes are also run in chunks of a few lines. Precision and
recall aggregates match to 1e-6 relative (the JAX package divides float32
counts, the port int64 counts).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.engine.evaluate import ValidationResult as JaxValidationResult
from medseg.ops import metrics as jm
from medseg.ops import post as jpost
from medseg_torch.engine.evaluate import ValidationResult, Validator
from medseg_torch.models import unetr as tunetr
from medseg_torch.ops import metrics as tm
from medseg_torch.ops import sliding_window as tswi

HD_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: these tensors are small, and under a
    parallel test run an 8-thread pool per worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _onehot(labels, k):
    return np.eye(k, dtype=np.float32)[labels]


def _random_masks(seed, shape=(2, 9, 7, 8), k=4):
    rng = np.random.default_rng(seed)
    pred = _onehot(rng.integers(0, k, size=shape), k)
    label = _onehot(rng.integers(0, k - 1, size=shape), k)  # class k-1 absent from the label
    pred[1, ..., 2] = 0  # class 2 absent from one prediction
    return pred, label


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_counts_are_exact(seed):
    pred, label = _random_masks(seed)
    got = tm.confusion_counts(torch.from_numpy(pred), torch.from_numpy(label))
    want = np.asarray(jm.confusion_counts(jnp.asarray(pred), jnp.asarray(label)))
    assert got.shape == want.shape == (2, 4, 4) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got.sum(-1) == 9 * 7 * 8).all()


@pytest.mark.parametrize("metric", ["precision", "sensitivity"])
def test_confusion_accumulator_matches_jax(metric):
    acc_t, acc_j = tm.ConfusionAccumulator(metric), jm.ConfusionAccumulator(metric)
    for seed in (3, 4):
        pred, label = _random_masks(seed)
        acc_t(torch.from_numpy(pred), torch.from_numpy(label))
        acc_j(jnp.asarray(pred), jnp.asarray(label))
    for reduction in ("mean", "mean_batch"):
        got, want = acc_t.aggregate(reduction), acc_j.aggregate(reduction)
        assert np.asarray(got).dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # precision of the class the label lacks is 0 where predicted; the recall
    # of that class is 0/0: NaN in every sample
    per_class = acc_t.aggregate("mean_batch")
    assert np.isnan(per_class[3]) == (metric == "sensitivity")
    with pytest.raises(ValueError, match="unsupported"):
        tm.ConfusionAccumulator("dice")
    acc_t.reset()
    with pytest.raises(RuntimeError, match="before any accumulation"):
        acc_t.aggregate()


def _border_masks(rng):
    a = rng.random((7, 8, 9)) < 0.4
    b = np.zeros((7, 8, 9), bool)
    b[0, :, :] = True  # a whole face on the border
    b[:, -1, 3:6] = True
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_edges_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _border_masks(rng)
    for mask in (a, b, np.ones((4, 5, 6), bool), np.zeros((3, 3, 3), bool),
                 np.ones((1, 4, 4), bool)):
        np.testing.assert_array_equal(tm._mask_edges(torch.from_numpy(mask)).numpy(),
                                      jm._mask_edges(mask))


def _hd_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for i in range(3):
        shape = tuple(int(v) for v in rng.integers(5, 14, size=3))
        cases[f"random{i}"] = (rng.random(shape) < 0.2, rng.random(shape) < 0.05)
    cases["border"] = _border_masks(rng)
    single_a, single_b = np.zeros((9, 10, 11), bool), np.zeros((9, 10, 11), bool)
    single_a[0, 0, 0] = True
    single_b[8, 9, 10] = True
    cases["single_voxels"] = (single_a, single_b)
    block = np.zeros((9, 10, 11), bool)
    block[3:6, 4:7, 5:8] = True
    cases["single_voxel_vs_block"] = (single_a, block)
    a = np.zeros((10, 10, 10), bool)
    a[2:4, 2:4, 2:4] = True
    c = np.zeros((10, 10, 10), bool)
    c[2:4, 2:4, 5:7] = True  # the same block shifted by 3 in z: HD 3
    cases["known_same"] = (a, a.copy())
    cases["known_shift3"] = (a, c)
    cases["empty_pred"] = (np.zeros((5, 5, 5), bool), np.ones((5, 5, 5), bool))
    cases["empty_target"] = (rng.random((5, 6, 7)) < 0.3, np.zeros((5, 6, 7), bool))
    return cases


HD_CASES = _hd_cases()


@pytest.mark.parametrize("percentile", [None, 95])
@pytest.mark.parametrize("name", sorted(HD_CASES))
def test_hausdorff_matches_jax(name, percentile):
    pred, target = HD_CASES[name]
    want = jm.hausdorff_distance(pred, target, percentile)
    got = tm.hausdorff_distance(torch.from_numpy(pred), torch.from_numpy(target), percentile)
    assert isinstance(got, float)
    if name.startswith("empty"):
        assert np.isnan(got) and np.isnan(want)
        return
    assert got == pytest.approx(want, abs=HD_TOL)
    if name == "known_shift3":
        assert got == pytest.approx(3.0, abs=HD_TOL)
    if name == "known_same":
        assert got == 0.0


def test_hausdorff_in_chunks_of_a_few_lines(monkeypatch):
    """The min-plus passes split their lines into chunks; a chunk of a few
    lines gives the same distances."""
    rng = np.random.default_rng(11)
    pred, target = rng.random((12, 11, 10)) < 0.1, rng.random((12, 11, 10)) < 0.02
    want = {p: jm.hausdorff_distance(pred, target, p) for p in (None, 50, 95)}
    monkeypatch.setattr(tm, "_CHUNK_ELEMENTS", 3 * 12 * 12)
    for p, w in want.items():
        assert tm.hausdorff_distance(pred, target, p) == pytest.approx(w, abs=HD_TOL)


def test_squared_edt_is_exact():
    """The squared distance transform against brute force over every pair."""
    rng = np.random.default_rng(12)
    feature = rng.random((6, 7, 5)) < 0.05
    feature[0, 0, 0] = True
    got = tm._squared_edt(torch.from_numpy(feature)).numpy()
    grid = np.stack(np.meshgrid(*map(np.arange, feature.shape), indexing="ij"), -1).reshape(-1, 3)
    pts = np.argwhere(feature)
    want = ((grid[:, None, :] - pts[None]) ** 2).sum(-1).min(1).reshape(feature.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("percentile", [None, 95])
def test_hausdorff_accumulator_matches_jax(percentile):
    acc_t, acc_j = tm.HausdorffAccumulator(percentile), jm.HausdorffAccumulator(percentile)
    for seed in (5, 6):
        pred, label = _random_masks(seed, shape=(2, 10, 9, 8))
        acc_t(torch.from_numpy(pred), torch.from_numpy(label))
        acc_j(pred, label)
    for reduction in ("mean", "mean_batch"):
        np.testing.assert_allclose(acc_t.aggregate(reduction), acc_j.aggregate(reduction),
                                   rtol=0, atol=HD_TOL)
    assert np.isnan(acc_t.aggregate("mean_batch")[3])  # the label never has class 3


def test_validation_result_fields_match_jax():
    """Same field names, order and defaults, so ``dataclasses.asdict`` of the
    two packages' results compare."""
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(ValidationResult) == fields(JaxValidationResult)


@pytest.mark.parametrize("label_on", ["host", "device"])
def test_validator_all_metrics_match_jax_accumulators(label_on):
    """``Validator(..., all_metrics=True)`` on a small model: its Dice,
    precision, recall and Hausdorff are the JAX accumulators' on the
    Validator's own masks; the label may come as a numpy array or as a
    tensor."""
    k, roi = 3, 32
    torch.manual_seed(0)
    model = tunetr.init_weights(
        tunetr.UNETR(in_channels=1, out_channels=k, img_size=(roi,) * 3, feature_size=4,
                     hidden_size=24, mlp_dim=48, num_heads=4, num_layers=2),
        torch.Generator().manual_seed(3),
    )
    spec = tswi.SlidingWindowSpec(roi=(roi,) * 3, overlap=0.25, sw_batch=2, mode="constant")
    validator = Validator(model, k, "ct", spec, device="cpu")
    rng = np.random.default_rng(9)
    volumes = []
    for shape in ((36, 32, 34), (33, 35, 32)):
        image = rng.normal(size=shape + (1,)).astype(np.float32)
        label = rng.integers(0, k, size=shape + (1,)).astype(np.float32)
        volumes.append({"image": image,
                        "label": label if label_on == "host" else torch.from_numpy(label)})
    result = validator(volumes, all_metrics=True)
    accs = {"dice": jm.DiceAccumulator(), "precision": jm.ConfusionAccumulator("precision"),
            "recall": jm.ConfusionAccumulator("sensitivity"), "hausdorff": jm.HausdorffAccumulator()}
    for vol in volumes:
        pred = jnp.asarray(validator.predict_mask(vol["image"]).numpy()[None])
        lab = jpost.to_onehot(jnp.asarray(np.asarray(vol["label"])), k)[None]
        for name, acc in accs.items():
            acc(np.asarray(pred) if name == "hausdorff" else pred,
                np.asarray(lab) if name == "hausdorff" else lab)
    for name, acc in accs.items():
        np.testing.assert_allclose(getattr(result, f"mean_{name}"), acc.aggregate("mean"),
                                   rtol=1e-6, atol=HD_TOL)
        np.testing.assert_allclose(getattr(result, f"per_class_{name}"),
                                   acc.aggregate("mean_batch"), rtol=1e-6, atol=HD_TOL)
    dice_only = validator(volumes)
    assert dice_only.mean_dice == result.mean_dice and dice_only.mean_hausdorff is None
