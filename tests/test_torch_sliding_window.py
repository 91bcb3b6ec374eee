"""The port's sliding-window inference, post-transforms, Dice and Validator
against the JAX package's.

Grid, importance and count map must equal JAX's exactly. The port's
``Validator.infer_volume`` (fused forward, kernels' plain versions on CPU)
must match the JAX ``Validator(use_fast_path=False)`` (flax forward) on
non-cubic volumes at the same weights; tolerance 2e-3, as the forward error
sums over overlapping windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.engine.evaluate import Validator as JaxValidator
from medseg.models.unetr import UNETR
from medseg.ops import metrics as jmetrics
from medseg.ops import post as jpost
from medseg.ops import sliding_window as jswi
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.engine.evaluate import Validator
from medseg_torch.models import unetr as tunetr
from medseg_torch.ops import metrics as tmetrics
from medseg_torch.ops import post as tpost
from medseg_torch.ops import sliding_window as tswi

K, ROI = 3, 32
SMALL = dict(out_channels=K, img_size=(ROI,) * 3, feature_size=8, hidden_size=24, mlp_dim=48,
             num_heads=4, num_layers=4, patch_size=16)


@pytest.fixture(scope="module")
def models():
    jmodel = UNETR(in_channels=1, **SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, ROI, ROI, ROI, 1)))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        x = rng.normal(size=s.shape)
        if path[-1].key == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif path[-1].key == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tmodel = tunetr.UNETR(in_channels=1, **SMALL)
    tmodel.load_state_dict(state_dict_from_flax(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("shape,roi,overlap", [
    ((512, 512, 160), (96, 96, 96), 0.5), ((40, 36, 44), (32, 32, 32), 0.25),
    ((13, 9, 17), (4, 4, 4), 0.5), ((20, 20, 20), (8, 8, 8), 0.8),
])
def test_grid_matches_jax_exactly(shape, roi, overlap):
    for a, b in zip(tswi.per_dim_window_starts(shape, roi, overlap),
                    jswi.per_dim_window_starts(shape, roi, overlap)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tswi.compute_window_starts(shape, roi, overlap), jswi.compute_window_starts(shape, roi, overlap)
    )
    assert tswi._pad_amounts(shape, roi, 1) == jswi._pad_amounts(shape, roi, 1)
    assert tswi._pad_amounts(shape, roi, 16) == jswi._pad_amounts(shape, roi, 16)


def test_config4_grid_is_10x10x3():
    per_dim = tswi.per_dim_window_starts((512, 512, 160), (96, 96, 96), 0.5)
    assert [len(s) for s in per_dim] == [10, 10, 3]


@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_importance_and_count_map_match_jax_exactly(mode):
    roi, padded = (8, 8, 8), (20, 13, 17)
    np.testing.assert_array_equal(tswi.gaussian_importance(roi, 0.125), jswi.gaussian_importance(roi, 0.125))
    np.testing.assert_array_equal(tswi.constant_importance(roi), jswi.constant_importance(roi))
    np.testing.assert_array_equal(
        tswi._count_map_cached(padded, roi, 0.5, mode, 0.125),
        jswi._count_map_cached(padded, roi, 0.5, mode, 0.125),
    )


def test_voxelwise_predictor_reproduces_direct_result():
    """Blend weights cancel under normalization: a voxel-wise predictor
    through the window walk equals the whole-volume result."""
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(13, 9, 17, 2)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(K, 2)).astype(np.float32))
    spec = tswi.SlidingWindowSpec(roi=(4, 4, 4), overlap=0.5, sw_batch=3, mode="gaussian")
    got = tswi.sliding_window_inference(
        vol, lambda win: torch.einsum("kc,bcdhw->bkdhw", w, win), K, spec, device="cpu"
    )
    want = np.einsum("dhwc,kc->dhwk", vol, w.numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,mode,overlap,sw_batch", [
    ((40, 36, 44), "gaussian", 0.5, 4),
    ((30, 36, 44), "constant", 0.25, 3),  # padded D, a zero-weight padding window
])
def test_validator_infer_volume_matches_jax(models, shape, mode, overlap, sw_batch):
    jmodel, params, tmodel = models
    spec_kw = dict(roi=(ROI,) * 3, overlap=overlap, sw_batch=sw_batch, mode=mode)
    image = np.random.default_rng(1).normal(size=shape + (1,)).astype(np.float32)
    ref = JaxValidator(jmodel, K, "ct", jswi.SlidingWindowSpec(**spec_kw), use_fast_path=False)
    want = np.asarray(ref.infer_volume(params, jnp.asarray(image)))
    got = Validator(tmodel, K, "ct", tswi.SlidingWindowSpec(**spec_kw), device="cpu").infer_volume(image)
    assert got.shape == shape + (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_validator_dice_matches_jax(models):
    jmodel, params, tmodel = models
    spec_kw = dict(roi=(ROI,) * 3, overlap=0.25, sw_batch=4, mode="constant")
    rng = np.random.default_rng(2)
    image = rng.normal(size=(36, 32, 40, 1)).astype(np.float32)
    label = rng.integers(0, K, size=(36, 32, 40, 1))
    logits = np.asarray(
        JaxValidator(jmodel, K, "ct", jswi.SlidingWindowSpec(**spec_kw), use_fast_path=False)
        .infer_volume(params, jnp.asarray(image))
    )
    # Dice of the JAX pipeline's own mask; the port's forward agrees to 2e-3,
    # so compare where the JAX argmax is decided by a margin above that
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-2
    validator = Validator(tmodel, K, "ct", tswi.SlidingWindowSpec(**spec_kw), device="cpu")
    mask_t = validator.predict_mask(image).numpy()
    mask_j = np.asarray(jpost.argmax_onehot(jnp.asarray(logits), K))
    np.testing.assert_array_equal(mask_t[decided], mask_j[decided])
    result = validator([{"image": image, "label": label}])
    want = jmetrics.dice_scores(jnp.asarray(mask_t[None]), jpost.to_onehot(jnp.asarray(label), K)[None])
    np.testing.assert_allclose(result.per_class_dice, np.asarray(want)[0], rtol=1e-6)
    assert result.mean_dice == pytest.approx(float(np.nanmean(np.asarray(want))), rel=1e-6)


def test_post_and_dice_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 5, 6, 7, 4)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 5, 6, 7, 1))
    labels[1] = 0  # classes absent from both masks -> NaN dice
    oh_t = tpost.to_onehot(torch.from_numpy(labels), 4)
    np.testing.assert_array_equal(oh_t.numpy(), np.asarray(jpost.to_onehot(jnp.asarray(labels), 4)))
    am_t = tpost.argmax_onehot(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(am_t.numpy(), np.asarray(jpost.argmax_onehot(jnp.asarray(logits), 4)))
    np.testing.assert_array_equal(
        tpost.sigmoid_threshold(torch.from_numpy(logits)).numpy(),
        np.asarray(jpost.sigmoid_threshold(jnp.asarray(logits))),
    )
    pred = am_t.clone()
    pred[1] = 0
    pred[1, ..., 0] = 1
    d_t = tmetrics.dice_scores(pred, oh_t).numpy()
    d_j = np.asarray(jmetrics.dice_scores(jnp.asarray(pred.numpy()), jnp.asarray(oh_t.numpy())))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)
    assert np.isnan(d_t).any()
    acc_t, acc_j = tmetrics.DiceAccumulator(), jmetrics.DiceAccumulator()
    acc_t(pred, oh_t)
    acc_j(jnp.asarray(pred.numpy()), jnp.asarray(oh_t.numpy()))
    for reduction in ("mean", "mean_batch"):
        np.testing.assert_allclose(acc_t.aggregate(reduction), acc_j.aggregate(reduction), rtol=1e-6)
