"""K4's plain version, the z-row walk and the Validator's routing against the
JAX package.

- ``outhead_row_of_plain`` vs the JAX ``outhead_row_of`` (interpret mode) at
  the shape of ``tests/test_conv_of.py``'s W-fold test (3 classes, so zpack
  16, at 32^3, two rows of two windows): the JAX kernel rounds the weighted
  combine to bf16 before its dot and sums its windows in a bf16 row, so the
  bound is 1e-2 of the largest value (a few bf16 half-ulps); and vs K3's
  plain version plus a slice-add at 1e-5 (both fp32, only the order of the
  per-window sums differs).
- The z-row walk through the fused forward's plain versions vs the JAX
  ``sliding_window_inference`` (flax forward, fp32 accumulator), never the
  JAX z-row route (its in-kernel fold sums in bf16, F-ref1): 2e-3 at fp32
  on a regular grid, a grid with a clipped last start and a bucketed grid,
  as the port's forward agrees with flax to 2e-3; with a bf16 accumulator
  within 2e-2 of the largest value (at most 8 bf16 roundings of same-sign
  terms).
- ``_pick_h_group`` and ``zrow_supported`` equal the JAX functions exactly.
- The Validator sends an even grid through the z-row walk and the
  accumulating exit, an odd grid through the flat walk; both match the JAX
  Validator at fp32.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.engine.evaluate import Validator as JaxValidator
from medseg.kernels import conv_of as jconv
from medseg.models.unetr import UNETR
from medseg.ops import sliding_window as jswi
from medseg.ops import swi_zrow as jzrow
from medseg_torch.engine import evaluate as tevaluate
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.kernels import conv_of as tconv
from medseg_torch.kernels import unetr_of as tuo
from medseg_torch.models import unetr as tunetr
from medseg_torch.ops import sliding_window as tswi
from medseg_torch.ops import swi_zrow as tzrow

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
    return jmodel, params, tmodel.eval()


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))


def _head_inputs(rng, b, s, c=8, k=8, n_classes=3):
    z = rng.normal(size=(b, s, s, s, c)).astype(np.float32)
    r = rng.normal(size=(b, s, s, s, c)).astype(np.float32)
    az, ar = rng.uniform(0.5, 1.5, size=(2, b, c)).astype(np.float32)
    bz, br = (0.5 * rng.normal(size=(2, b, c))).astype(np.float32)
    kout = (rng.normal(size=(k, c)) / np.sqrt(c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(k,))).astype(np.float32)
    kout[n_classes:], bias[n_classes:] = 0.0, 0.0
    scale = rng.uniform(0.2, 1.0, size=(b, s, s, s, 1)).astype(np.float32)
    return z, r, (az, bz, ar, br), kout, bias, scale


def test_outhead_row_plain_matches_jax_kernel():
    rng = np.random.default_rng(0)
    n_w, g, s, zp, k = 2, 2, 32, 16, 8
    w_starts2, wp_half = (0, 8), 24  # windows at w = 0 and 16 of a 48-wide row
    z, r, aff, kout, bias, scale = _head_inputs(rng, n_w * g, s)
    row = jconv.outhead_row_of(
        jconv.to_pp(jnp.asarray(z), jnp.float32), jconv.to_pp(jnp.asarray(r), jnp.float32),
        *(jnp.asarray(a)[..., None] for a in aff), jnp.asarray(kout), jnp.asarray(bias)[:, None],
        jconv.to_pp(jnp.asarray(scale), jnp.float32), n_w=n_w, w_starts2=w_starts2,
        wp_half=wp_half, rh2=s // 2, rw2=s // 2, zpack=zp, interpret=True,
    )
    # (g, D/zp, 4, H/2, Wp/2*zp*K) -> (g, D, H, Wp, K), as tests/test_conv_of.py unpacks it
    want = np.asarray(row, np.float32).reshape(g, s // zp, 2, 2, s // 2, wp_half, zp, k)
    want = want.transpose(0, 1, 6, 4, 2, 5, 3, 7).reshape(g, s, s, 2 * wp_half, k)
    # the port: row gg at h-offset gg*s of one accumulator; batch index wi*g + gg
    acc = torch.zeros((k, s, g * s, 2 * wp_half))
    starts = [(0, gg * s, 2 * w_starts2[wi]) for wi in range(n_w) for gg in range(g)]
    tconv.outhead_row_of(_ncdhw(z), _ncdhw(r), *map(torch.from_numpy, aff),
                         torch.from_numpy(kout), torch.from_numpy(bias), _ncdhw(scale), starts, acc)
    got = acc.numpy().reshape(k, s, g, s, 2 * wp_half).transpose(2, 1, 3, 4, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_outhead_row_plain_equals_outhead_and_slice_add(acc_dtype):
    """K4 == K3's logits added into the accumulator window by window, and
    voxels no window covers keep their value."""
    rng = np.random.default_rng(1)
    z, r, aff, kout, bias, scale = _head_inputs(rng, 3, 8)
    args = (_ncdhw(z), _ncdhw(r), *map(torch.from_numpy, aff), torch.from_numpy(kout),
            torch.from_numpy(bias), _ncdhw(scale))
    starts = [(2, 0, 0), (2, 4, 0), (6, 4, 6)]
    init = torch.from_numpy(rng.normal(size=(8, 16, 14, 16)).astype(np.float32)).to(acc_dtype)
    got = init.clone()
    tconv.outhead_row_of(*args, torch.tensor(starts, dtype=torch.int32), got)
    logits = tconv.outhead_of_plain(*args)
    want = torch.zeros(init.shape)
    for (d, h, w), o in zip(starts, logits):
        want[:, d : d + 8, h : h + 8, w : w + 8] += o
    covered = want != 0
    want = (init.float() + want).to(acc_dtype)
    tol = 1e-5 if acc_dtype == torch.float32 else 8e-3  # bf16: one rounding of the sum
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got[~covered], init[~covered])


def test_outhead_row_checks_its_starts():
    rng = np.random.default_rng(2)
    z, r, aff, kout, bias, scale = _head_inputs(rng, 2, 8)
    args = (_ncdhw(z), _ncdhw(r), *map(torch.from_numpy, aff), torch.from_numpy(kout),
            torch.from_numpy(bias), _ncdhw(scale))
    acc = torch.zeros((8, 10, 10, 10))
    with pytest.raises(ValueError, match="leaves the accumulator"):
        tconv.outhead_row_of(*args, [(0, 0, 0), (3, 0, 0)], acc)
    with pytest.raises(ValueError, match="starts must be"):
        tconv.outhead_row_of(*args, [(0, 0, 0)], acc)


def test_pick_h_group_matches_jax_exactly():
    for nh, n_w, tb in itertools.product(range(1, 13), range(1, 10), (1, 4, 6, 8, 16)):
        assert tzrow._pick_h_group(nh, n_w, tb) == jzrow._pick_h_group(nh, n_w, tb), (nh, n_w, tb)


def test_zrow_supported_matches_jax_exactly():
    shapes = [(512, 512, 160), (40, 36, 44), (30, 36, 44), (240, 240, 155), (36, 36, 36),
              (64, 48, 64), (33, 64, 64), (128, 128, 97), (300, 300, 240)]
    for shape, roi, overlap, bucket in itertools.product(
        shapes, [(32, 32, 32), (96, 96, 96), (31, 32, 32)], [0.25, 0.5], [1, 32]
    ):
        kw = dict(roi=roi, overlap=overlap, bucket_multiple=bucket)
        want = jswi.ppk_supported(shape, jswi.SlidingWindowSpec(**kw))
        assert tswi.ppk_supported(shape, tswi.SlidingWindowSpec(**kw)) == want, (shape, kw)
        assert tswi.zrow_supported(shape, tswi.SlidingWindowSpec(**kw)) == want
        assert jzrow.zrow_supported(shape, jswi.SlidingWindowSpec(**kw)) == want


def test_zrow_walk_order_is_exact_and_jax_shaped():
    """Batches of h_group * n_w windows in the JAX walk order (w-major
    within a batch), every grid window once, and a voxel-wise predictor
    reproduces the direct result (the blend weights cancel)."""
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(14, 10, 18, 2)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(K, 2)).astype(np.float32))
    spec = tswi.SlidingWindowSpec(roi=(4, 4, 4), overlap=0.5, mode="gaussian")
    seen = []

    def apply_fn(windows, wgt, starts, acc):
        seen.append(starts.tolist())
        logits = torch.einsum("kc,bcdhw->bkdhw", w, windows) * wgt
        tconv.overlap_add_plain(torch.nn.functional.pad(logits, (0,) * 6 + (0, 8 - K)),
                                starts.tolist(), acc)

    got = tzrow.sliding_window_inference_zrow(vol, apply_fn, K, spec, device="cpu",
                                              acc_dtype="fp32")
    np.testing.assert_allclose(got.numpy(), np.einsum("dhwc,kc->dhwk", vol, w.numpy()),
                               rtol=1e-5, atol=1e-5)
    d_s, h_s, w_s = tswi.per_dim_window_starts((14, 10, 18), (4, 4, 4), 0.5)
    g = tzrow._pick_h_group(len(h_s), len(w_s), tzrow.TARGET_BATCH)
    assert [len(b) for b in seen] == [g * len(w_s)] * (len(d_s) * len(h_s) // g)
    assert seen[0] == [[0, int(h), int(ws)] for ws in w_s for h in h_s[:g]]
    flat = sorted(tuple(s) for b in seen for s in b)
    assert flat == sorted(map(tuple, tswi.compute_window_starts((14, 10, 18), (4, 4, 4), 0.5)))


def _accumulating_apply(tmodel):
    weights = tuo.fused_weights(tmodel)

    def apply_fn(windows, wgt, starts, acc):
        tuo.fast_apply_v3(tmodel, windows, weights, out_scale=wgt, starts=starts, acc=acc)

    return apply_fn


def _jax_reference(jmodel, params, image, spec_kw):
    return np.asarray(jswi.sliding_window_inference(
        params, jnp.asarray(image),
        lambda p, w: jmodel.apply(p, w, return_encoder_features=False),
        K, jswi.SlidingWindowSpec(**spec_kw), acc_dtype="fp32",
    ))


@pytest.mark.parametrize("shape,overlap,mode,bucket", [
    ((64, 48, 64), 0.5, "gaussian", 1),  # regular grid
    ((40, 36, 44), 0.5, "gaussian", 1),  # clipped last starts (8, 4, 12)
    ((36, 60, 40), 0.25, "constant", 32),  # bucketed to 64^3, padded in every dim
])
def test_zrow_walk_matches_jax_fp32(models, shape, overlap, mode, bucket):
    jmodel, params, tmodel = models
    spec_kw = dict(roi=(ROI,) * 3, overlap=overlap, mode=mode, bucket_multiple=bucket)
    assert tswi.zrow_supported(shape, tswi.SlidingWindowSpec(**spec_kw))
    image = np.random.default_rng(4).normal(size=shape + (1,)).astype(np.float32)
    want = _jax_reference(jmodel, params, image, spec_kw)
    with torch.no_grad():
        got = tzrow.sliding_window_inference_zrow(
            image, _accumulating_apply(tmodel), K, tswi.SlidingWindowSpec(**spec_kw),
            device="cpu", acc_dtype="fp32",
        )
    assert got.shape == shape + (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    if bucket == 1:  # the bf16 accumulator, within its stated bound
        with torch.no_grad():
            got16 = tzrow.sliding_window_inference_zrow(
                image, _accumulating_apply(tmodel), K, tswi.SlidingWindowSpec(**spec_kw),
                device="cpu", acc_dtype="bf16",
            )
        assert np.abs(got16.numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("shape,route", [((40, 36, 44), "zrow"), ((30, 36, 44), "flat")])
def test_validator_routes_like_jax(models, monkeypatch, shape, route):
    jmodel, params, tmodel = models
    spec_kw = dict(roi=(ROI,) * 3, overlap=0.5, sw_batch=4, mode="gaussian")
    calls = {"zrow": 0, "flat": 0, "k4": 0, "k3": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tevaluate, "sliding_window_inference_zrow",
                        count("zrow", tevaluate.sliding_window_inference_zrow))
    monkeypatch.setattr(tevaluate, "sliding_window_inference",
                        count("flat", tevaluate.sliding_window_inference))
    monkeypatch.setattr(tuo, "outhead_row_of", count("k4", tuo.outhead_row_of))
    monkeypatch.setattr(tuo, "outhead_of", count("k3", tuo.outhead_of))
    image = np.random.default_rng(5).normal(size=shape + (1,)).astype(np.float32)
    got = tevaluate.Validator(tmodel, K, "ct", tswi.SlidingWindowSpec(**spec_kw),
                              device="cpu").infer_volume(image)
    want = JaxValidator(jmodel, K, "ct", jswi.SlidingWindowSpec(**spec_kw),
                        use_fast_path=False).infer_volume(params, jnp.asarray(image))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
    if route == "zrow":
        assert calls["zrow"] == 1 and calls["flat"] == 0 and calls["k3"] == 0
        assert calls["k4"] == 2  # 2 x 2 x 2 grid: 2 d-starts x one batch of 2 rows x 2 windows
    else:
        assert calls["zrow"] == 0 and calls["flat"] == 1 and calls["k4"] == 0
        assert calls["k3"] > 0
