"""The port's walks and its full-size model against the repo's independent
oracles.

- Tier-1: the port's ``sliding_window_inference`` (the flat walk) and, on
  the cases whose grid it takes, the z-row walk on the four cases of
  ``tests/golden/swi_golden.npz`` (a torch loop written from the MONAI 0.6
  semantics, ``tests/golden/gen_swi_golden.py``), with the file's 2->3
  channel 3x3x3 conv predictor, to the tolerance of
  ``tests/test_swi_golden_torch.py`` (2e-4).
- ``slow``: UNETR-B/16 at 96^3 (14 classes), the port's module against the
  flax ``UNETR.apply`` through the weight bridge, fp32 (seeded weights as in
  ``tests/test_torch_models.py``); and the port's flat walk with that module
  against ``torch_swi`` of ``tests/test_full_size_parity.py`` on a 160^3
  volume at overlap 0.25. Both with that test's bounds: largest difference
  below 2e-3 of the largest logit, argmax agreement at least 0.999. Both run
  torch on one intra-op thread.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from medseg_torch.ops.sliding_window import SlidingWindowSpec, sliding_window_inference, \
    zrow_supported
from medseg_torch.ops.swi_zrow import sliding_window_inference_zrow

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "swi_golden.npz")
CASES = ("a", "b", "c", "d")
GOLDEN_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_swi_golden_torch.py
FULL = dict(in_channels=1, out_channels=14, img_size=(96, 96, 96), feature_size=16,
            hidden_size=768, mlp_dim=3072, num_heads=12, num_layers=12, patch_size=16)
VOL, OVERLAP = (160, 160, 160), 0.25  # tests/test_full_size_parity.py


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as the port's CLI tests run: under a
    parallel test run several workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _spec(golden, case) -> SlidingWindowSpec:
    meta = golden[f"{case}_meta"]
    return SlidingWindowSpec(roi=tuple(int(v) for v in meta[:3]), overlap=float(meta[3]),
                             sw_batch=3, mode="gaussian" if int(meta[4]) else "constant")


def _conv(golden):
    weight, bias = torch.from_numpy(golden["weight"]), torch.from_numpy(golden["bias"])
    return lambda windows: F.conv3d(windows, weight, bias, padding=1)


@pytest.mark.parametrize("case", CASES)
def test_flat_walk_matches_swi_golden(golden, case):
    got = sliding_window_inference(golden[f"{case}_vol"], _conv(golden), 3, _spec(golden, case),
                                   device="cpu")
    np.testing.assert_allclose(got.numpy(), golden[f"{case}_out"], **GOLDEN_TOL)


def _zrow_cases():
    g = np.load(GOLDEN)
    return [c for c in CASES if zrow_supported(g[f"{c}_vol"].shape[:3], _spec(g, c))]


@pytest.mark.parametrize("case", _zrow_cases())
def test_zrow_walk_matches_swi_golden(golden, case):
    conv = _conv(golden)

    def add_weighted(windows, wgt, starts, acc):
        out = conv(windows) * wgt
        rd, rh, rw = windows.shape[2:]
        for (d, h, w), o in zip(starts.tolist(), out):
            acc[: o.shape[0], d : d + rd, h : h + rh, w : w + rw] += o

    got = sliding_window_inference_zrow(golden[f"{case}_vol"], add_weighted, 3,
                                        _spec(golden, case), device="cpu", acc_dtype="fp32")
    np.testing.assert_allclose(got.numpy(), golden[f"{case}_out"], **GOLDEN_TOL)


def test_golden_cases_cover_both_walks():
    """The z-row walk takes cases a and b; c (overlap 0.8: an odd interval)
    and d (an odd pad of its 10-voxel dim) are the flat walk's alone."""
    assert _zrow_cases() == ["a", "b"]


@pytest.fixture(scope="module")
def full_size_pair():
    import jax
    import jax.numpy as jnp
    from test_torch_models import _fill

    from medseg.models.unetr import UNETR as JaxUNETR
    from medseg_torch.engine.checkpoint import state_dict_from_flax
    from medseg_torch.models.unetr import UNETR

    jmodel = JaxUNETR(**FULL)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 96, 96, 96, 1)))
    params = _fill(shapes, np.random.default_rng(0))
    tmodel = UNETR(**FULL).eval()
    tmodel.load_state_dict(state_dict_from_flax(params))
    return jmodel, params, tmodel


def _report(label, got, ref):
    diff = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    rel_l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    agree = (got.argmax(1) == ref.argmax(1)).mean()
    print(f"{label}: max |diff| {diff:.3e} of {scale:.3f} ({diff / scale:.3e}), rel L2 "
          f"{rel_l2:.3e}, argmax agreement {agree:.7f}")
    return diff, scale, agree


@pytest.mark.slow
def test_unetr_b16_forward_at_96_matches_flax(full_size_pair):
    import jax.numpy as jnp

    jmodel, params, tmodel = full_size_pair
    x = np.random.default_rng(1).normal(size=(1, 96, 96, 96, 1)).astype(np.float32)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), return_encoder_features=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()),
                     return_encoder_features=False)
    diff, scale, agree = _report("UNETR-B/16 96^3 forward vs UNETR.apply", got.numpy(),
                                 ref.transpose(0, 4, 1, 2, 3))
    assert diff < 2e-3 * scale
    assert agree >= 0.999


@pytest.mark.slow
def test_walk_at_160_matches_torch_swi(full_size_pair):
    from test_full_size_parity import torch_swi

    _, _, tmodel = full_size_pair
    vol = np.random.default_rng(2).normal(size=(1, 1) + VOL).astype(np.float32) * 0.3 + 0.2
    def logits(windows):
        return tmodel(windows, return_encoder_features=False)

    ref = torch_swi(logits, torch.from_numpy(vol), 96, OVERLAP)  # (1, 14, D, H, W)
    spec = SlidingWindowSpec(roi=(96,) * 3, overlap=OVERLAP, sw_batch=4)
    with torch.no_grad():
        got = sliding_window_inference(vol[0, 0][..., None], logits, 14, spec, device="cpu")
    got = got.numpy().transpose(3, 0, 1, 2)[None]
    diff, scale, agree = _report("flat walk 160^3 overlap 0.25 vs torch_swi", got, ref)
    assert diff < 2e-3 * scale
    assert agree >= 0.999
