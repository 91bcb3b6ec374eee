"""The plain PyTorch versions of the port's kernels (what the wrappers run on
CPU tensors) against the JAX package's Pallas kernels in interpret mode.

Same sizes and tolerances as ``tests/test_conv_of.py``: outputs 1e-5
(fp32), statistics 1e-3 relative. Inputs are seeded numpy arrays in the JAX
layouts, transposed to NCDHW and torch weight layouts for the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels.conv3d import weight_matrix
from medseg.kernels.conv_of import (
    conv3x3x3_of,
    conv3x3x3_of_cat2,
    conv3x3x3_of_combine,
    from_output_form,
    norm_affine_from_stats,
    outhead_of,
    res_weight,
    to_output_form,
)
from medseg_torch.kernels import conv_of as tconv

B, D, H, W, C, CO = 2, 6, 8, 8, 8, 8
OUT = dict(rtol=1e-5, atol=1e-5)
STATS = dict(rtol=1e-3, atol=1e-3)


def _t(x):
    """NDHWC numpy -> NCDHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _tw(k):
    """flax conv kernel (kd, kh, kw, in, out) -> torch (out, in, kd, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2))))


def _ab(rng, b=B, c=C):
    """Per-(b, c) affine: JAX (B, C, 1), port (B, C)."""
    a = rng.normal(size=(b, c, 1)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a[..., 0].copy())


def _check_out(got_t, ref_of, **tol):
    ref = np.asarray(from_output_form(ref_of, H, W))
    np.testing.assert_allclose(got_t.numpy().transpose(0, 2, 3, 4, 1), ref, **(tol or OUT))


def _check_stats(got_t, ref):
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref[..., 0]), **STATS)


@pytest.mark.parametrize("c_in,act,residual", [
    (1, "none", False), (C, "none", False), (C, "affine_leaky", False), (C, "none", True),
    (4, "none", True), (C, "affine_leaky", True),
])
def test_conv_plain_matches_pallas(rng, c_in, act, residual):
    x = rng.normal(size=(B, D, H, W, c_in)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, c_in, CO)) * 0.2).astype(np.float32)
    k3 = rng.normal(size=(1, 1, 1, c_in, CO)).astype(np.float32)
    aj, at = _ab(rng, c=c_in)
    bj, bt = _ab(rng, c=c_in)
    ref = conv3x3x3_of(
        to_output_form(jnp.asarray(x)), weight_matrix(jnp.asarray(k), jnp.float32), aj, bj,
        res_weight(jnp.asarray(k3), jnp.float32) if residual else None,
        h=H, w=W, input_act=act, residual=residual, out_dtype=jnp.float32, interpret=True,
    )
    affine = (at, bt) if act == "affine_leaky" else (None, None)
    got = tconv.conv3x3x3_of(_t(x), _tw(k), *affine, wres=_tw(k3) if residual else None)
    assert len(got) == len(ref)
    _check_out(got[0], ref[0])
    _check_stats(got[1], ref[1])
    _check_stats(got[2], ref[2])
    if residual:
        _check_out(got[3], ref[3])
        _check_stats(got[4], ref[4])
        _check_stats(got[5], ref[5])


def test_cat2_plain_matches_pallas(rng):
    xa, xb = (rng.normal(size=(B, D, H, W, C)).astype(np.float32) for _ in range(2))
    k = (rng.normal(size=(3, 3, 3, 2 * C, CO)) * 0.2).astype(np.float32)
    k3 = rng.normal(size=(1, 1, 1, 2 * C, CO)).astype(np.float32)
    ref = conv3x3x3_of_cat2(
        to_output_form(jnp.asarray(xa)), to_output_form(jnp.asarray(xb)),
        weight_matrix(jnp.asarray(k), jnp.float32), res_weight(jnp.asarray(k3), jnp.float32),
        h=H, w=W, out_dtype=jnp.float32, interpret=True,
    )
    got = tconv.conv3x3x3_of_cat2(_t(xa), _t(xb), _tw(k), _tw(k3))
    for i in (0, 3):
        _check_out(got[i], ref[i])
    for i in (1, 2, 4, 5):
        _check_stats(got[i], ref[i])


@pytest.mark.parametrize("x_channels", [1, C])
def test_combine_plain_matches_pallas(rng, x_channels):
    up, y = (rng.normal(size=(B, D, H, W, C)).astype(np.float32) for _ in range(2))
    x1 = rng.normal(size=(B, D, H, W, x_channels)).astype(np.float32)
    (ayj, ayt), (byj, byt), (axj, axt), (bxj, bxt) = (_ab(rng) for _ in range(4))
    k = (rng.normal(size=(3, 3, 3, 2 * C, CO)) * 0.2).astype(np.float32)
    k3 = rng.normal(size=(1, 1, 1, 2 * C, CO)).astype(np.float32)
    ref = conv3x3x3_of_combine(
        to_output_form(jnp.asarray(up)), to_output_form(jnp.asarray(y)),
        to_output_form(jnp.asarray(x1)), ayj, byj, axj, bxj,
        weight_matrix(jnp.asarray(k), jnp.float32), res_weight(jnp.asarray(k3), jnp.float32),
        h=H, w=W, out_dtype=jnp.float32, interpret=True,
    )
    got = tconv.conv3x3x3_of_combine(
        _t(up), _t(y), _t(x1), ayt, byt, axt, bxt, _tw(k), _tw(k3)
    )
    tol = dict(rtol=1e-4, atol=1e-4)  # as test_conv_of's combine test: 2C-deep sums
    for i in (0, 3):
        _check_out(got[i], ref[i], **tol)
    for i in (1, 2, 4, 5):
        _check_stats(got[i], ref[i])


@pytest.mark.parametrize("scaled", [False, True])
def test_outhead_plain_matches_pallas(rng, scaled):
    n_classes, co_pad = 3, 8
    z, r = (rng.normal(size=(B, D, H, W, C)).astype(np.float32) for _ in range(2))
    (azj, azt), (bzj, bzt), (arj, art), (brj, brt) = (_ab(rng) for _ in range(4))
    kout = np.zeros((co_pad, C), np.float32)
    kout[:n_classes] = rng.normal(size=(n_classes, C))
    bias = np.zeros((co_pad,), np.float32)
    bias[:n_classes] = rng.normal(size=n_classes)
    scale = rng.uniform(0.2, 1.0, size=(B, D, H, W, 1)).astype(np.float32)
    ref = outhead_of(
        to_output_form(jnp.asarray(z)), to_output_form(jnp.asarray(r)), azj, bzj, arj, brj,
        jnp.asarray(kout), jnp.asarray(bias[:, None]),
        to_output_form(jnp.asarray(scale)) if scaled else None,
        out_dtype=jnp.float32, interpret=True, transposed=False,
    )
    got = tconv.outhead_of(
        _t(z), _t(r), azt, bzt, art, brt, torch.from_numpy(kout), torch.from_numpy(bias),
        _t(scale) if scaled else None,
    )
    assert got.shape == (B, co_pad, D, H, W)
    ref = np.asarray(from_output_form(ref, H, W, dpad=0))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 4, 1), ref, rtol=1e-4, atol=1e-4)


def test_norm_affine_from_stats_matches_jax(rng):
    s = rng.normal(size=(B, C)).astype(np.float32) * 50
    ss = (rng.uniform(1, 2, size=(B, C)) * 500).astype(np.float32)
    scale, bias = rng.normal(size=C).astype(np.float32), rng.normal(size=C).astype(np.float32)
    lanes = lambda t: jnp.broadcast_to(jnp.asarray(t)[..., None], t.shape + (128,))  # noqa: E731
    aj, bj = norm_affine_from_stats(lanes(s), lanes(ss), jnp.asarray(scale), jnp.asarray(bias), 384)
    at, bt = tconv.norm_affine_from_stats(*map(torch.from_numpy, (s, ss, scale, bias)), 384)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj[..., 0]), rtol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj[..., 0]), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    tconv.reset_launches()
    x = torch.from_numpy(rng.normal(size=(1, C, 4, 4, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(CO, C, 3, 3, 3)).astype(np.float32))
    got = tconv.conv3x3x3_of(x, w)
    ref = tconv.conv3x3x3_of_plain(x, w)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert all(fn.launches == 0 for fn in tconv.KERNELS)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tconv._launch_conv("plain", (x.to("meta"),), w.to("meta"), None, ())
