"""The port's DiceCE losses (``medseg_torch.ops.losses``) against the JAX
package's (``medseg.ops.losses``): values and gradients w.r.t. the logits
(``jax.grad``) to 1e-5, in both reference configurations.

Seeded numpy inputs in the JAX layout (NDHWC), moved to NCDHW for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.ops import losses as jl
from medseg_torch.ops import losses as tl

B, D, H, W, K = 2, 5, 6, 7, 4
VALUE = dict(rtol=1e-5)
GRAD = dict(rtol=1e-5, atol=1e-9)


def _t(x):
    """NDHWC numpy -> NCDHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _logits(rng, k=K):
    return (2.0 * rng.normal(size=(B, D, H, W, k))).astype(np.float32)


def _compare(jax_fn, torch_fn, logits):
    want, g_want = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    lt = _t(logits).requires_grad_()
    got = torch_fn(lt)
    got.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(want), **VALUE)
    np.testing.assert_allclose(np.moveaxis(lt.grad.numpy(), 1, -1), np.asarray(g_want), **GRAD)


@pytest.mark.parametrize("label_channel", [False, True], ids=["bdhw", "trailing_channel"])
def test_ct_dice_ce_matches_jax(rng, label_channel):
    logits = _logits(rng)
    labels = rng.integers(0, K, size=(B, D, H, W)).astype(np.int32)
    j_lab = jnp.asarray(labels[..., None] if label_channel else labels)
    t_lab = torch.from_numpy(labels[:, None] if label_channel else labels)
    _compare(
        lambda lg: jl.dice_ce_loss(lg, j_lab, softmax=True, to_onehot_y=True),
        lambda lg: tl.dice_ce_loss(lg, t_lab, softmax=True, to_onehot_y=True),
        logits,
    )


@pytest.mark.parametrize("target_channels", [K, 1], ids=["argmax_quirk", "first_channel"])
def test_mri_dice_ce_matches_jax(rng, target_channels):
    """Sigmoid dice over a multi-channel float target; the CE term argmaxes a
    same-channel-count target (MONAI 0.6's quirk) and otherwise takes its
    first channel as the label."""
    logits = _logits(rng)
    target = (rng.uniform(size=(B, D, H, W, target_channels)) > 0.5).astype(np.float32)
    _compare(
        lambda lg: jl.dice_ce_loss(lg, jnp.asarray(target), sigmoid=True),
        lambda lg: tl.dice_ce_loss(lg, _t(target), sigmoid=True),
        logits,
    )


@pytest.mark.parametrize("include_background", [True, False])
def test_dice_loss_matches_jax(rng, include_background):
    logits = _logits(rng)
    labels = rng.integers(0, K, size=(B, D, H, W)).astype(np.int32)
    _compare(
        lambda lg: jl.dice_loss(lg, jnp.asarray(labels), softmax=True, to_onehot_y=True,
                                include_background=include_background),
        lambda lg: tl.dice_loss(lg, torch.from_numpy(labels), softmax=True, to_onehot_y=True,
                                include_background=include_background),
        logits,
    )


def test_softmax_ce_matches_jax(rng):
    logits = _logits(rng)
    labels = rng.integers(0, K, size=(B, D, H, W)).astype(np.int32)
    _compare(
        lambda lg: jl.softmax_ce_with_label_indices(lg, jnp.asarray(labels)),
        lambda lg: tl.softmax_ce_with_label_indices(lg, torch.from_numpy(labels)),
        logits,
    )


def test_to_onehot_matches_jax(rng):
    labels = rng.integers(0, K, size=(B, D, H, W)).astype(np.int32)
    want = np.asarray(jl.to_onehot(jnp.asarray(labels[..., None]), K))
    got = tl.to_onehot(torch.from_numpy(labels[:, None]), K)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1), want)


def test_bf16_logits_give_an_fp32_loss(rng):
    logits = _logits(rng)
    labels = torch.from_numpy(rng.integers(0, K, size=(B, D, H, W)).astype(np.int32))
    lt = _t(logits)
    got = tl.dice_ce_loss(lt.bfloat16(), labels, softmax=True, to_onehot_y=True)
    want = tl.dice_ce_loss(lt.bfloat16().float(), labels, softmax=True, to_onehot_y=True)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
