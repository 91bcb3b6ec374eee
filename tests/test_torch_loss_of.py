"""The fused DiceCE loss of the port (``medseg_torch.kernels.loss_of``, its
plain versions on CPU tensors) against the JAX package's Pallas pair in
interpret mode, at the sizes of ``tests/test_loss_of.py``.

The JAX kernels take of-form logits (B, D, CO_pad, H*W) with the classes
padded to a multiple of 8; the port takes NCDHW logits as the model emits
them. Tolerances: the sums 1e-5 relative, the loss 1e-5, dlogits 1e-4
relative with a 1e-7 floor (as the JAX tests hold the fused loss to the jnp
one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels import loss_of as jlo
from medseg_torch.kernels import loss_of as tlo

B, D, H, W, C = 2, 8, 8, 16, 5


def _data(rng, c=C):
    logits = (4.0 * rng.normal(size=(B, D, H, W, c))).astype(np.float32)
    labels = rng.integers(0, c, size=(B, D, H, W)).astype(np.int32)
    return logits, labels


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def test_plain_sums_match_pallas(rng):
    logits, labels = _data(rng)
    co = 8
    lg = jnp.asarray(logits).transpose(0, 1, 4, 2, 3).reshape(B, D, C, H * W)
    lg = jnp.pad(lg, ((0, 0), (0, 0), (0, co - C), (0, 0)))
    want = jlo._sums(lg, jnp.asarray(labels).reshape(B, D, H * W), C, True)
    got = tlo.dice_ce_sums(_t(logits), torch.from_numpy(labels))
    assert [tuple(t.shape) for t in got] == [(B,), (B, C), (B, C), (B, C)]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :C], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 3.0], ids=["unit_cotangent", "scaled_cotangent"])
def test_fused_loss_matches_pallas(rng, scale):
    logits, labels = _data(rng)
    j_lab = jnp.asarray(labels)
    want, g_want = jax.value_and_grad(
        lambda lg: scale * jlo.dice_ce_fused(lg, j_lab, interpret=True)
    )(jnp.asarray(logits))
    lt = _t(logits).requires_grad_()
    got = scale * tlo.dice_ce_fused(lt, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        np.moveaxis(lt.grad.numpy(), 1, -1), np.asarray(g_want), rtol=1e-4, atol=1e-7
    )


def test_fused_loss_takes_a_label_channel(rng):
    logits, labels = _data(rng)
    lab = torch.from_numpy(labels)
    want = tlo.dice_ce_fused(_t(logits), lab)
    got = tlo.dice_ce_fused(_t(logits), lab[:, None])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_bwd_matches_its_formula(rng):
    """K8's plain version on arbitrary coefficients against the closed form
    written out per class."""
    logits, labels = _data(rng)
    lt, lab = _t(logits), torch.from_numpy(labels)
    ca = torch.from_numpy(rng.normal(size=(B, C)).astype(np.float32))
    cb = torch.from_numpy(rng.normal(size=(B, C)).astype(np.float32))
    cec = torch.from_numpy(rng.uniform(0.5, 1.5, size=(B,)).astype(np.float32))
    got = tlo.dice_ce_bwd(lt, lab, ca, cb, cec)
    p = torch.softmax(lt, dim=1)
    g = torch.nn.functional.one_hot(lab.long(), C).movedim(-1, 1).float()
    u = ca[:, :, None, None, None] * g + cb[:, :, None, None, None]
    pu = sum(p[:, k] * u[:, k] for k in range(C))[:, None]
    want = cec[:, None, None, None, None] * (p - g) + p * (u - pu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_labels_are_checked(rng):
    logits, labels = _data(rng)
    lt = _t(logits)
    with pytest.raises(ValueError, match="int32"):
        tlo.dice_ce_sums(lt, torch.from_numpy(labels).long())
    with pytest.raises(ValueError, match="shape"):
        tlo.dice_ce_sums(lt, torch.from_numpy(labels)[:, :-1])
    bad = torch.from_numpy(labels).clone()
    bad[0, 0, 0, 0] = C  # a label >= K is a caller error of the ignore-free CT contract
    with pytest.raises(ValueError, match="outside"):
        tlo.dice_ce_sums(lt, bad)


def test_cpu_tensors_take_the_plain_versions_without_counting(rng):
    logits, labels = _data(rng)
    tlo.reset_launches()
    lt = _t(logits).requires_grad_()
    tlo.dice_ce_fused(lt, torch.from_numpy(labels)).backward()
    assert all(fn.launches == 0 for fn in tlo.KERNELS)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tlo._check_logits(lt.detach().to("meta"))


def test_supported_predicate():
    assert tlo.fused_loss_supported((4, 14, 96, 96, 96), "ct")
    assert tlo.fused_loss_supported((4, 14, 96, 90, 90), "ct")  # no lane condition
    assert not tlo.fused_loss_supported((4, 14, 96, 96, 96), "mri")
    assert not tlo.fused_loss_supported((4, 32, 96, 96, 96), "ct")  # K > 16
    assert not tlo.fused_loss_supported((4, 14, 96, 96), "ct")
