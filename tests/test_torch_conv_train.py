"""The conv of the training step (``medseg_torch.kernels.conv3d``): K6's
plain version against the JAX package's Pallas wgrad kernel in interpret
mode, and the autograd Function against ``jax.vjp`` of the XLA conv and
against torch autograd in fp64.

Sizes of ``tests/test_conv_train.py`` (B 1, D 4, 48x48, C 8 -> 8); seeded
numpy inputs in the JAX layouts, moved to NCDHW and torch weight layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from medseg.kernels.conv3d import _xla_conv
from medseg.kernels.conv_of import conv3x3x3_wgrad_of, to_output_form, wgrad_to_kernel
from medseg_torch.kernels import conv3d, conv_of
from medseg_torch.models import blocks

B, D, S, CI, CO = 1, 4, 48, 8, 8


@pytest.fixture
def data():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, D, S, S, CI)).astype(np.float32)
    kern = (0.2 * rng.normal(size=(3, 3, 3, CI, CO))).astype(np.float32)
    g = rng.normal(size=(B, D, S, S, CO)).astype(np.float32)
    return x, kern, g


def _t(x):
    """NDHWC numpy -> NCDHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _tw(k):
    """flax conv kernel (kd, kh, kw, in, out) -> torch (out, in, kd, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2))))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def test_plain_wgrad_matches_pallas(data):
    x, _, g = data
    x_of = to_output_form(jnp.asarray(x), dtype=jnp.float32)
    g_of = jnp.asarray(g).transpose(0, 1, 4, 2, 3).reshape(B, D, CO, S * S)
    dk = wgrad_to_kernel(conv3x3x3_wgrad_of(x_of, g_of, h=S, w=S, interpret=True), CI, CO)
    got = conv_of.conv3x3x3_wgrad_of(_t(x), _t(g))
    assert got.shape == (CO, CI, 3, 3, 3) and got.dtype == torch.float32
    _close(got.numpy(), _tw(dk).numpy(), 2e-4)


def test_function_matches_jax_vjp(data):
    x, kern, g = data
    y_want, vjp = jax.vjp(_xla_conv, jnp.asarray(x), jnp.asarray(kern))
    dx_want, dk_want = vjp(jnp.asarray(g))
    xt, wt = _t(x).requires_grad_(), _tw(kern).requires_grad_()
    y = conv3d.conv3x3x3(xt, wt)
    y.backward(_t(g))
    _close(np.moveaxis(y.detach().numpy(), 1, -1), y_want, 1e-5)
    _close(np.moveaxis(xt.grad.numpy(), 1, -1), dx_want, 1e-5)
    _close(wt.grad.numpy(), _tw(dk_want).numpy(), 2e-4)


def test_function_matches_torch_autograd_fp64(data):
    """dx = conv(g, flip(W)^T) is exact for stride-1 zero-padded 3^3 convs:
    the Function against autograd through ``F.conv3d`` in fp64 (the plain
    versions compute in fp32)."""
    x, kern, g = data
    xs = [_t(x).double().requires_grad_() for _ in range(2)]
    ws = [_tw(kern).double().requires_grad_() for _ in range(2)]
    conv3d.conv3x3x3(xs[0], ws[0]).backward(_t(g).double())
    F.conv3d(xs[1], ws[1], padding=1).backward(_t(g).double())
    _close(xs[0].grad.numpy(), xs[1].grad.numpy(), 1e-5)
    _close(ws[0].grad.numpy(), ws[1].grad.numpy(), 1e-5)


@pytest.mark.parametrize("x_needs_grad", [False, True])
def test_data_gradient_only_when_needed(data, monkeypatch, x_needs_grad):
    """The conv of the raw image (enc1.conv1) needs no data gradient: K1 runs
    once (the forward), not twice."""
    x, kern, g = data
    calls = []
    conv = conv_of.conv3x3x3_of
    monkeypatch.setattr(conv_of, "conv3x3x3_of", lambda *a, **k: calls.append(1) or conv(*a, **k))
    xt, wt = _t(x).requires_grad_(x_needs_grad), _tw(kern).requires_grad_()
    conv3d.conv3x3x3(xt, wt).backward(_t(g))
    assert len(calls) == (2 if x_needs_grad else 1)
    assert (xt.grad is not None) == x_needs_grad and wt.grad is not None


def test_bf16_operands_round_like_the_kernels(data):
    """bf16 operands, fp32 sums, output rounded to bf16; dW rounded to the
    weight's dtype."""
    x, kern, g = data
    xt, wt = _t(x).bfloat16().requires_grad_(), _tw(kern).bfloat16().requires_grad_()
    y = conv3d.conv3x3x3(xt, wt)
    y.backward(_t(g).bfloat16())
    assert y.dtype == xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    want = F.conv3d(xt.detach().float(), wt.detach().float(), padding=1).bfloat16()
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    dw = torch.nn.grad.conv3d_weight(
        xt.detach().float(), wt.shape, _t(g).bfloat16().float(), padding=1
    ).bfloat16()
    torch.testing.assert_close(wt.grad, dw, rtol=0, atol=0)


def test_route_predicate():
    assert conv3d.train_route((4, 16, 96, 96, 96), 16)
    assert conv3d.train_route((4, 64, 48, 48, 48), 32)
    assert conv3d.train_route((4, 1, 95, 96, 96), 16)  # no even-depth or lane condition
    assert not conv3d.train_route((4, 64, 24, 24, 24), 64)  # H*W below 48*48
    assert not conv3d.train_route((4, 128, 96, 96, 96), 16)  # C above 64
    assert not conv3d.train_route((4, 16, 96, 96, 96), 128)  # C_out above 64


@pytest.mark.parametrize("grad", [True, False])
def test_conv_module_takes_the_function_with_gradients(monkeypatch, grad):
    calls = []
    fn = conv3d.conv3x3x3
    monkeypatch.setattr(conv3d, "conv3x3x3", lambda *a: calls.append(1) or fn(*a))
    monkeypatch.setattr(conv3d, "OF_MIN_HW", 8 * 8)
    torch.manual_seed(0)
    conv = blocks.Conv3d(4, 8)
    x = torch.randn(2, 4, 4, 8, 8)
    with torch.set_grad_enabled(grad):
        y = conv(x)
    assert len(calls) == int(grad)
    torch.testing.assert_close(y, conv.conv(x), rtol=1e-5, atol=1e-5)
