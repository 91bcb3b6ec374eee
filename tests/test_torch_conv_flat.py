"""The flat per-conv route (K9) of the port against the JAX package's
``medseg/kernels/conv3d.py``.

- K9's plain version against the Pallas kernel run in interpret mode
  (``_pallas_conv(..., interpret=True)``) at ``tests/test_kernels.py``'s
  shapes, 1e-5 (fp32 both sides, sums in another order);
- ``FlatConvFn``'s gradients against ``jax.grad`` of ``_xla_conv`` (the fp32
  conv whose VJP the JAX route's backward is), 1e-5;
- K9's two routes on the card, by shape and dtype (``conv_of.tc_route``,
  mode flat, and ``conv_of.tc_staging``): the flat route's shapes in bf16
  on the tensor cores with the asynchronous staging, fp32 on the CUDA cores;
  the
  tensor-core route's GEMM order is held to the Pallas kernel in
  ``tests/test_torch_conv_tc.py``;
- the routing predicates against the JAX ones on a table of shapes: the
  port's ``flat_route`` against JAX's ``flat_supported and not _of_ok`` on
  shapes where the two packages' K1 predicates agree (the port's K1 also
  takes odd D and any H*W);
- a tiny UNETR with the route forced on (``PALLAS_PER_CONV`` set and the
  width threshold lowered, as the training tests lower ``OF_MIN_HW``) against
  the flax forward at 1e-4, and its gradients against the same model with
  the route off (1e-4 relative L2 per leaf; the leaves whose true gradient an
  instance norm cancels to 0 against 1e-4 of the largest gradient, as in
  ``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels import conv3d as jconv
from medseg.models.unetr import UNETR as JUNETR
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.kernels import conv3d, conv_flat, conv_of
from medseg_torch.models.unetr import UNETR
from test_torch_train import NORM_CANCELLED

TOL = dict(rtol=1e-5, atol=1e-5)


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _torch_weight(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))


@pytest.mark.parametrize("shape,co", [((1, 6, 8, 8, 16), 16), ((2, 4, 8, 16, 8), 16),
                                      ((2, 5, 9, 24, 128), 64), ((1, 5, 9, 12, 32), 16)])
def test_plain_matches_pallas_interpret(shape, co):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, shape[-1], co)) * 0.1).astype(np.float32)
    want = np.asarray(jconv._pallas_conv(jnp.asarray(x), jnp.asarray(k), interpret=True))
    got = conv_flat.conv3x3x3_flat(_ncdhw(x), _torch_weight(k))  # CPU: the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, **TOL)


def test_plain_rounds_nothing_of_bf16_operands():
    """bf16 operands are summed in fp32 and returned in fp32, as the JAX
    kernel's ``preferred_element_type``."""
    x = torch.randn(1, 8, 4, 6, 6).bfloat16()
    w = torch.randn(8, 8, 3, 3, 3).bfloat16()
    got = conv_flat.conv3x3x3_flat(x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.nn.functional.conv3d(x.float(), w.float(), padding=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_conv_fn_gradients_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 6, 8, 8)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, 8, 16)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, 4, 6, 8, 16)).astype(np.float32)
    if dtype == torch.bfloat16:  # both sides see the same bf16 operands
        x, k = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, k))

    def loss(x, k):
        return jnp.sum(jconv._xla_conv(x, k) * g)

    jdx, jdk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx = _ncdhw(x).to(dtype).requires_grad_(True)
    tk = _torch_weight(k).to(dtype).requires_grad_(True)
    y = conv3d.conv3x3x3_flat(tx, tk)
    assert y.dtype == torch.float32
    (y * _ncdhw(g)).sum().backward()
    assert tx.grad.dtype == dtype and tk.grad.dtype == dtype
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(np.moveaxis(tx.grad.float().numpy(), 1, -1), np.asarray(jdx), **tol)
    np.testing.assert_allclose(tk.grad.float().numpy(), np.transpose(np.asarray(jdk), (4, 3, 0, 1, 2)),
                               **tol)


# (B, D, H, W, C), C_out
SHAPES = [
    ((4, 96, 96, 96, 16), 16), ((4, 96, 96, 96, 32), 16), ((4, 48, 48, 48, 64), 32),
    ((4, 48, 48, 48, 128), 64), ((4, 48, 48, 48, 32), 32), ((4, 48, 48, 48, 64), 64),
    ((4, 24, 24, 24, 128), 64), ((1, 128, 128, 128, 16), 16), ((1, 96, 96, 96, 1), 16),
    ((1, 96, 96, 96, 16), 13), ((4, 96, 96, 96, 64), 32), ((4, 48, 48, 48, 128), 128),
    ((4, 64, 64, 64, 128), 64), ((2, 96, 96, 96, 136), 64), ((1, 48, 48, 48, 96), 80),
    ((2, 64, 256, 256, 128), 64),
]


@pytest.mark.parametrize("shape,co", SHAPES)
def test_routing_predicates_match_jax(monkeypatch, shape, co):
    b, d, h, w, c = shape
    ncdhw = (b, c, d, h, w)
    assert conv3d.flat_supported(ncdhw, co) == jconv.flat_supported(shape, co)
    assert conv3d.train_route(ncdhw, co) == jconv._of_ok(shape, co)
    monkeypatch.setattr(conv3d, "PALLAS_PER_CONV", True)
    assert conv3d.flat_route(ncdhw, co) == (jconv.flat_supported(shape, co)
                                            and not jconv._of_ok(shape, co))
    monkeypatch.setattr(conv3d, "PALLAS_PER_CONV", False)
    assert not conv3d.flat_route(ncdhw, co)


@pytest.mark.parametrize("shape,co,tc,staged", [
    ((4, 128, 48, 48, 48), 64, True, True),  # decoder3.conv1 at feature size 32
    ((4, 32, 96, 96, 96), 16, True, True), ((4, 64, 48, 48, 48), 32, True, True),
    ((2, 128, 24, 24, 20), 64, True, False),  # W % 8 != 0: the register staging
    ((2, 120, 48, 48, 48), 64, False, False), ((2, 128, 48, 48, 48), 128, False, False),
    ((2, 24, 48, 48, 48), 16, False, False),  # C % 16 != 0: the CUDA cores
])
def test_k9_routes_by_shape_and_dtype(shape, co, tc, staged):
    """bf16 K9 calls with C % 16 == 0 (C <= 128) and C_out 16, 32 or 64 take
    the tensor cores, with the asynchronous (cp.async) staging where W % 8
    == 0; every other
    width K9 has, and fp32, the CUDA-core kernel."""
    c, w = shape[1], shape[4]
    assert conv_flat.has_kernel(c, co)
    assert conv_of.tc_route(c, co, torch.bfloat16, "flat") is tc
    assert not conv_of.tc_route(c, co, torch.float32, "flat")
    assert bool(tc and conv_of.tc_staging("flat", w)) is staged


def test_the_pretraining_conv_takes_the_flat_route(monkeypatch):
    """decoder3.conv1 of a feature-size-32 UNETR at a 96^3 crop (the concat
    of the upsample and the enc2 skip, 128 -> 64 at 48^3) is the one conv
    that the flat route takes; the other 3x3x3 convs at >= 48^2 take K1."""
    monkeypatch.setattr(conv3d, "PALLAS_PER_CONV", True)
    assert conv3d.flat_route((4, 128, 48, 48, 48), 64)
    for x_shape, co in (((4, 64, 48, 48, 48), 64), ((4, 64, 96, 96, 96), 32),
                        ((4, 32, 96, 96, 96), 32), ((4, 1, 96, 96, 96), 32)):
        assert not conv3d.flat_route(x_shape, co)


TINY = dict(in_channels=1, out_channels=2, img_size=(32, 32, 32), feature_size=8, hidden_size=24,
            mlp_dim=48, num_heads=4, num_layers=4, patch_size=16)


@pytest.fixture(scope="module")
def tiny():
    model = JUNETR(**TINY)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
    params = model.init(jax.random.key(0), jnp.asarray(x))
    enc4, logits = jax.jit(model.apply)(params, jnp.asarray(x))
    return params, x, np.asarray(enc4), np.asarray(logits)


def test_tiny_unetr_with_the_flat_route_matches_flax(monkeypatch, tiny):
    params, x, enc4, logits = tiny
    monkeypatch.setattr(conv3d, "PALLAS_PER_CONV", True)
    monkeypatch.setattr(conv3d, "FLAT_MIN_W", 8)
    calls = []
    kernel = conv_flat.conv3x3x3_flat
    monkeypatch.setattr(conv_flat, "conv3x3x3_flat",
                        lambda x, w: calls.append(tuple(x.shape)) or kernel(x, w))
    model = UNETR(**TINY)
    model.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got_enc4, got = model(_ncdhw(x))
    # the channel-reducing conv1 of decoder2, decoder3 and decoder4
    assert sorted(calls) == [(2, 16, 32, 32, 32), (2, 32, 16, 16, 16), (2, 64, 8, 8, 8)]
    scale = np.abs(logits).max()
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), logits, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(np.moveaxis(got_enc4.numpy(), 1, -1), enc4, rtol=1e-4,
                               atol=1e-4 * np.abs(enc4).max())


def test_flat_route_gives_the_plain_gradients(monkeypatch, tiny):
    params, x, _, _ = tiny
    grads = []
    for routed in (False, True):
        monkeypatch.setattr(conv3d, "PALLAS_PER_CONV", routed)
        monkeypatch.setattr(conv3d, "FLAT_MIN_W", 8)
        model = UNETR(**TINY)
        model.load_state_dict(state_dict_from_flax(params))
        _, logits = model(_ncdhw(x))
        logits.square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    scale = max(float(g.abs().max()) for g in grads[0].values())
    for name, g in grads[0].items():
        err = (grads[1][name] - g).norm() / g.norm()
        if NORM_CANCELLED.search(name):  # a true gradient of 0: rounding noise on both sides
            torch.testing.assert_close(grads[1][name], g, rtol=0, atol=1e-4 * scale, msg=name)
        else:
            assert err < 1e-4, (name, err)
