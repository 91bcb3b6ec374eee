"""The library routes that ``chip_smoke.py``'s routes phase runs beside the
hand kernels, held to the JAX package on the same setting of its ablation
switches (CPU: the kernels' plain versions). ``chip_smoke.library_route``
patches the port for one run; nothing of it is a user option.

- "convs" (the JAX ``MEDSEG_TRAIN_CONV=xla``): no conv takes the autograd
  Function; a routed-size conv's forward and gradients (the library conv)
  against the JAX ``conv3x3x3`` (off a TPU: ``_xla_conv`` with its fp32 VJP)
  within 1e-5 relative in fp32, and a tiny UNETR's loss and global gradient
  against the JAX model's, both routes: fp32 within 1e-4, bf16 within the
  training bounds (loss 1e-3 relative, global gradient 5e-2 relative L2).
- "wgrad" (``MEDSEG_WGRAD=xla``): ``Conv3x3x3Fn``'s filter gradient by
  ``chip_smoke.library_wgrad`` against the JAX ``_conv_dk`` at C 1, 4, 16
  and 32 (bf16 operands, fp32 sums: one rounding of the sum to bf16), K6 not
  called, the data gradient still K1's and bitwise the default's.
- "loss" (``MEDSEG_FUSED_LOSS=0``): ``make_loss_fn``'s CT loss is the plain
  DiceCE; loss and dlogits against the JAX ``dice_ce_loss``, both routes.
- The tanh GELU (``tanh_gelu``, the JAX package's serving
  ``gelu_approx``): ``_lowres_stages`` against the JAX ``_xla_stages`` with
  tanh and exact GELU (fp32, 1e-5 relative; the two differ by far more).
- Each patch is undone when its block ends.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from medseg.kernels import conv3d as jconv3d
from medseg.kernels import unetr_of as juo
from medseg.models.unetr import UNETR as JUNETR
from medseg.ops.losses import dice_ce_loss as j_dice_ce
from medseg_torch.engine import train as ttrain
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.kernels import conv3d, conv_of
from medseg_torch.kernels import unetr_of as tuo
from medseg_torch.models import blocks
from medseg_torch.models.unetr import UNETR

FP32_REL = 1e-5
FP32_STEP_REL = 1e-4  # a whole fp32 step, as in tests/test_torch_train.py
LOSS_REL, GRAD_REL_L2 = 1e-3, 5e-2  # the training bounds of the bf16 step
B, D, S = 1, 4, 48  # H*W = 48^2: the smallest plane the training route takes
TINY = dict(in_channels=1, out_channels=2, img_size=(32, 32, 32), feature_size=4, hidden_size=24,
            mlp_dim=48, num_heads=4, num_layers=4, patch_size=16)
SMALL = dict(out_channels=3, img_size=(32, 32, 32), feature_size=8, hidden_size=24, mlp_dim=48,
             num_heads=4, num_layers=4, patch_size=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: these tensors are small, and under a
    parallel test run an 8-thread pool per worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    """NDHWC numpy -> NCDHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _tw(k):
    """flax conv kernel (kd, kh, kw, in, out) -> torch (out, in, kd, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2))))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _counter(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


# ---- "convs": every 3x3x3 conv on the library ----------------------------


@pytest.mark.parametrize("route", ["of", "xla"])
def test_library_conv_matches_jax_conv(monkeypatch, route):
    """A conv at a routed size: "of" takes the Function, "xla" (the library
    route's "convs") the library conv; either way forward, dx and dW equal
    the JAX ``conv3x3x3`` under the same setting (its fp32 VJP off a TPU) to
    fp32 rounding."""
    monkeypatch.setattr(jconv3d, "TRAIN_CONV", route)
    calls = _counter(monkeypatch, conv3d, "conv3x3x3")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, D, S, S, 8)).astype(np.float32)
    kern = (0.2 * rng.normal(size=(3, 3, 3, 8, 16))).astype(np.float32)
    g = rng.normal(size=(B, D, S, S, 16)).astype(np.float32)
    y_want, vjp = jax.vjp(jconv3d.conv3x3x3, jnp.asarray(x), jnp.asarray(kern))
    dx_want, dk_want = vjp(jnp.asarray(g))

    conv = blocks.Conv3d(8, 16)
    with torch.no_grad():
        conv.conv.weight.copy_(_tw(kern))
        conv.conv.bias.zero_()
    xt = _t(x).requires_grad_()
    with chip_smoke.library_route(("convs",) if route == "xla" else ()):
        y = conv(xt)
        y.backward(_t(g))
    assert len(calls) == (route == "of")
    assert _rel_l2(np.moveaxis(y.detach().numpy(), 1, -1), y_want) < FP32_REL
    assert _rel_l2(np.moveaxis(xt.grad.numpy(), 1, -1), dx_want) < FP32_REL
    assert _rel_l2(conv.conv.weight.grad.numpy(), _tw(dk_want).numpy()) < FP32_REL


@pytest.fixture(scope="module")
def tiny():
    model = JUNETR(**TINY)
    rng = np.random.default_rng(0)
    image = rng.normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
    label = (image[..., 0] > 0).astype(np.int32)
    params = model.init(jax.random.key(0), jnp.asarray(image))

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(image), return_encoder_features=False)
        return j_dice_ce(logits, jnp.asarray(label), softmax=True, to_onehot_y=True)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.array, grads))
    return params, image, label, float(loss), want


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("route", ["of", "xla"])
def test_library_conv_step_matches_jax(tiny, monkeypatch, route, dtype):
    """A tiny UNETR's loss and global gradient, every 3x3x3 conv at a size
    the Function takes (``OF_MIN_HW`` lowered): on the library ("xla") not
    one conv reaches K1 or K6, and the step agrees with the JAX model's
    (fp32) as closely as on the kernels: in fp32 within
    ``tests/test_torch_train.py``'s 1e-4 (both routes measure 2.3e-5: the
    leaves an instance norm cancels carry rounding noise), in bf16 within
    the training bounds."""
    params, image, label, j_loss, want = tiny
    monkeypatch.setattr(conv3d, "OF_MIN_HW", 1)
    monkeypatch.setattr(jconv3d, "TRAIN_CONV", route)
    k1 = _counter(monkeypatch, conv_of, "conv3x3x3_of")
    k6 = _counter(monkeypatch, conv_of, "conv3x3x3_wgrad_of")
    model = UNETR(**TINY, dtype=dtype)
    model.load_state_dict(state_dict_from_flax(params))
    with chip_smoke.library_route(("convs",) if route == "xla" else ()):
        loss = ttrain.make_loss_fn("ct")(model, _t(image), torch.from_numpy(label))
        loss.backward()
    # 10 convs: forward, and data gradients of all but encoder1.conv1's
    assert (len(k1), len(k6)) == ((19, 10) if route == "of" else (0, 0))
    got = np.concatenate([p.grad.numpy().ravel() for _, p in model.named_parameters()])
    ref = np.concatenate([want[n].numpy().ravel() for n, _ in model.named_parameters()])
    loss_bound, grad_bound = (FP32_STEP_REL,) * 2 if dtype is None else (LOSS_REL, GRAD_REL_L2)
    assert abs(loss.item() - j_loss) / abs(j_loss) < loss_bound
    assert _rel_l2(got, ref) < grad_bound


# ---- "wgrad": the filter gradient on the library ---------------------------


@pytest.mark.parametrize("c", [1, 4, 16, 32])
def test_library_wgrad_matches_jax_conv_dk(monkeypatch, c):
    """bf16 operands, fp32 sums rounded once to bf16: each element within
    2^-8 of the JAX ``_conv_dk``'s fp32 value, plus 1e-5 of the largest for
    the sums' order. K6 is not called; the data gradient is K1's, bitwise
    the default route's."""
    rng = np.random.default_rng(c)
    x = rng.normal(size=(B, D, S, S, c)).astype(np.float32)
    kern = (0.2 * rng.normal(size=(3, 3, 3, c, 16))).astype(np.float32)
    g = rng.normal(size=(B, D, S, S, 16)).astype(np.float32)
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    want = _tw(jconv3d._conv_dk(xb, gb, jnp.bfloat16)).numpy()

    k1 = _counter(monkeypatch, conv_of, "conv3x3x3_of")
    k6 = _counter(monkeypatch, conv_of, "conv3x3x3_wgrad_of")
    grads = {}
    for route, parts in (("of", ()), ("xla", ("wgrad",))):
        k1.clear()
        k6.clear()
        xt = _t(x).bfloat16().requires_grad_()
        wt = _tw(kern).bfloat16().requires_grad_()
        with chip_smoke.library_route(parts):
            conv3d.conv3x3x3(xt, wt).backward(_t(g).bfloat16())
        assert (len(k1), len(k6)) == (2, 1 if route == "of" else 0)
        assert wt.grad.dtype == torch.bfloat16
        grads[route] = xt.grad, wt.grad
    torch.testing.assert_close(grads["xla"][0], grads["of"][0], rtol=0, atol=0)
    got = grads["xla"][1].float().numpy()
    assert np.all(np.abs(got - want) <= 2.0**-8 * np.abs(want) + 1e-5 * np.abs(want).max())


# ---- "loss": the plain DiceCE ----------------------------------------------


class _Logits(torch.nn.Module):
    """A 'model' whose output is its one parameter: the loss's dlogits are
    that parameter's gradient."""

    def __init__(self, logits: torch.Tensor) -> None:
        super().__init__()
        self.logits = torch.nn.Parameter(logits)

    def forward(self, image, return_encoder_features: bool):
        return self.logits


@pytest.mark.parametrize("fused", ["1", "0"])
def test_plain_loss_route_matches_jax_dice_ce(monkeypatch, fused):
    """The CT loss on K7/K8 ("1") and on the plain DiceCE (the library
    route's "loss": the JAX ``MEDSEG_FUSED_LOSS=0``), each against the JAX
    ``dice_ce_loss``."""
    k78 = _counter(monkeypatch, ttrain, "dice_ce_fused")
    plain = _counter(monkeypatch, ttrain, "dice_ce_loss")
    rng = np.random.default_rng(5)
    logits = (2.0 * rng.normal(size=(2, 8, 8, 9, 4))).astype(np.float32)
    label = rng.integers(0, 4, size=(2, 8, 8, 9)).astype(np.int32)
    want, dwant = jax.value_and_grad(
        lambda z: j_dice_ce(z, jnp.asarray(label), softmax=True, to_onehot_y=True)
    )(jnp.asarray(logits))
    model = _Logits(_t(logits))
    with chip_smoke.library_route(("loss",) if fused == "0" else ()):
        loss = ttrain.make_loss_fn("ct")(model, None, torch.from_numpy(label))
    loss.backward()
    assert (len(k78), len(plain)) == ((1, 0) if fused == "1" else (0, 1))
    assert abs(loss.item() - float(want)) / abs(float(want)) < FP32_REL
    assert _rel_l2(np.moveaxis(model.logits.grad.numpy(), 1, -1), dwant) < FP32_REL


@pytest.mark.parametrize("parts", [("convs",), ("wgrad",), ("loss",), ("convs", "wgrad", "loss")],
                         ids="+".join)
def test_library_route_is_undone_after_its_block(parts):
    """Every patched name is the port's own again once the block ends, also
    when the block raises."""
    names = {"convs": (conv3d, "OF_MIN_HW"), "wgrad": (conv_of, "conv3x3x3_wgrad_of"),
             "loss": (ttrain, "fused_loss_supported")}
    before = {part: getattr(*names[part]) for part in names}
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke.library_route(parts):
            for part in names:
                assert (getattr(*names[part]) is before[part]) == (part not in parts), part
            raise RuntimeError("inside")
    assert all(getattr(*names[part]) is before[part] for part in names)


# ---- the tanh GELU ---------------------------------------------------------


@contextlib.contextmanager
def tanh_gelu(model):
    """The ViT's MLPs on the tanh GELU within the block (the JAX package's
    serving ``gelu_approx``, which it takes on a TPU backend only); exact
    again after."""
    mlps = [block.mlp for block in model.vit.blocks]
    saved = [mlp.approximate for mlp in mlps]
    try:
        for mlp in mlps:
            mlp.approximate = "tanh"
        yield
    finally:
        for mlp, approximate in zip(mlps, saved):
            mlp.approximate = approximate


@pytest.fixture(scope="module")
def pair():
    """flax params of a small UNETR (feature size 8, crop 32) and the port
    model at them."""
    jmodel = JUNETR(in_channels=1, **SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 32, 1)))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        x = rng.normal(size=s.shape)
        if path[-1].key == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        else:
            x = (1.0 if path[-1].key == "scale" else 0.0) + 0.1 * x
        return x.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tmodel = UNETR(in_channels=1, **SMALL).eval()
    tmodel.load_state_dict(state_dict_from_flax(params))
    x = rng.normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
    return jmodel, params, tmodel, x


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "exact"])
def test_lowres_stages_match_jax_xla_stages(pair, gelu_approx):
    jmodel, params, tmodel, x = pair
    want = juo._xla_stages(jmodel, params["params"], jnp.asarray(x), gelu_approx=gelu_approx)
    with torch.no_grad():
        with tanh_gelu(tmodel):
            tanh = tuo._lowres_stages(tmodel, _t(x))
        exact = tuo._lowres_stages(tmodel, _t(x))
    got, other = (tanh, exact) if gelu_approx else (exact, tanh)
    for g, o, w in zip(got, other, want):
        w = np.asarray(w)
        assert _rel_l2(np.moveaxis(g.numpy(), 1, -1), w) < FP32_REL
        # the other GELU is well outside that tolerance (7.6e-5 and 2.0e-4
        # here, the match within 1.7e-6): the test tells them apart
        assert _rel_l2(np.moveaxis(o.numpy(), 1, -1), w) > 5 * FP32_REL
    assert all(block.mlp.approximate == "none" for block in tmodel.vit.blocks)
