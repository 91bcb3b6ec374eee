"""The port's fused serving forward (kernels' plain versions on CPU) against
the JAX package's ``fast_apply_v3`` in interpret mode and against the flax
forward, at the same weights.

Small size (feature size 8, crop 32); fp32; tolerance 2e-3 as in
``tests/test_conv_of.py``. Both residual forms of encoder1 are covered:
C_in=1 (conv3 folded into an affine of x) and C_in=4 (conv3 from conv1's
residual tap); C_in == feature_size routes to the plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels.unetr_of import fast_apply_v3 as jax_fast_apply_v3
from medseg.models.unetr import UNETR
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.kernels import unetr_of as tuo
from medseg_torch.models import unetr as tunetr

TOL = dict(rtol=2e-3, atol=2e-3)
FS, CROP, K = 8, 32, 3
SMALL = dict(out_channels=K, img_size=(CROP,) * 3, feature_size=FS, hidden_size=24, mlp_dim=48,
             num_heads=4, num_layers=4, patch_size=16)


def _pair(c_in, seed=0, res_block=True):
    """flax params with non-zero conv biases (they cancel under instance
    norm, which the fused chain relies on) and the port model at them."""
    jmodel = UNETR(in_channels=c_in, res_block=res_block, **SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, CROP, CROP, CROP, c_in)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.normal(size=s.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tmodel = tunetr.UNETR(in_channels=c_in, res_block=res_block, **SMALL).eval()
    tmodel.load_state_dict(state_dict_from_flax(params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def pairs():
    return {c: _pair(c) for c in (1, 4)}


def _inputs(c_in, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, CROP, CROP, CROP, c_in)).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, size=(2, CROP, CROP, CROP, 1)).astype(np.float32)
    return x, scale


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def _port(tmodel, x, scale):
    got = tuo.fast_apply_v3(tmodel, _ncdhw(x), tuo.fused_weights(tmodel),
                            out_scale=None if scale is None else _ncdhw(scale))
    assert got.shape == (x.shape[0], 8, CROP, CROP, CROP) and got.dtype == torch.float32
    return got[:, :K].numpy().transpose(0, 2, 3, 4, 1)


@pytest.mark.parametrize("c_in", [1, 4])
@pytest.mark.parametrize("scaled", [False, True], ids=["logits", "weighted"])
def test_fused_forward_matches_pallas_chain(pairs, c_in, scaled):
    jmodel, params, tmodel = pairs[c_in]
    x, scale = _inputs(c_in)
    scale = scale if scaled else None
    ref = jax_fast_apply_v3(
        jmodel, params, jnp.asarray(x), interpret=True,
        out_scale=None if scale is None else jnp.asarray(scale),
    )
    np.testing.assert_allclose(_port(tmodel, x, scale), np.asarray(ref), **TOL)


@pytest.mark.parametrize("c_in", [1, 4])
def test_fused_forward_matches_flax(pairs, c_in):
    jmodel, params, tmodel = pairs[c_in]
    x, scale = _inputs(c_in, seed=2)
    ref = jmodel.apply(params, jnp.asarray(x), return_encoder_features=False)
    np.testing.assert_allclose(_port(tmodel, x, None), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_port(tmodel, x, scale), np.asarray(ref) * scale, **TOL)


def test_bf16_chain_stays_near_fp32(pairs):
    """bf16 operands, fp32 sums: the relative L2 error of the logits is
    bounded (argmax agreement is not, on random weights)."""
    jmodel, params, tmodel = pairs[1]
    x, _ = _inputs(1, seed=3)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), return_encoder_features=False))
    tmodel.dtype = torch.bfloat16
    try:
        got = tuo.fast_apply_v3(tmodel, _ncdhw(x), tuo.fused_weights(tmodel))
    finally:
        tmodel.dtype = None
    assert got.dtype == torch.bfloat16
    got = got[:, :K].float().numpy().transpose(0, 2, 3, 4, 1)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 3e-2


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_weights_cast_once_and_pad_the_head(pairs, dtype):
    """``fused_weights``: the chain's conv and transpose-conv parameters in
    the compute dtype, equal to the module's after the cast; the out head
    padded to K_pad rows with zero weights and bias, its bias in fp32."""
    _, _, tmodel = pairs[4]
    tmodel.dtype = dtype
    try:
        w = tuo.fused_weights(tmodel)
    finally:
        tmodel.dtype = None
    want = dtype or torch.float32
    params = dict(tmodel.named_parameters())
    for name in ("encoder1.layer.conv1.conv.weight", "encoder1.layer.conv3.conv.weight",
                 "decoder3.conv_block.conv1.conv.weight", "decoder2.transp_conv.conv.bias"):
        assert w[name].dtype == want and w[name].is_contiguous()
        torch.testing.assert_close(w[name], params[name].to(want), rtol=0, atol=0)
    assert not any(".norm" in name for name in w)
    assert w["out.weight"].shape == (8, FS) and w["out.weight"].dtype == want
    assert w["out.bias"].shape == (8,) and w["out.bias"].dtype == torch.float32
    assert (w["out.weight"][K:] == 0).all() and (w["out.bias"][K:] == 0).all()


@pytest.mark.parametrize("c_in,res_block", [(FS, True), (1, False)], ids=["cin_eq_fs", "basic"])
def test_cin_equal_feature_size_routes_to_plain_forward(c_in, res_block):
    """C_in == feature_size (the block has no conv3: the residual is x
    verbatim) and res_block=False (no residual) are shapes the fused chain
    cannot express: they route to the module forward (never an assert),
    padded to K_pad and weighted."""
    _, _, tmodel = _pair(c_in, seed=5, res_block=res_block)
    x, scale = _inputs(c_in, seed=4)
    assert not tuo._chain_correct(tmodel, _ncdhw(x).shape)
    with torch.no_grad():
        ref = tmodel(_ncdhw(x), return_encoder_features=False)
    got = tuo.fast_apply_v3(tmodel, _ncdhw(x), tuo.fused_weights(tmodel), out_scale=_ncdhw(scale))
    assert got.shape == (2, 8, CROP, CROP, CROP) and got.dtype == torch.float32
    torch.testing.assert_close(got[:, :K], ref * _ncdhw(scale), rtol=0, atol=0)
    assert (got[:, K:] == 0).all()
