"""The port's ViT, blocks and UNETR against the flax modules at the same
weights (moved across by ``state_dict_from_flax``).

Small size (hidden 24, MLP 48, 4 heads, 4 layers, feature size 8, crop 32),
seeded numpy params and inputs, tolerance 5e-4 as in
``tests/test_model_parity_torch.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.models import blocks as jblocks
from medseg.models.unetr import UNETR
from medseg.models.vit import ViT3D
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.models import unetr as tunetr

TOL = dict(rtol=5e-4, atol=5e-4)
HID, MLP, HEADS, LAYERS, FS, CROP = 24, 48, 4, 4, 8, 32
SMALL = dict(out_channels=3, img_size=(CROP,) * 3, feature_size=FS, hidden_size=HID,
             mlp_dim=MLP, num_heads=HEADS, num_layers=LAYERS, patch_size=16)


def _fill(shapes, rng):
    """Seeded params of the flax tree's structure: kernels at 1/sqrt(fan_in),
    non-zero biases and norm affines (so a dropped bias would show)."""

    def leaf(path, s):
        name = path[-1].key
        x = rng.normal(size=s.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "pos_embedding":
            x = 0.02 * x
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(c_in, pos_embed="perceptron", seed=0, res_block=True):
    jmodel = UNETR(in_channels=c_in, pos_embed=pos_embed, res_block=res_block, **SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, CROP, CROP, CROP, c_in)))
    params = _fill(shapes, np.random.default_rng(seed))
    tmodel = tunetr.UNETR(
        in_channels=c_in, pos_embed=pos_embed, res_block=res_block, **SMALL
    ).eval()
    tmodel.load_state_dict(state_dict_from_flax(params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def pairs():
    return {c: _pair(c) for c in (1, 4)}


def _ndhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 4, 1)


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def _input(c_in, seed=1, b=2, s=CROP):
    return np.random.default_rng(seed).normal(size=(b, s, s, s, c_in)).astype(np.float32)


@pytest.mark.parametrize("c_in", [1, 4])
def test_unetr_matches_flax(pairs, c_in):
    jmodel, params, tmodel = pairs[c_in]
    x = _input(c_in)
    enc4_j, logits_j = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        enc4_t, logits_t = tmodel(_ncdhw(x))
    np.testing.assert_allclose(_ndhwc(logits_t), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(_ndhwc(enc4_t), np.asarray(enc4_j), **TOL)


@pytest.mark.parametrize("variant", [{"pos_embed": "conv"}, {"res_block": False}],
                         ids=["conv_patch_embedding", "basic_blocks"])
def test_unetr_variants_match_flax(variant):
    jmodel, params, tmodel = _pair(1, seed=3, **variant)
    x = _input(1)
    ref = jmodel.apply(params, jnp.asarray(x), return_encoder_features=False)
    with torch.no_grad():
        got = tmodel(_ncdhw(x), return_encoder_features=False)
    np.testing.assert_allclose(_ndhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("gelu_approx", [False, True])
def test_vit_matches_flax(pairs, gelu_approx):
    _, params, tmodel = pairs[4]
    vit = ViT3D(hidden_size=HID, mlp_dim=MLP, num_layers=LAYERS, num_heads=HEADS,
                patch_size=16, gelu_approx=gelu_approx)
    x = _input(4, seed=2)
    out_j, hidden_j = vit.apply({"params": params["params"]["vit"]}, jnp.asarray(x))
    tvit = tmodel.vit
    for blk in tvit.blocks:
        blk.mlp.approximate = "tanh" if gelu_approx else "none"
    try:
        with torch.no_grad():
            out_t, hidden_t = tvit(_ncdhw(x))
    finally:
        for blk in tvit.blocks:
            blk.mlp.approximate = "none"
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    assert len(hidden_t) == len(hidden_j) == LAYERS
    for ht, hj in zip(hidden_t, hidden_j):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


@pytest.mark.parametrize("block", ["encoder1", "encoder2", "decoder5", "decoder2", "out"])
def test_blocks_match_flax(pairs, block):
    _, params, tmodel = pairs[1]
    p = {"params": params["params"][block]}
    rng = np.random.default_rng(4)
    g = CROP // 16
    if block == "encoder1":
        jmod, inputs = jblocks.UnetrBasicBlock(FS), [(2, CROP, CROP, CROP, 1)]
    elif block == "encoder2":
        jmod, inputs = jblocks.UnetrPrUpBlock(FS * 2, num_layer=2), [(2, g, g, g, HID)]
    elif block == "decoder5":
        jmod, inputs = jblocks.UnetrUpBlock(FS * 8), [(2, g, g, g, HID), (2, 2 * g, 2 * g, 2 * g, FS * 8)]
    elif block == "decoder2":
        jmod, inputs = jblocks.UnetrUpBlock(FS), [(2, CROP // 2, CROP // 2, CROP // 2, 2 * FS),
                                                  (2, CROP, CROP, CROP, FS)]
    else:
        jmod, inputs = jblocks.UnetOutBlock(3), [(2, CROP, CROP, CROP, FS)]
    xs = [rng.normal(size=shape).astype(np.float32) for shape in inputs]
    ref = jmod.apply(p, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = getattr(tmodel, block)(*map(_ncdhw, xs))
    np.testing.assert_allclose(_ndhwc(got), np.asarray(ref), **TOL)


def test_return_encoder_features_option(pairs):
    _, _, tmodel = pairs[1]
    x = _ncdhw(_input(1))
    with torch.no_grad():
        enc4, logits = tmodel(x)
        only = tmodel(x, return_encoder_features=False)
    torch.testing.assert_close(only, logits, rtol=0, atol=0)
    assert enc4.shape == (2, FS * 8, 4, 4, 4)


def test_constructor_errors_match_reference():
    with pytest.raises(KeyError):
        tunetr.UNETR(pos_embed="learnable", **SMALL)
    with pytest.raises(ValueError, match="norm_name"):
        tunetr.UNETR(norm_name="batch", **SMALL)
    with pytest.raises(ValueError, match="divisible"):
        tunetr.UNETR(**{**SMALL, "num_heads": 5})
    with pytest.raises(ValueError, match="dropout"):
        tunetr.UNETR(dropout_rate=1.5, **SMALL)
    with pytest.raises(NotImplementedError, match="conv_block"):
        tunetr.UNETR(conv_block=True, **SMALL)
