"""The weight bridge: flax params -> port ``state_dict`` -> flax params.

``state_dict_from_flax`` must be inverted exactly by the JAX package's own
``convert_torch_state_dict`` + ``merge_params``, and its keys and shapes
must be those of the port's ``UNETR`` (strict load). The flax tree is the
structure ``UNETR.init`` produces (``jax.eval_shape``), filled with seeded
numpy values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.engine.checkpoint import convert_torch_state_dict, merge_params
from medseg.models.unetr import UNETR
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.models import unetr as tunetr

SMALL = dict(out_channels=3, img_size=(32, 32, 32), feature_size=8, hidden_size=24,
             mlp_dim=48, num_heads=4, num_layers=4, patch_size=16)


def _flax_params(c_in, pos_embed, seed=0):
    model = UNETR(in_channels=c_in, pos_embed=pos_embed, **SMALL)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 32, c_in)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _leaves(tree):
    return {
        jax.tree_util.keystr(path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("c_in,pos_embed", [(1, "perceptron"), (4, "perceptron"), (1, "conv")])
def test_flax_roundtrip_is_exact(c_in, pos_embed):
    params = _flax_params(c_in, pos_embed)
    sd = state_dict_from_flax(params)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    back = merge_params(zeros, convert_torch_state_dict(sd))
    want, got = _leaves(params), _leaves(back)
    assert want.keys() == got.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    # every flax leaf has a torch key, and the port model takes them all
    assert len(sd) == len(want)
    model = tunetr.UNETR(in_channels=c_in, pos_embed=pos_embed, **SMALL)
    model.load_state_dict(sd, strict=True)


def test_port_parameter_set_equals_flax():
    """The port's own parameters, read by the JAX converter, form exactly
    the flax ``UNETR.init`` tree (names and shapes)."""
    model = tunetr.init_weights(tunetr.UNETR(in_channels=4, **SMALL), torch.Generator().manual_seed(0))
    converted = convert_torch_state_dict(model.state_dict())
    shapes = jax.eval_shape(
        UNETR(in_channels=4, **SMALL).init, jax.random.key(0), jnp.zeros((1, 32, 32, 32, 4))
    )
    want = {k: tuple(v.shape) for k, v in _leaves(shapes).items()}
    got = {k: tuple(v.shape) for k, v in _leaves(converted).items()}
    assert got == want


def test_unknown_flax_parameter_raises():
    params = _flax_params(1, "perceptron")
    params["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra/kernel"):
        state_dict_from_flax(params)
