"""The weight bridge (JAX package params -> the port's ``state_dict``) and
the load of a reference ``.pth``.

``state_dict_from_flax`` maps the flax parameter tree of
``medseg.models.unetr.UNETR`` (a nested dict of arrays) onto the MONAI-0.6
key schema that ``medseg.engine.checkpoint.convert_torch_state_dict`` parses
and that ``medseg_torch.models.unetr.UNETR`` carries, so
``convert_torch_state_dict(state_dict_from_flax(p))`` gives ``p`` back. The
array transforms invert that module's ``_conv_kernel`` / ``_convt_kernel`` /
``_linear_kernel``.

``load_torch_checkpoint`` loads a MONAI-schema ``.pth``/``.pt`` into a port
model with the JAX package's rules (``convert_torch_state_dict`` +
``merge_params``): a key the schema does not know raises, a key the file
lacks keeps the model's value, a shape that differs raises.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

# (flax path regex, torch key template); matched against "/".join(path)
_KEY_RULES = [
    (r"vit/patch_embedding/proj/(kernel|bias)", "vit.patch_embedding.patch_embeddings.1.{0}"),
    (r"vit/patch_embedding/proj_conv/(kernel|bias)", "vit.patch_embedding.patch_embeddings.{0}"),
    (r"vit/patch_embedding/pos_embedding", "vit.patch_embedding.position_embeddings"),
    (r"vit/block_(\d+)/(norm[12])/(scale|bias)", "vit.blocks.{0}.{1}.{2}"),
    (r"vit/block_(\d+)/attn/(qkv|out_proj)/(kernel|bias)", "vit.blocks.{0}.attn.{1}.{2}"),
    (r"vit/block_(\d+)/mlp/fc([12])/(kernel|bias)", "vit.blocks.{0}.mlp.linear{1}.{2}"),
    (r"vit/norm/(scale|bias)", "vit.norm.{0}"),
    (r"encoder1/layer/(conv[123])/conv/(kernel|bias)", "encoder1.layer.{0}.conv.{1}"),
    (r"encoder1/layer/(norm[123])/(scale|bias)", "encoder1.layer.{0}.{1}"),
    (r"encoder([234])/transp_conv_init/convt/(kernel|bias)", "encoder{0}.transp_conv_init.conv.{1}"),
    (r"encoder([234])/transp_(\d+)/convt/(kernel|bias)", "encoder{0}.blocks.{1}.conv.{2}"),
    (r"decoder([2345])/transp_conv/convt/(kernel|bias)", "decoder{0}.transp_conv.conv.{1}"),
    (r"decoder([2345])/conv_block/(conv[123])/conv/(kernel|bias)", "decoder{0}.conv_block.{1}.conv.{2}"),
    (r"decoder([2345])/conv_block/(norm[123])/(scale|bias)", "decoder{0}.conv_block.{1}.{2}"),
    (r"out/conv/(kernel|bias)", "out.conv.conv.{0}"),
]
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_key(path: str) -> str:
    for pattern, template in _KEY_RULES:
        m = re.fullmatch(pattern, path)
        if m:
            groups = [_LEAF_NAMES.get(g, g) for g in m.groups()]
            return template.format(*groups)
    raise KeyError(f"flax parameter {path!r} has no counterpart in the port")


def _torch_value(path: str, v: np.ndarray) -> np.ndarray:
    if not path.endswith("kernel"):
        return v
    if v.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return v.T
    # flax conv (kd, kh, kw, in, out) -> torch Conv3d (out, in, kd, kh, kw);
    # flax transpose-conv (kd, kh, kw, out, in) -> torch ConvTranspose3d
    # (in, out, kd, kh, kw): the same axis permutation for both
    return np.transpose(v, (4, 3, 0, 1, 2))


def state_dict_from_flax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``UNETR`` params (``{"params": ...}`` or the inner tree, leaves
    numpy-convertible) -> the port ``UNETR``'s ``state_dict`` (fp32)."""
    tree = params.get("params", params)
    out = {}
    for path, leaf in _flatten(tree):
        p = "/".join(path)
        v = _torch_value(p, np.asarray(leaf, dtype=np.float32))
        out[_torch_key(p)] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def load_torch_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.pth``/``.pt`` state_dict into ``model`` in place and
    return it. A directory (an orbax checkpoint of the JAX package, or a
    train-state checkpoint) raises NotImplementedError."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a checkpoint directory; the port loads .pth/.pt state_dicts only "
            "(train-state and orbax checkpoints: ROADMAP.md Queue 1 item 7)"
        )
    state_dict = torch.load(path, map_location="cpu")
    own = model.state_dict()
    merged = dict(own)
    for key, value in state_dict.items():
        if key not in own:
            raise KeyError(f"unrecognized reference checkpoint key: {key}")
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch for {key}: model {tuple(own[key].shape)} vs "
                             f"checkpoint {tuple(value.shape)}")
        merged[key] = value.to(own[key].dtype)
    model.load_state_dict(merged)
    return model
