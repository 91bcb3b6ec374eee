"""The weight bridge (JAX package params -> the port's ``state_dict``), the
train-state ``CheckpointManager`` and the load of a reference ``.pth``.

``state_dict_from_flax`` maps the flax parameter tree of
``medseg.models.unetr.UNETR`` (a nested dict of arrays) onto the MONAI-0.6
key schema that ``medseg.engine.checkpoint.convert_torch_state_dict`` parses
and that ``medseg_torch.models.unetr.UNETR`` carries, so
``convert_torch_state_dict(state_dict_from_flax(p))`` gives ``p`` back. The
array transforms invert that module's ``_conv_kernel`` / ``_convt_kernel`` /
``_linear_kernel``.

``load_torch_checkpoint`` loads a MONAI-schema ``.pth``/``.pt`` (or the best
model of a ``CheckpointManager`` directory) into a port model with the JAX
package's rules (``convert_torch_state_dict`` +
``merge_params``): a key the schema does not know raises, a key the file
lacks keeps the model's value, a shape that differs raises.
"""

from __future__ import annotations

import json
import os
import re
import shutil
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


MODEL_FILE = "model.pt"  # the model's state_dict, loadable on its own
TRAIN_FILE = "train.pt"  # the optimizer's state_dict, the step, the generator's state


class CheckpointManager:
    """Best/latest checkpoints of the full train state (counterpart of the
    JAX package's orbax ``CheckpointManager``).

    A checkpoint ``name`` is a directory ``<directory>/<name>/`` of two
    ``torch.save`` files: ``model.pt`` (the model's ``state_dict``, a
    MONAI-schema state_dict that ``load_torch_checkpoint`` reads) and
    ``train.pt`` (the optimizer's ``state_dict``, the step, the generator's
    state). Saves are synchronous: each is written beside the old one and
    renamed over it, so a crash leaves the old or the new checkpoint, never
    half of one. A "best" save writes the ``meta.json`` sidecar (the step and
    the metrics) after its files are in place. ``restore`` loads into the
    given state in place and returns it.
    """

    def __init__(self, directory: str) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _meta_path(self) -> str:
        return os.path.join(self.directory, "meta.json")

    def save(self, state, *, metrics: dict[str, float] | None = None, name: str = "best",
             block: bool = False) -> str:
        """Save the full train state under ``name``. ``block`` is accepted for
        the JAX signature: every save has committed when this returns."""
        path = os.path.join(self.directory, name)
        tmp = f"{path}.tmp-{os.getpid()}"
        old = f"{path}.old-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save(state.model.state_dict(), os.path.join(tmp, MODEL_FILE))
        torch.save({"optimizer": state.optimizer.state_dict(), "step": int(state.step),
                    "generator": state.generator.get_state()}, os.path.join(tmp, TRAIN_FILE))
        if os.path.isdir(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        if name == "best":  # the sidecar tracks the best checkpoint only
            meta = {"step": int(state.step)}
            if metrics:
                meta.update({k: float(v) for k, v in metrics.items()})
            with open(self._meta_path(), "w") as f:
                json.dump(meta, f)
        return path

    def exists(self, name: str = "best") -> bool:
        return os.path.exists(os.path.join(self.directory, name, TRAIN_FILE))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def _train(self, name: str) -> dict:
        return torch.load(os.path.join(self.directory, name, TRAIN_FILE), map_location="cpu")

    def restore(self, state, *, name: str = "best"):
        """Load the checkpoint into ``state`` (the same model and optimizer)."""
        path = os.path.join(self.directory, name)
        state.model.load_state_dict(torch.load(os.path.join(path, MODEL_FILE), map_location="cpu"))
        train = self._train(name)
        state.optimizer.load_state_dict(train["optimizer"])
        state.step = int(train["step"])
        state.generator.set_state(train["generator"])
        return state

    def restore_freshest(self, state, *, prefer: str = "latest"):
        """Restore whichever of "latest"/"best" has the greater step; ties go
        to ``prefer`` (a crash after a scheduled "latest" save resumes from
        it, not from an older best)."""
        have = [n for n in ("best", "latest") if self.exists(n)]
        if not have:
            return state
        if len(have) == 1:
            return self.restore(state, name=have[0])
        steps = {n: int(self._train(n)["step"]) for n in have}
        if steps["latest"] == steps["best"]:
            return self.restore(state, name=prefer)
        return self.restore(state, name=max(steps, key=steps.get))

    def metadata(self) -> dict:
        if not os.path.exists(self._meta_path()):
            return {}
        with open(self._meta_path()) as f:
            return json.load(f)


def load_torch_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.pth``/``.pt`` state_dict, or the "best" model of a
    directory written by ``CheckpointManager``, into ``model`` in place and
    return it. Any other directory (an orbax checkpoint of the JAX package)
    raises NotImplementedError."""
    if os.path.isdir(path):
        best = os.path.join(path, "best", MODEL_FILE)
        if not os.path.exists(best):
            raise NotImplementedError(
                f"{path} is not a checkpoint directory of medseg_torch's CheckpointManager "
                f"(no best/{MODEL_FILE}); orbax checkpoints of the JAX package are outside "
                "the port's scope: convert the weights to a .pth state_dict (the weight "
                "bridge, engine.checkpoint.state_dict_from_flax) and pass that file"
            )
        path = best
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
