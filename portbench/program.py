"""The system under test, ``medseg_torch``, through its public entry points
only: the model module that the configuration's architecture file builds
(``architectures/<name>.py``: ``models.unetr.UNETR`` for "unetr"), and,
shared by every architecture, ``engine.evaluate.Validator``,
``ops.sliding_window.SlidingWindowSpec``, ``ops.post``, ``engine.train
.make_train_step`` and ``engine.state`` (``TrainState``, ``adamw``). It is
imported when a run starts, never when this module is imported."""

from __future__ import annotations

import torch

COMPUTE = {"bfloat16": torch.bfloat16, "float32": None}


def build_model(arch, config: dict, weights: dict, device, *, remat: bool):
    """The configuration's model, as its architecture ``arch`` builds it, on
    ``device`` holding ``weights`` (strict)."""
    with torch.device(device):
        model = arch.build(config["model"], COMPUTE[config["precision"]["compute"]], remat)
    model.load_state_dict(weights)
    return model


def validator(config: dict, model, device):
    """The serving entry point as the segmentation and serving CLIs build it."""
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.ops.sliding_window import SlidingWindowSpec

    s = config["serve"]
    spec = SlidingWindowSpec(roi=(s["roi"],) * 3, overlap=s["overlap"], sw_batch=s["sw_batch"],
                             mode=s["mode"], sigma_scale=s["sigma_scale"],
                             bucket_multiple=s["bucket_multiple"])
    return Validator(model, config["model"]["out_channels"], config["task"], spec,
                     use_fast_path=True, acc_dtype=s["accumulator"], device=device)


def label_map_fn(config: dict):
    """The serving CLI's post: the mask to a label map (CT argmax, BraTS
    channels to labels)."""
    from medseg_torch.ops.post import multichannel_to_label_map

    if config["task"] == "ct":
        return lambda mask: mask.argmax(dim=-1)
    return multichannel_to_label_map


def train_state(config: dict, model, seed: int):
    from medseg_torch.engine.state import TrainState, adamw

    t = config["train"]
    optimizer = adamw(model.parameters(), t["learning_rate"], t["weight_decay"])
    group = optimizer.param_groups[0]
    if tuple(group["betas"]) != tuple(t["betas"]) or group["eps"] != t["eps"]:
        raise ValueError(f"the program's AdamW has betas {group['betas']} and eps {group['eps']}, "
                         f"the configuration {t['betas']} and {t['eps']}")
    return TrainState(model=model, optimizer=optimizer, step=0,
                      generator=torch.Generator().manual_seed(seed))


def train_step(config: dict, model):
    from medseg_torch.engine.train import make_train_step

    return make_train_step(model, task=config["task"],
                           device_augment=config["train"]["device_augment"])
