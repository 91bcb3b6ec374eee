"""Training state: the model, its AdamW optimizer, the step and a generator
(counterpart of ``medseg/engine/state.py``).

The JAX package keeps params, optimizer state, step and PRNG key in one
pytree; here the module owns its parameters and ``torch.optim.AdamW`` its
moments, and the state bundles them with the step count and a seeded
``torch.Generator`` (the stream the weights were drawn from, continued).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.models.unetr import init_weights


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def adamw(params, learning_rate: float, weight_decay: float) -> torch.optim.AdamW:
    """The reference optimizer (lr from the CLI, weight decay 1e-5). optax's
    ``adamw`` computes the same update: decoupled decay on the pre-update
    parameter scaled by the learning rate, bias-corrected moments, eps
    outside the square root."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def fill_missing_gradients(model: nn.Module) -> None:
    """A zero gradient for every parameter that no gradient reached (run
    before a data-parallel all-reduce too, so that every rank reduces every
    parameter's gradient)."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def apply_gradients(state: TrainState) -> TrainState:
    """One optimizer step over every parameter, as optax updates every leaf:
    a parameter that no gradient reached (the decoder in the feat stage, the
    frozen encoder in the recon stage) steps on a zero gradient, so weight
    decay and the moments carried from earlier steps still move it, and every
    parameter's step count advances with the state's. ``torch.optim.AdamW``
    would skip a parameter whose ``.grad`` is None."""
    fill_missing_gradients(state.model)
    state.optimizer.step()
    state.step += 1
    return state


def create_train_state(
    model: nn.Module,
    *,
    generator: torch.Generator,
    learning_rate: float,
    weight_decay: float,
    device: torch.device | str,
    params: Any | None = None,
) -> TrainState:
    """Weights from ``params`` (a flax ``UNETR`` tree, through
    ``state_dict_from_flax``) or, when None, drawn from ``generator``
    (``init_weights``); the model moves to ``device`` in train mode."""
    if params is None:
        init_weights(model, generator)
    else:
        model.load_state_dict(state_dict_from_flax(params))
    model.to(device).train()
    return TrainState(
        model=model,
        optimizer=adamw(model.parameters(), learning_rate, weight_decay),
        step=0,
        generator=generator,
    )
