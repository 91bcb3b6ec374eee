"""Ranking self-supervised pretraining engine (counterpart of
``medseg/engine/pretrain.py``).

Per step, as the reference does: forward a batch of 4 (2 volumes x 2
crops), take the enc4 features ("feat" stage) or the decoder logits under a
frozen encoder ("recon" stage), gather the slices of one axis, build the
cosine matrix, apply the ranking (Bradley-Terry) or contrastive (InfoNCE)
loss, backward, AdamW over every parameter. Slice indices are drawn on the
host (one shared random offset per partition) and passed to the device as a
tensor; the step returns the loss as a device tensor, so the only sync per
step is the caller's ``float(loss)``.

The feat stage computes only what enc4 needs (``UNETR.encoder4_features``):
the JAX step's jitted program drops the decoder, the later ViT blocks and
the final norm, which its loss does not read; run eagerly, the port would
otherwise compute the full-resolution decoder for nothing. The parameters
it skips get zero gradients, as they do in JAX.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from medseg_torch.engine.state import TrainState, apply_gradients
from medseg_torch.ops.ranking import (
    bt_ranking_loss,
    gather_partition_slices,
    info_nce_loss,
    pairwise_channel_cosine,
    sample_partition_indices,
)

STAGES = ("feat", "recon")
LOSSES = ("ranking", "contrastive")


def make_pretrain_loss(
    model, *, update_arc: str, loss_type: str, num_partitions: int, temperature: float
) -> Callable:
    """``loss_fn(images, slice_indices, axis)`` -> the stage's scalar fp32
    loss on a (4, C, D, H, W) batch, indices on the batch's device."""
    if update_arc not in STAGES:
        raise ValueError(f"update_arc {update_arc!r} is not one of {STAGES}")
    if loss_type not in LOSSES:
        raise ValueError(f"loss_type {loss_type!r} is not one of {LOSSES}")
    loss_impl = bt_ranking_loss if loss_type == "ranking" else info_nce_loss

    def loss_fn(images: torch.Tensor, slice_indices: torch.Tensor, axis: int) -> torch.Tensor:
        if update_arc == "feat":
            feats = model.encoder4_features(images)
        else:
            _, feats = model(images, freeze_encoder=True)
        slices = gather_partition_slices(feats, slice_indices, axis)
        return loss_impl(pairwise_channel_cosine(slices), num_partitions, temperature)

    return loss_fn


def make_pretrain_step(
    model,
    *,
    update_arc: str,  # "feat" | "recon"
    loss_type: str,  # "ranking" | "contrastive"
    num_partitions: int,
    temperature: float,
) -> Callable:
    """``state, loss = step(state, images, slice_indices, axis=a)`` updates
    ``state`` in place (parameters, moments, step) and returns the loss as a
    device tensor, not synced. ``images`` (4, C, D, H, W) and the (P,)
    indices (numpy or tensors) are moved to the model's device."""
    loss_fn = make_pretrain_loss(model, update_arc=update_arc, loss_type=loss_type,
                                 num_partitions=num_partitions, temperature=temperature)

    def step(state: TrainState, images, slice_indices, *, axis: int):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step was made for")
        device = next(model.parameters()).device
        images = torch.as_tensor(images).to(device, non_blocking=True)
        idx = torch.as_tensor(slice_indices, dtype=torch.int64).to(device, non_blocking=True)
        loss = loss_fn(images, idx, axis)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return apply_gradients(state), loss.detach()

    return step


def feature_dim_for_axis(
    crop_size: int, update_arc: str, axis: int, patch_size: int = 16
) -> int:
    """Extent of the sliced axis: enc4 is at 1/8 resolution, the decoder
    logits at full resolution."""
    return crop_size // 8 if update_arc == "feat" else crop_size


class ConvergenceTracker:
    """The reference's convergence rule: stop when |mean(last-10 epoch
    losses) - latest| < rtol * mean, or at ``max_iterations``."""

    def __init__(self, rtol: float = 1e-2, window: int = 10, max_iterations: int = 250):
        self.rtol = rtol
        self.window = window
        self.max_iterations = max_iterations
        self.losses: list[float] = []
        self.iterations = 0

    def update(self, epoch_loss: float) -> None:
        self.losses.append(float(epoch_loss))
        self.iterations += 1

    @property
    def converged(self) -> bool:
        if self.iterations >= self.max_iterations:
            return True
        if len(self.losses) < self.window:
            return False
        recent = np.asarray(self.losses[-self.window :])
        mean = float(recent.mean())
        if mean == 0.0:
            return True
        return abs(mean - self.losses[-1]) < self.rtol * abs(mean)


def pretrain_epoch(
    step_fn: Callable,
    state: TrainState,
    batches,
    *,
    update_arc: str,
    crop_size: int,
    num_partitions: int,
    rng: np.random.Generator,
    axes: tuple[int, ...] = (0, 1, 2),
) -> tuple[TrainState, float]:
    """One pass over ``batches(axis)`` per slicing axis (the reference
    cycles spatial axes 0/1/2). Returns the state and the mean of the
    per-axis mean losses."""
    epoch_losses = []
    for axis in axes:
        dim = feature_dim_for_axis(crop_size, update_arc, axis)
        axis_loss, n = 0.0, 0
        for batch in batches(axis):
            images = batch["image"]
            if images.shape[0] != 4:
                continue  # the reference's guard: a crop pair of a volume pair
            idx = sample_partition_indices(rng, dim, num_partitions)
            state, loss = step_fn(state, images, idx, axis=axis)
            axis_loss += float(loss)
            n += 1
        if n:
            epoch_losses.append(axis_loss / n)
    return state, float(np.mean(epoch_losses)) if epoch_losses else 0.0
