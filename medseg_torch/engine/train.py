"""Supervised training: the step and the loop with periodic validation
(counterpart of ``medseg/engine/train.py``).

Per step, as the reference ``train`` loop does: forward, DiceCE, backward,
AdamW update; every ``eval_num`` steps the loop validates and keeps the best
mean-Dice checkpoint. The loss is fp32 whatever the model's compute dtype.
On a CUDA device the CT loss runs through the fused DiceCE kernels (K7, K8)
and the routed 3x3x3 convs through K1 and K6; on the CPU their plain
versions run. With a data-parallel mesh (``medseg_torch.parallel``) each
rank steps on its rows of the global batch and the gradients are averaged
over the ranks before the update, as the JAX step over a mesh does.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator

import torch

from medseg_torch.engine.evaluate import Validator
from medseg_torch.engine.state import TrainState, apply_gradients, fill_missing_gradients
from medseg_torch.kernels.loss_of import dice_ce_fused, fused_loss_supported
from medseg_torch.ops.augment import augment_batch
from medseg_torch.ops.losses import dice_ce_loss
from medseg_torch.ops.sliding_window import SlidingWindowSpec
from medseg_torch.parallel.mesh import all_reduce_gradients
from medseg_torch.utils.profiling import span

TASKS = ("ct", "mri")


def make_loss_fn(task: str) -> Callable:
    """``loss_fn(model, image, label)`` -> scalar fp32 loss.

    ``task="ct"``: DiceCE(softmax, one-hot target) of int32 labels
    (B, D, H, W), through ``dice_ce_fused`` wherever ``fused_loss_supported``
    holds, on any device; ``task="mri"``: DiceCE(sigmoid, multi-channel
    target (B, C, D, H, W))."""
    if task not in TASKS:
        raise ValueError(f"task {task!r} is not one of {TASKS}")

    def loss_fn(model, image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        logits = model(image, return_encoder_features=False)
        if task == "mri":
            return dice_ce_loss(logits, label, sigmoid=True)
        if fused_loss_supported(logits.shape, task):
            return dice_ce_fused(logits, label)
        return dice_ce_loss(logits, label, softmax=True, to_onehot_y=True)

    return loss_fn


def make_train_step(
    model, *, task: str = "ct", device_augment: bool = False, mesh=None
) -> Callable[[TrainState, dict], tuple[TrainState, torch.Tensor]]:
    """The supervised step: ``state, loss = step(state, {"image": ...,
    "label": ...})`` updates ``state`` in place (the model's parameters, the
    optimizer's moments, the step) and returns the loss as a device tensor,
    not synced. Images are (B, C, D, H, W); CT labels are cast to int32 once
    here.

    ``device_augment=True`` runs the reference's random flip/rot90/intensity
    chain (``ops/augment.py``) on the batch on the device, inside the step,
    with per-sample decisions drawn on the host from ``state.generator``;
    use it with the host augmentations off
    (``pipelines.train_transforms(..., augment=False)``).

    ``mesh`` (a ``medseg_torch.parallel.Mesh``): the batch is this rank's
    rows of the global batch (equal on every rank); after ``backward`` the
    missing gradients are filled with zeros and every gradient is averaged
    over the ranks (``all_reduce_gradients``), so every rank applies the
    global batch's update to identical weights. The loss returned is this
    rank's. The augmentation draws the global batch's decisions and applies
    this rank's rows'."""
    loss_fn = make_loss_fn(task)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.data)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the train state holds another model than this step was made for")
        device = next(model.parameters()).device
        with span("medseg.train.upload"):
            image = torch.as_tensor(batch["image"]).to(device, non_blocking=True)
            label = torch.as_tensor(batch["label"]).to(device, non_blocking=True)
            if task == "ct":
                label = label.to(torch.int32)
        if device_augment:  # flips and rotations: the labels' dtype does not matter
            image, label = augment_batch(state.generator, image, label, rank=rank, world=world)
        with span("medseg.train.forward"):
            loss = loss_fn(model, image, label)
        with span("medseg.train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if mesh is not None:
            fill_missing_gradients(model)
            all_reduce_gradients(mesh, model)
        with span("medseg.train.optimizer"):
            state = apply_gradients(state)
        return state, loss.detach()

    return step


def make_validator(
    volumes: Callable[[], Iterable[dict]],
    n_classes: int,
    task: str,
    spec: SlidingWindowSpec,
    *,
    device: torch.device | str,
    mesh=None,
) -> Callable[[TrainState], float]:
    """``validator(state)`` -> mean Dice of the state's CURRENT weights over
    ``volumes()``. A ``Validator`` casts the kernels' weights once when it is
    built, so one is built per call; the model goes back to train mode
    afterwards. ``mesh``: the window grids sharded over its ranks, each of
    which validates the same volumes."""

    def validate(state: TrainState) -> float:
        try:
            validator = Validator(state.model, n_classes, task, spec, device=device, mesh=mesh)
            return validator(volumes()).mean_dice
        finally:
            state.model.train()

    return validate


class TrainLoop:
    """Step loop with periodic validation and best-checkpoint selection.

    Mirrors the reference training script: run until ``max_iterations`` steps,
    validating every ``eval_num`` steps, keeping the best mean-Dice
    checkpoint through ``checkpointer.save(state, metrics=...)``;
    ``save_latest_every`` also saves the full state as "latest"
    (``checkpointer.save(state, name="latest")``), and ``checkpointer.wait()``
    commits any in-flight save at the end.
    """

    def __init__(
        self,
        train_step: Callable,
        *,
        max_iterations: int,
        eval_num: int,
        validator: Callable[[TrainState], float] | None = None,
        checkpointer=None,
        log_fn: Callable[[str], None] = print,
        save_latest_every: int | None = None,
        sync_every: int = 1,
        progress: Callable[[int, int, float], None] | None = None,
    ) -> None:
        self.train_step = train_step
        self.max_iterations = max_iterations
        self.eval_num = eval_num
        self.validator = validator
        self.checkpointer = checkpointer
        self.log_fn = log_fn
        self.save_latest_every = save_latest_every
        # ``sync_every=1`` reads the loss back every step (the reference's
        # per-step timing); ``N > 1`` leaves N steps queued on the device so
        # that launches and host work overlap the device's.
        self.sync_every = max(1, int(sync_every))
        # live readout: progress(step, max_iterations, last_synced_loss)
        self.progress = progress
        self.loss_history: list[float] = []
        self.metric_history: list[float] = []
        self.best_metric: float = -1.0
        self.best_step: int = -1
        self.running_time: float = 0.0

    def run(self, state: TrainState, batches: Iterator[dict]) -> TrainState:
        global_step = int(state.step)
        pending: list[torch.Tensor] = []  # device losses not yet read back

        def drain() -> None:
            while pending:
                self.loss_history.append(pending.pop(0).item())

        while global_step < self.max_iterations:
            try:
                batch = next(batches)
            except StopIteration:
                break
            t0 = time.perf_counter()
            state, loss = self.train_step(state, batch)
            pending.append(loss)
            global_step += 1
            if (
                len(pending) >= self.sync_every
                or global_step == self.max_iterations
                or global_step % self.eval_num == 0
            ):
                drain()  # waits for the oldest queued step
            self.running_time += time.perf_counter() - t0
            if self.progress is not None:
                last = self.loss_history[-1] if self.loss_history else float("nan")
                self.progress(global_step, self.max_iterations, last)
            if (
                self.save_latest_every
                and self.checkpointer is not None
                and global_step % self.save_latest_every == 0
            ):
                self.checkpointer.save(state, name="latest")
            if (
                global_step % self.eval_num == 0 or global_step == self.max_iterations
            ) and self.validator is not None:
                metric = float(self.validator(state))
                self.metric_history.append(metric)
                if metric > self.best_metric:
                    self.best_metric = metric
                    self.best_step = global_step
                    if self.checkpointer is not None:
                        self.checkpointer.save(state, metrics={"dice": metric})
                    self.log_fn(
                        f"Model Was Saved ! Best Dice: {self.best_metric:.5f} "
                        f"at step {self.best_step}; train time {self.running_time:.1f}s"
                    )
                else:
                    self.log_fn(
                        f"Model Not Saved ! Best Dice: {self.best_metric:.5f} "
                        f"Current: {metric:.5f} at step {global_step}"
                    )
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return state
