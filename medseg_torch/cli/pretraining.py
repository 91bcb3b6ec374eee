"""Ranking self-supervised pretraining CLI (counterpart of
``medseg/cli/pretraining.py``).

    python -m medseg_torch.cli.pretraining DATA_DIR DATASET_NAME ROOT_DIR N_CLASSES \\
        LEARNING_RATE TEMPERATURE LOSS [--folds K] [--max-iterations N] [--bf16] \\
        [--device cuda]

Per fold: stage 1 "feat" pretrains the encoder on enc4 slice triplets until
the loss plateaus (or ``--max-iterations`` epochs), then stage 2 "recon"
pretrains the decoder under the frozen encoder the same way, with one train
state (model, AdamW, step) carried across the two. An epoch is one pass of
the loader per slicing axis. Each stage saves its full state every
``--eval-num`` steps and at its end (marked completed, so that a later run
skips it; a stage cut short resumes with the epochs it had consumed) into
``ROOT_DIR/DATASET_NAME_<fold>/<stage>_lr_<lr>_temp_<t>/``, and draws its
loss-vs-time figure. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from functools import partial

import numpy as np
import torch

from medseg_torch.cli.common import (
    apply_overrides,
    build_model,
    device_put_batch,
    fold_datalists,
    resolve_datalist,
)
from medseg_torch.config import preset
from medseg_torch.data.dataset import CacheDataset
from medseg_torch.data.loader import DataLoader
from medseg_torch.data.pipelines import pretrain_transforms
from medseg_torch.engine.checkpoint import CheckpointManager
from medseg_torch.engine.pretrain import (
    ConvergenceTracker,
    feature_dim_for_axis,
    make_pretrain_step,
)
from medseg_torch.engine.state import create_train_state
from medseg_torch.ops.ranking import sample_partition_indices
from medseg_torch.utils.artifacts import RunLogger, plot_loss_vs_time
from medseg_torch.utils.profiling import StepTimer

NUM_PARTITIONS = 4
BATCH_VOLUMES = 2  # x2 crops -> a batch of 4
STAGES = ("feat", "recon")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_dir", type=str)
    p.add_argument("dataset_name", type=str)
    p.add_argument("root_dir", type=str)
    p.add_argument("n_classes", type=int)
    p.add_argument("learning_rate", type=float)
    p.add_argument("temperature", type=float)
    p.add_argument("loss", type=str, choices=["ranking", "contrastive"])
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--max-folds", type=int, default=None,
                   help="run only the first K folds (debug/smoke)")
    p.add_argument("--max-iterations", type=int, default=250)
    p.add_argument("--eval-num", type=int, default=10)
    p.add_argument("--rtol", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and the batches")
    # model-size overrides (defaults: UNETR-B/16)
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--feature-size", type=int, default=16)
    p.add_argument("--hidden-size", type=int, default=768)
    p.add_argument("--mlp-dim", type=int, default=3072)
    p.add_argument("--num-heads", type=int, default=12)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--no-progress", action="store_true",
                   help="disable the live step/loss readout on stderr")
    return p


def stage_prefix(args, update_arc: str) -> str:
    return f"{update_arc}_lr_{args.learning_rate}_temp_{args.temperature}"


def run_stage(args, cfg, model, state, loader, update_arc: str, out_dir: str, logger: RunLogger):
    """One pretraining stage (feat or recon) to convergence."""
    step_fn = make_pretrain_step(
        model,
        update_arc=update_arc,
        loss_type=args.loss,
        num_partitions=NUM_PARTITIONS,
        temperature=args.temperature,
    )
    prefix = stage_prefix(args, update_arc)
    ckpt = CheckpointManager(os.path.join(out_dir, prefix))
    consumed_epochs = 0
    if ckpt.exists():
        state = ckpt.restore(state)
        meta = ckpt.metadata()
        if meta.get("completed"):
            # the stage converged in an earlier run: re-entering it would
            # train another plateau window and move converged weights
            logger.write(
                f"{update_arc}: stage already completed "
                f"({int(meta.get('epoch', 0))} epochs) — skipping"
            )
            return state
        # a resumed stage never runs more than max_iterations epochs in total
        consumed_epochs = int(meta.get("epoch", 0))
        logger.write(
            f"{update_arc}: resuming from checkpoint "
            f"(step {state.step}, {consumed_epochs} epochs consumed)"
        )

    tracker = ConvergenceTracker(rtol=args.rtol, window=10, max_iterations=args.max_iterations)
    tracker.iterations = consumed_epochs
    rng = np.random.default_rng(args.seed)
    epoch_losses: list[float] = []
    epoch_times: list[float] = []
    global_step = state.step
    device = next(model.parameters()).device
    while not tracker.converged:
        timer = StepTimer(device)
        axis_losses = []
        for axis in (0, 1, 2):  # one loader pass per slicing axis
            dim = feature_dim_for_axis(cfg.model.crop_size, update_arc, axis)
            axis_loss, n = 0.0, 0
            for batch in loader:
                images = batch["image"]
                if images.shape[0] != 2 * BATCH_VOLUMES:
                    continue  # the reference's guard: a crop pair of a volume pair
                idx = sample_partition_indices(rng, dim, NUM_PARTITIONS)
                with timer:
                    state, loss = step_fn(state, images, idx, axis=axis)
                    loss = float(loss)
                axis_loss += loss
                n += 1
                global_step += 1
                if not args.no_progress:
                    print(f"\r{update_arc} Training ({global_step} Steps) (loss={loss:2.5f}) "
                          f"(loss time={timer.times[-1]:2.5f})", end="", file=sys.stderr)
                if global_step % args.eval_num == 0:
                    ckpt.save(state, metrics={"loss": loss, "epoch": tracker.iterations})
                    logger.write(f"Model Was Saved At Global Step {global_step} for {update_arc}!")
            if n:
                axis_losses.append(axis_loss / n)
        epoch_loss = float(np.mean(axis_losses)) if axis_losses else 0.0
        tracker.update(epoch_loss)
        epoch_losses.append(epoch_loss)
        epoch_times.append(timer.total)
        logger.write(
            f"{update_arc} epoch {tracker.iterations}: loss={epoch_loss:.5f} "
            f"time={timer.total:.2f}s"
        )
    if not args.no_progress:
        print(file=sys.stderr)
    # the epoch count keeps the resume accounting right if a crash lands
    # between the stages; the completed flag makes a later run skip this one
    ckpt.save(state, metrics={"epoch": tracker.iterations, "completed": 1}, block=True)
    plot_loss_vs_time(
        os.path.join(out_dir, f"{prefix}_loss_vs_time.png"), epoch_losses, epoch_times
    )
    return state


def run_fold(args, cfg, fold_idx: int, train_list: list[dict]) -> str:
    out_dir = os.path.join(args.root_dir, f"{args.dataset_name}_{fold_idx}")
    os.makedirs(out_dir, exist_ok=True)
    logger = RunLogger(out_dir, "pretrain")
    logger.write(f"fold {fold_idx}: {len(train_list)} unlabeled volumes")

    device = torch.device(args.device)
    model = build_model(args, cfg)
    rng_np = np.random.default_rng(args.seed + fold_idx)
    ds = CacheDataset(train_list, transform=pretrain_transforms(cfg.data, rng_np, num_samples=2))
    loader = DataLoader(
        ds,
        batch_size=BATCH_VOLUMES,
        shuffle=True,
        num_workers=cfg.data.num_workers,
        seed=args.seed,
        device_put=partial(device_put_batch, device=device),
        drop_last=True,
    )
    state = create_train_state(
        model,
        generator=torch.Generator().manual_seed(args.seed + fold_idx),
        learning_rate=args.learning_rate,
        weight_decay=1e-5,
        device=device,
    )
    for update_arc in STAGES:  # encoder latents first, then the decoder
        state = run_stage(args, cfg, model, state, loader, update_arc, out_dir, logger)
    return out_dir


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)
    cfg = apply_overrides(preset(args.dataset_name, args.n_classes), args)
    datalist = resolve_datalist(args.data_dir, args.dataset_name)
    folds = fold_datalists(datalist, args.dataset_name, args.folds, cfg.data.cv_seed)
    if args.max_folds is not None:
        folds = folds[: args.max_folds]
    return [run_fold(args, cfg, fold_idx, train_list)
            for fold_idx, (train_list, _val) in enumerate(folds)]


if __name__ == "__main__":
    main()
