"""Supervised segmentation CLI (counterpart of ``medseg/cli/segmentation.py``).

    python -m medseg_torch.cli.segmentation DATA_DIR DATASET_NAME ROOT_DIR N_CLASSES \\
        PRETRAINED MODE TRAIN_SIZE LEARNING_RATE [--folds K] [--max-iterations N] \\
        [--eval-num N] [--bf16] [--device cuda]

Per fold: build the loaders, train to ``--max-iterations`` steps with a
validation (mean Dice) every ``--eval-num`` steps and the best-Dice
checkpoint, then run the all-metrics evaluation (Dice, precision, recall,
Hausdorff) of the best checkpoint, dump the ``.npy`` metric series, draw the
loss/Dice curves, and render slice-overlay PDFs for fold 0. ``MODE=eval``
skips training and evaluates the best checkpoint. A restarted ``train``
run resumes from the fresher of the "latest" and "best" checkpoints, with
the best Dice so far read from ``meta.json``. Runs on the card unless
``--device cpu`` is given; where matplotlib is not installed, the curves
are left to their ``.npy`` series and the overlays are written as
``overlays.npy``, each with a logged line.

Multi-process runs (``medseg_torch.parallel.runtime``): ``main`` joins the
process group that the ``MEDSEG_COORDINATOR`` / ``MEDSEG_NUM_PROCESSES`` /
``MEDSEG_PROCESS_ID`` variables (or torchrun's, under
``MEDSEG_DISTRIBUTED=1``) describe, one device per process (NCCL where each
has a card of its own, gloo on the CPU or on a shared card). Each rank logs
to its own files (``..._host<rank>``), seeds its host chain with ``seed +
fold + 1009 * rank``, loads its ``rank::world`` slice of the training list
(``drop_last``, every rank the same local batch), and with
``--data-parallel`` steps on it with the gradients averaged over the ranks;
every rank validates the whole validation list with the window grid sharded
over the ranks, so all take the same best-checkpoint decision. Rank 0 alone
writes checkpoints, series and figures; every rank restores the best
checkpoint after the ``final_checkpoint_committed`` barrier. Without
``--data-parallel`` each rank trains on its slice alone, as the JAX CLI
does; ``--data-parallel`` in one process runs single-device and logs it.
"""

from __future__ import annotations

import argparse
import importlib.util
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
    make_output_dir,
    resolve_datalist,
    subsample_train,
)
from medseg_torch.config import preset
from medseg_torch.data.dataset import CacheDataset
from medseg_torch.data.loader import DataLoader
from medseg_torch.data.pipelines import train_transforms, val_transforms
from medseg_torch.engine.checkpoint import CheckpointManager, load_torch_checkpoint
from medseg_torch.engine.evaluate import Validator
from medseg_torch.engine.state import create_train_state
from medseg_torch.engine.train import TrainLoop, make_train_step, make_validator
from medseg_torch.ops.post import multichannel_to_label_map
from medseg_torch.ops.sliding_window import SlidingWindowSpec
from medseg_torch.parallel.runtime import (
    barrier,
    global_mesh,
    initialize_distributed,
    process_info,
    replicate_multihost,
    shard_batch_multihost,
    shard_datalist,
)
from medseg_torch.utils.artifacts import (
    RunLogger,
    overlay_slices,
    plot_training_curves,
    save_metric_series,
    save_slice_overlays,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_dir", type=str)
    p.add_argument("dataset_name", type=str)
    p.add_argument("root_dir", type=str)
    p.add_argument("n_classes", type=int)
    p.add_argument("pretrained", type=str)
    p.add_argument("mode", type=str, choices=["train", "eval"])
    p.add_argument("train_size", type=float)
    p.add_argument("learning_rate", type=float)
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--max-folds", type=int, default=None,
                   help="run only the first K folds (debug/smoke)")
    p.add_argument("--max-iterations", type=int, default=25000)
    p.add_argument("--eval-num", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model, the batches and the metrics")
    # model-size overrides (defaults: UNETR-B/16)
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--feature-size", type=int, default=16)
    p.add_argument("--hidden-size", type=int, default=768)
    p.add_argument("--mlp-dim", type=int, default=3072)
    p.add_argument("--num-heads", type=int, default=12)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=1,
                   help="volumes per step (crops multiply this; reference uses 1)")
    p.add_argument("--device-augment", action="store_true",
                   help="run flip/rot90/shift augmentations on device inside the train step")
    p.add_argument("--data-parallel", action="store_true",
                   help="average the gradients over the processes, each stepping on its own "
                        "crops (one process: single-device)")
    p.add_argument("--sw-overlap", type=float, default=0.25)
    p.add_argument("--sw-mode", type=str, default="constant", choices=["constant", "gaussian"])
    p.add_argument("--save-latest-every", type=int, default=None,
                   help="persist the full train state under 'latest' every N steps "
                        "(on restart the freshest of latest/best resumes with "
                        "step and optimizer state intact)")
    p.add_argument("--sync-every", type=int, default=1,
                   help="read the loss back every N steps (N>1 keeps steps queued on the "
                        "device; 1 = honest per-step timing)")
    p.add_argument("--no-progress", action="store_true",
                   help="disable the live step/loss readout on stderr")
    return p


def data_parallel_mesh(args, device: torch.device, logger: RunLogger):
    """The mesh of a ``--data-parallel`` run over several processes, else
    None (one process runs single-device, and says so)."""
    rank, world = process_info()
    if not args.data_parallel:
        if world > 1:
            logger.write(f"rank {rank}/{world}: no --data-parallel; this rank trains on its "
                         "slice of the training list alone")
        return None
    if world == 1:
        logger.write(f"data-parallel requested with one device ({device}, one process): "
                     "running single-device")
        return None
    mesh = global_mesh(device)
    logger.write(f"data-parallel over {world} processes: {mesh}")
    return mesh


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def run_fold(args, cfg, fold_idx, train_list, val_list) -> dict:
    device = torch.device(args.device)
    rank, world = process_info()
    out_dir = make_output_dir(args.root_dir, args.pretrained, args.dataset_name, fold_idx)
    log_name = f"lr_{args.learning_rate}_train_size_{int(args.train_size)}"
    if world > 1:
        log_name += f"_host{rank}"  # one log per rank in the shared directory
    logger = RunLogger(out_dir, log_name)
    logger.write(f"fold {fold_idx}: {len(train_list)} train / {len(val_list)} val volumes")
    mesh = data_parallel_mesh(args, device, logger)

    model = build_model(args, cfg)
    # each rank loads its rank::world slice of the training list; the
    # validation list stays global (every rank runs the same validation)
    train_list_local = shard_datalist(train_list)
    if world > 1:
        logger.write(f"rank {rank}/{world}: {len(train_list_local)} local train volumes")
        if len(train_list_local) < args.batch_size:
            raise ValueError(
                f"rank {rank}: local slice of the training list ({len(train_list_local)} "
                f"volumes) smaller than batch_size {args.batch_size}: with drop_last the "
                "loader would yield nothing; use more data or a smaller batch")
    rng_np = np.random.default_rng(args.seed + fold_idx + 1009 * rank)
    train_ds = CacheDataset(
        train_list_local,
        transform=train_transforms(cfg.data, rng_np, augment=not args.device_augment),
    )
    val_ds = CacheDataset(val_list, transform=val_transforms(cfg.data))
    put = partial(device_put_batch, device=device)
    if mesh is not None:
        # every rank must step on the same local batch: the loader drops a
        # short last batch and the guard raises on the rank at fault
        put = partial(shard_batch_multihost, mesh,
                      expected_local_batch=args.batch_size * cfg.data.num_crop_samples)
    train_loader = DataLoader(
        train_ds,
        batch_size=args.batch_size,
        shuffle=True,
        num_workers=cfg.data.num_workers,
        seed=args.seed,
        device_put=put,
        drop_last=world > 1,
    )
    val_loader = DataLoader(
        val_ds, batch_size=1, shuffle=False, num_workers=cfg.data.num_workers
    )

    state = create_train_state(
        model,
        generator=torch.Generator().manual_seed(args.seed + fold_idx),
        learning_rate=args.learning_rate,
        weight_decay=1e-5,
        device=device,
    )
    if args.pretrained and os.path.exists(args.pretrained):
        logger.write(f"loading pretrained weights: {args.pretrained}")
        if args.pretrained.endswith((".pth", ".pt")):
            load_torch_checkpoint(args.pretrained, state.model)
        else:
            state = CheckpointManager(args.pretrained).restore(state)
            # optax bakes the rate into its update, so the JAX restore keeps
            # this run's; torch's optimizer state carries the saved one
            for group in state.optimizer.param_groups:
                group["lr"] = args.learning_rate
    if mesh is not None:
        replicate_multihost(mesh, state.model)  # rank 0's weights on every rank

    crop = cfg.model.crop_size
    spec = SlidingWindowSpec(
        roi=(crop,) * 3, overlap=args.sw_overlap, sw_batch=4, mode=args.sw_mode,
        bucket_multiple=32,
    )

    def volumes():
        for batch in val_loader:
            yield {"image": batch["image"][0], "label": batch["label"][0]}

    ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    resumed = False
    if args.mode == "train" and (ckpt.exists() or ckpt.exists("latest")):
        # crash recovery: resume from whichever of latest/best is newer
        state = ckpt.restore_freshest(state)
        resumed = True
        logger.write(f"resuming from checkpoint at step {state.step}")
    elif args.mode == "eval" and ckpt.exists():
        logger.write("evaluating existing best checkpoint")
        state = ckpt.restore(state)

    if args.mode == "train":
        progress = None
        if not args.no_progress and rank == 0:
            def progress(step, total, loss):
                tag = "-----" if np.isnan(loss) else f"{loss:2.5f}"
                print(f"Training ({step} / {total} Steps) (loss={tag})", file=sys.stderr,
                      flush=True)

        def log_fn(msg: str) -> None:
            print(msg)
            logger.write(msg)

        loop = TrainLoop(
            make_train_step(model, task=cfg.data.task, device_augment=args.device_augment,
                            mesh=mesh),
            max_iterations=args.max_iterations,
            eval_num=args.eval_num,
            # mean Dice of the current weights; a Validator per call (it
            # casts the kernels' weights once when it is built)
            validator=make_validator(volumes, args.n_classes, cfg.data.task, spec,
                                     device=device, mesh=mesh),
            checkpointer=ckpt if rank == 0 else None,
            log_fn=log_fn,
            save_latest_every=args.save_latest_every,
            sync_every=args.sync_every,
            progress=progress,
        )
        if resumed:
            # seed the best so far from the sidecar, so that a resumed run
            # overwrites "best" only on a genuine improvement
            meta = ckpt.metadata()
            if "dice" in meta:
                loop.best_metric = float(meta["dice"])
                loop.best_step = int(meta.get("step", -1))
                logger.write(
                    f"resume: historical best Dice {loop.best_metric:.5f} "
                    f"at step {loop.best_step}"
                )

        def batches():
            while True:
                yield from train_loader

        state = loop.run(state, batches())
        prefix = f"lr_{args.learning_rate}"
        if rank == 0:  # the series and curves are rank 0's
            save_metric_series(
                out_dir, prefix, {"loss": loop.loss_history, "dice": loop.metric_history}
            )
            if have_matplotlib():
                plot_training_curves(
                    os.path.join(out_dir, "curves.png"),
                    loop.loss_history,
                    loop.metric_history,
                    args.eval_num,
                )
            else:
                logger.write(f"matplotlib is not installed: curves.png not drawn; its series "
                             f"are {prefix}_loss.npy and {prefix}_dice.npy")

    # final evaluation with all metrics, of the best checkpoint: rank 0
    # commits any save in flight, and every rank waits for it before reading
    # the checkpoint, so that all evaluate the same weights
    if rank == 0:
        ckpt.wait()
    barrier("final_checkpoint_committed")
    if ckpt.exists():
        state = ckpt.restore(state)
    validator = Validator(state.model, args.n_classes, cfg.data.task, spec, device=device,
                          mesh=mesh)
    result = validator(volumes(), all_metrics=True)
    summary = {
        "dice": result.mean_dice,
        "dice_per_class": result.per_class_dice.tolist(),
        "precision": result.mean_precision,
        "recall": result.mean_recall,
        "hausdorff": result.mean_hausdorff,
    }
    logger.write(f"fold {fold_idx} final: {summary}")
    logger.event("final_metrics", fold=fold_idx, **summary)
    if rank == 0:
        save_metric_series(
            out_dir,
            "final",
            {
                "dice_per_class": result.per_class_dice,
                "precision_per_class": result.per_class_precision,
                "recall_per_class": result.per_class_recall,
                "hausdorff_per_class": result.per_class_hausdorff,
            },
        )

    # slice overlays for fold 0, from a walk at overlap 0.8 (the reference's
    # overlay setting, not the evaluation's overlap); every rank runs the
    # sharded walk, rank 0 writes the figure
    if fold_idx == 0 and len(val_ds) > 0:
        sample0 = val_ds[0]
        overlay_spec = SlidingWindowSpec(
            roi=spec.roi, overlap=0.8, sw_batch=spec.sw_batch, mode=spec.mode,
            bucket_multiple=spec.bucket_multiple,
        )
        mask = validator.predict_mask(sample0["image"], overlay_spec)
        if rank == 0:
            write_overlays(out_dir, sample0, mask, cfg.data.task, args.n_classes, logger)
    return summary


def write_overlays(out_dir: str, sample0: dict, mask: torch.Tensor, task: str, n_classes: int,
                   logger: RunLogger) -> None:
    """The overlays of the first validation volume: ``overlays.pdf``, or
    where matplotlib is not installed, its slices in ``overlays.npy``."""
    if task == "ct":
        pred_map = mask.argmax(dim=-1).cpu().numpy()
        label_map = np.asarray(sample0["label"][..., 0]).astype(np.int64)
    else:
        pred_map = multichannel_to_label_map(mask).cpu().numpy()
        label_map = multichannel_to_label_map(torch.as_tensor(sample0["label"])).numpy()
    image = np.asarray(sample0["image"][..., 0])
    if have_matplotlib():
        save_slice_overlays(
            os.path.join(out_dir, "overlays.pdf"), image, label_map, pred_map, n_classes
        )
        return
    slices = overlay_slices(label_map, pred_map, n_classes)
    np.save(os.path.join(out_dir, "overlays.npy"), np.stack(
        [image[:, :, slices], label_map[:, :, slices], pred_map[:, :, slices]]
    ).astype(np.float32))
    logger.write(f"matplotlib is not installed: overlays.pdf not drawn; slices {slices} "
                 "(image, label, prediction) are in overlays.npy")


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    # joins the process group where a multi-process configuration is present
    initialize_distributed(device=args.device)
    cfg = apply_overrides(preset(args.dataset_name, args.n_classes), args)
    datalist = resolve_datalist(args.data_dir, args.dataset_name)
    folds = fold_datalists(datalist, args.dataset_name, args.folds, cfg.data.cv_seed)
    if args.max_folds is not None:
        folds = folds[: args.max_folds]
    results = []
    for fold_idx, (train_list, val_list) in enumerate(folds):
        train_list = subsample_train(train_list, args.train_size)
        results.append(run_fold(args, cfg, fold_idx, train_list, val_list))
    return results


if __name__ == "__main__":
    main()
