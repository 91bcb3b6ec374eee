"""Serving CLI: whole-volume segmentation inference to NIfTI masks
(counterpart of ``medseg/cli/infer.py``).

    python -m medseg_torch.cli.infer DATA_DIR DATASET_NAME CHECKPOINT OUT_DIR N_CLASSES \
        [--sw-overlap 0.5] [--sw-mode gaussian] [--bf16] [--device cuda]

Loads a reference ``.pth`` state_dict, runs sliding-window inference over a
Decathlon list and writes int16 label-map NIfTIs with the preprocessed
volume's affine. Defaults are the serving configuration: the fused forward
(CUDA kernels on the card) routed by the ``Validator`` (the z-row walk where
the grid allows it, padded dims bucketed to multiples of 32 as in the JAX
CLI), a bf16 blend accumulator, and preprocessing on the device
(``data.pipelines.val_transforms_device``: NIfTI decode on the host, then
respacing, orientation, windowing and cropping as torch ops on the device).
``--no-fast-path`` / ``--host-preprocess`` / ``--acc fp32`` restore the plain
paths. The printed throughput is end to end per volume: decode + preprocess
+ sliding-window inference + mask + NIfTI write. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from medseg_torch.cli.common import apply_overrides, build_model
from medseg_torch.config import preset
from medseg_torch.data.dataset import load_decathlon_datalist
from medseg_torch.data.nifti import write_nifti
from medseg_torch.data.pipelines import val_transforms, val_transforms_device
from medseg_torch.engine.checkpoint import load_torch_checkpoint
from medseg_torch.engine.evaluate import Validator
from medseg_torch.models.unetr import init_weights
from medseg_torch.ops.post import multichannel_to_label_map
from medseg_torch.ops.sliding_window import SlidingWindowSpec
from medseg_torch.utils.profiling import Throughput


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_dir", type=str)
    p.add_argument("dataset_name", type=str)
    p.add_argument("checkpoint", type=str)
    p.add_argument("out_dir", type=str)
    p.add_argument("n_classes", type=int)
    p.add_argument("--list-key", type=str, default="training",
                   help="dataset.json list to read (training/test)")
    p.add_argument("--sw-overlap", type=float, default=0.25)
    p.add_argument("--sw-mode", type=str, default="constant", choices=["constant", "gaussian"])
    p.add_argument("--sw-batch", type=int, default=8)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast-path", dest="fast_path", action="store_true", default=True,
                   help="the fused serving forward with its kernels (default), where the "
                        "model's widths and the window allow it; else the module forward")
    p.add_argument("--no-fast-path", dest="fast_path", action="store_false",
                   help="the plain module forward")
    p.add_argument("--host-preprocess", action="store_true",
                   help="run the preprocessing chain on host (numpy) instead of device")
    p.add_argument("--no-prefetch", dest="prefetch", action="store_false", default=True,
                   help="disable the decode/write pipeline (serial per-volume)")
    p.add_argument("--stats-json", type=str, default=None,
                   help="write end-to-end throughput stats to this JSON file")
    p.add_argument("--acc", type=str, default="bf16", choices=["bf16", "fp32"],
                   help="blend accumulator dtype (bf16 = serving default; fp32 = MONAI-parity)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model, the windows and the preprocessing")
    # model-size overrides
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--feature-size", type=int, default=16)
    p.add_argument("--hidden-size", type=int, default=768)
    p.add_argument("--mlp-dim", type=int, default=3072)
    p.add_argument("--num-heads", type=int, default=12)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-workers", type=int, default=4)
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    cfg = apply_overrides(preset(args.dataset_name, args.n_classes), args)
    model = init_weights(build_model(args, cfg, remat=False), torch.Generator().manual_seed(0))
    load_torch_checkpoint(args.checkpoint, model)

    json_path = os.path.join(args.data_dir, args.dataset_name, "dataset.json")
    datalist = load_decathlon_datalist(json_path, True, args.list_key)

    crop = cfg.model.crop_size
    spec = SlidingWindowSpec(
        roi=(crop,) * 3, overlap=args.sw_overlap, sw_batch=args.sw_batch,
        mode=args.sw_mode, bucket_multiple=32,
    )
    validator = Validator(
        model, args.n_classes, cfg.data.task, spec,
        use_fast_path=args.fast_path, acc_dtype=args.acc, device=device,
    )
    chain = (val_transforms(cfg.data) if args.host_preprocess
             else val_transforms_device(cfg.data, device))

    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    tp = Throughput()
    first_vol_time = None
    t_start = time.perf_counter()

    def load(entry):
        sample = chain({"image": entry["image"]})
        return torch.as_tensor(sample["image"]).to(device), sample.get("image_affine")

    def save(out_path, label_map, affine):
        write_nifti(out_path, label_map, affine)

    # Serving pipeline: a prefetch thread decodes and preprocesses volume N+1
    # while the device runs volume N, and a writer thread overlaps the NIfTI
    # encode and write, so that steady-state end to end approaches
    # max(decode, inference, write) instead of their sum. Device work stays
    # ordered on the device's one stream.
    executor = writer = None
    if args.prefetch:
        executor = ThreadPoolExecutor(max_workers=1)
        writer = ThreadPoolExecutor(max_workers=1)
        pending_writes = []
        futures = [executor.submit(load, e) for e in datalist[:1]]

    for i, entry in enumerate(datalist):
        t0 = time.perf_counter()
        if args.prefetch:
            image, affine = futures[i].result()
            if i + 1 < len(datalist):
                futures.append(executor.submit(load, datalist[i + 1]))
        else:
            image, affine = load(entry)
        mask = validator.predict_mask(image)
        if cfg.data.task == "ct":
            label_map = mask.argmax(dim=-1)
        else:
            label_map = multichannel_to_label_map(mask)
        label_map = label_map.to(torch.int16).cpu().numpy()
        tp.update(1)
        name = os.path.basename(entry["image"]).replace(".nii", "_pred.nii")
        out_path = os.path.join(args.out_dir, name)
        if args.prefetch:
            pending_writes.append(writer.submit(save, out_path, label_map, affine))
        else:
            save(out_path, label_map, affine)
        written.append(out_path)
        if first_vol_time is None:
            first_vol_time = time.perf_counter() - t0
        print(
            f"{entry['image']} -> {out_path} "
            f"({time.perf_counter() - t0:.2f}s end-to-end, {tp.rate:.3f} vol/s)"
        )
    if args.prefetch:
        for f in pending_writes:
            f.result()
        executor.shutdown()
        writer.shutdown()
    stats = {"volumes": len(written), "first_volume_seconds": first_vol_time}
    if len(written) > 1:
        # steady-state end-to-end rate excluding the first (warm-up) volume
        rate = (len(written) - 1) / max(time.perf_counter() - t_start - first_vol_time, 1e-9)
        stats["e2e_volumes_per_sec"] = round(rate, 4)
        print(f"end-to-end (decode+preprocess+SWI+mask+write, excl. warm-up "
              f"volume): {rate:.3f} vol/s")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f)
    return written


if __name__ == "__main__":
    main()
