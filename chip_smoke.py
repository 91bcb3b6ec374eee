#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, no arguments

Builds the port's CUDA kernels from ``medseg_torch/kernels/csrc`` and drives
its paths with random weights from a seed: serving, whole-volume
sliding-window inference of UNETR-B/16 (BASELINE config 4: a 512x512x160
one-channel CT volume, 14 classes, 96^3 windows, overlap 0.5, Gaussian
blend; its grid takes the z-row walk), the BraTS serving shape (BASELINE
config 8: four MRI channels, 4 classes, 128^3 windows, a 240x240x155 volume,
which takes the flat walk), the serving CLI end to end (NIfTI to NIfTI), and
training, the supervised step of UNETR-B/16 (BASELINE config 5: batch 4 of
96^3 crops, bf16, remat, DiceCE, AdamW lr 1e-4, weight decay 1e-5). Phases,
each raising on failure:

1. device: requires CUDA; prints the card's name and power limit; TF32 off
   for every fp32 reference;
2. build: the kernel library, timed;
3. every serving kernel against its plain PyTorch version at the path's
   shapes, fp32 and bf16 (K4 also with fp32 and bf16 accumulators), then at
   the BraTS window (128^3, four channels), with errors and CUDA-event times;
4. the fused forward (kernels, bf16) against the module forward (fp32) on
   one batch of four 96^3 windows;
5. ``Validator.infer_volume`` on small volumes against the plain fp32
   walk through both routes (z-row with K4, flat with K3), then on the
   config-4 volume with an fp32 and a bf16 accumulator (one warm run, one
   timed run each, whose kernel launches are counted: 50 K4 launches);
6. config 8: a small four-channel volume against the plain fp32 forward,
   then one warm and one timed 240x240x155 volume (K1, K2, K5, K3 launched);
7. the CLI: ``medseg_torch.cli.infer`` with ``--bf16`` and the device
   preprocessing on a synthetic two-volume CT Decathlon directory; masks
   checked, end-to-end vol/s printed;
8. the training step's kernels (K6, K1's data gradient, K7, K8) against
   their plain versions at its shapes, fp32 and bf16, timed;
9. the training step: loss and gradients through the kernels (bf16, remat)
   against the fp32 module without kernels at the same weights and batch;
   then ``make_train_step``: one warm step and 10 timed steps on that batch,
   whose losses must be finite and fall and whose kernel launches are
   counted.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNELS = {  # wrapper -> (CUDA source, TPU kernel it replaces, the bf16 case of its time)
    "conv3x3x3_of": ("medseg_torch/kernels/csrc/conv_of.cu", "medseg/kernels/conv_of.py:761",
                     "enc1.conv2 16->16 affine @4x96^3"),
    "conv3x3x3_of_cat2": ("medseg_torch/kernels/csrc/conv_of.cu",
                          "medseg/kernels/conv_of.py:1044", "dec3.conv1 (32+32)->32 @4x48^3"),
    "conv3x3x3_of_combine": ("medseg_torch/kernels/csrc/conv_of.cu",
                             "medseg/kernels/conv_of.py:1205",
                             "dec2.conv1 (16+16)->16 x1ch @4x96^3"),
    "outhead_of": ("medseg_torch/kernels/csrc/outhead_of.cu", "medseg/kernels/conv_of.py:1423",
                   "out head 16->16 scaled @4x96^3"),
    "outhead_row_of": ("medseg_torch/kernels/csrc/outhead_row_of.cu",
                       "medseg/kernels/conv_of.py:1596", "out head row 16->16 acc bfloat16 @6x96^3"),
    "conv3x3x3_wgrad_of": ("medseg_torch/kernels/csrc/wgrad_of.cu",
                           "medseg/kernels/conv_of.py:914", "wgrad enc1.conv2 16->16 @4x96^3"),
    "dice_ce_sums": ("medseg_torch/kernels/csrc/loss_of.cu", "medseg/kernels/loss_of.py:133",
                     "dice_ce_sums 14 classes @4x96^3"),
    "dice_ce_bwd": ("medseg_torch/kernels/csrc/loss_of.cu", "medseg/kernels/loss_of.py:166",
                    "dice_ce_bwd 14 classes @4x96^3"),
}
FWD_REL_L2_BOUND = 5e-2  # bf16 kernels vs fp32 module forward on random weights
# the training step, bf16 through the kernels vs the fp32 module without them
# (same weights and batch): relative error of the loss and relative L2 of all
# gradients concatenated, measured 1.4e-4 and 9.4e-3 on an H100; the bounds
# leave a margin of about 7x and 5x
TRAIN_LOSS_REL_BOUND = 1e-3
TRAIN_GRAD_REL_L2_BOUND = 5e-2
TRAIN_STEPS = 10
TRAIN_BATCH, CROP, N_CLASSES = 4, 96, 14  # BASELINE config 5
ZROW_KERNELS = ("conv3x3x3_of", "conv3x3x3_of_cat2", "conv3x3x3_of_combine", "outhead_row_of")
FLAT_KERNELS = ("conv3x3x3_of", "conv3x3x3_of_cat2", "conv3x3x3_of_combine", "outhead_of")
TRAIN_KERNELS = ("conv3x3x3_of", "conv3x3x3_wgrad_of", "dice_ce_sums", "dice_ce_bwd")
CONFIG4_K4_LAUNCHES = 50  # 10 d-starts x 5 groups of 2 h-rows (3 w-windows each)
# each kernel's launches come from the path that is its home
HOME_PATH = {"outhead_of": "brats", "conv3x3x3_wgrad_of": "train", "dice_ce_sums": "train",
             "dice_ce_bwd": "train"}
CLI_VOLUME = (200, 200, 120)  # CT voxels at 1.5 x 1.5 x 2 mm: ~300 x 300 x 240 after respacing


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(card)  # as nvidia-smi prints it: name, power limit
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    return torch.device("cuda", 0), card


def phase_build(card: str) -> None:
    from medseg_torch.kernels import _build

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc: "
        f"{'cached' if _build.build_seconds is None else f'{_build.build_seconds:.1f} s'}) [{card}]")


def all_launches() -> dict:
    from medseg_torch.kernels import conv_of, loss_of

    return {fn.__name__: fn.launches for fn in conv_of.KERNELS + loss_of.KERNELS}


def reset_launches() -> None:
    from medseg_torch.kernels import conv_of, loss_of

    conv_of.reset_launches()
    loss_of.reset_launches()


def phase_kernels(device, card: str, table: dict, cases_fn, label: str) -> None:
    """Every case of ``cases_fn`` in fp32 and bf16, kernel vs plain; fills
    each kernel's row of ``table`` (largest error; times and bound of its
    timed bf16 case)."""
    from medseg_torch.kernels import kernel_check

    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases_fn(device, dtype):
            r = kernel_check.run_case(case, dtype, timed=True)
            name = case.kernel.__name__
            entry = table.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
            if dtype == torch.bfloat16 and case.name == KERNELS[name][2]:
                entry.update({k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "library_cl_ms")})
            lib = "" if r["library_ms"] is None else f" library {r['library_ms']:8.3f} ms"
            if r["library_cl_ms"] is not None:
                lib += f" (channels_last {r['library_cl_ms']:.3f})"
            log(f"[{label}] {str(dtype)[6:]:8s} {case.name:44s} out_err {r['out_err']:.2e} "
                f"sums_err {r['stats_err']:.2e} kernel {r['ms']:8.3f} ms plain "
                f"{r['plain_ms']:8.3f} ms{lib} bound {r['bound_ms']:.3f} ms ({r['bound_by']}) "
                f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
            if not r["ok"]:
                failed.append((str(dtype), case.name))
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: {failed}")


def fp32_twin(model):
    """The same weights in a module that computes in fp32."""
    twin = copy.deepcopy(model)
    twin.dtype = None
    return twin


def phase_forward(device, card: str):
    from medseg_torch.kernels import kernel_check
    from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights
    from medseg_torch.models.unetr import init_weights, unetr_b16

    g = torch.Generator().manual_seed(0)
    model = init_weights(unetr_b16(1, 14, 96, dtype=torch.bfloat16), g).to(device).eval()
    x = torch.randn((4, 1, 96, 96, 96), generator=g).to(device)
    weights = fused_weights(model)  # cast once, as the Validator does
    model_fp32 = fp32_twin(model)
    with torch.no_grad():
        ref = model_fp32(x, return_encoder_features=False)
    got = fast_apply_v3(model, x, weights)[:, :14]
    if not torch.isfinite(got).all():
        raise RuntimeError("fused forward: non-finite logits")
    err = rel_l2(got, ref)
    agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
    with torch.no_grad():
        fused_ms = kernel_check.time_ms(lambda: fast_apply_v3(model, x, weights), reps=5)
        plain_ms = kernel_check.time_ms(
            lambda: model_fp32(x, return_encoder_features=False), reps=5
        )
    log(f"[forward] UNETR-B/16 4x96^3: fused bf16 vs module fp32 rel L2 {err:.3e} "
        f"(bound {FWD_REL_L2_BOUND}), argmax agreement {agree:.5f}; fused {fused_ms:.2f} ms, "
        f"module fp32 {plain_ms:.2f} ms per batch of 4 [{card}]")
    if not err <= FWD_REL_L2_BOUND:
        raise RuntimeError(f"fused forward rel L2 {err} above {FWD_REL_L2_BOUND}")
    return model, model_fp32


def timed_volume(validator, volume) -> tuple[torch.Tensor, float, dict]:
    """One warm run, then one timed run whose kernel launches are counted."""
    validator.infer_volume(volume)  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = validator.infer_volume(volume)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, all_launches()


def check_volume(out: torch.Tensor, shape, label: str) -> None:
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.float32:
        raise RuntimeError(f"{label}: output {tuple(out.shape)} {out.dtype}, expected {shape}")
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: non-finite values")


def require_launched(launches: dict, names, label: str) -> None:
    missing = [name for name in names if launches[name] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the {label} path: {missing}")


def phase_slice(model, model_fp32, device, card: str) -> dict:
    """Both routes on small volumes against the plain fp32 walk, then config
    4 through the z-row walk with an fp32 and a bf16 accumulator."""
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.ops.sliding_window import (
        SlidingWindowSpec,
        sliding_window_inference,
        zrow_supported,
    )

    spec = SlidingWindowSpec(roi=(96, 96, 96), overlap=0.5, sw_batch=4, mode="gaussian")
    validators = {acc: Validator(model, 14, "ct", spec, acc_dtype=acc, device=device)
                  for acc in ("fp32", "bf16")}
    rng = np.random.default_rng(0)
    for shape, route in (((128, 128, 96), "z-row"), ((128, 128, 97), "flat")):
        if zrow_supported(shape, spec) != (route == "z-row"):
            raise RuntimeError(f"{shape} should take the {route} walk")
        small = rng.standard_normal(shape + (1,), dtype=np.float32)
        with torch.no_grad():
            ref = sliding_window_inference(
                small, lambda w: model_fp32(w, return_encoder_features=False), 14, spec,
                device=device,
            )
        for acc, validator in validators.items():
            reset_launches()
            got = validator.infer_volume(small)
            torch.cuda.synchronize()
            require_launched(all_launches(), ZROW_KERNELS if route == "z-row" else FLAT_KERNELS,
                             f"small {route}")
            err = rel_l2(got, ref)
            log(f"[slice] {'x'.join(map(str, shape))} volume ({route} walk, acc {acc}): Validator "
                f"(kernels, bf16) vs plain fp32 SWI rel L2 {err:.3e} (bound {FWD_REL_L2_BOUND})")
            if not err <= FWD_REL_L2_BOUND:
                raise RuntimeError(f"small-volume SWI ({route}, {acc}) rel L2 {err}")

    volume = rng.standard_normal((512, 512, 160, 1), dtype=np.float32)
    if not zrow_supported(volume.shape[:3], spec):
        raise RuntimeError("config 4 should take the z-row walk")
    launches = {}
    for acc, validator in validators.items():
        torch.cuda.reset_peak_memory_stats()
        out, seconds, launches[acc] = timed_volume(validator, volume)
        check_volume(out, (512, 512, 160, 14), f"config 4 (acc {acc})")
        log(f"[slice] config 4 512x512x160 z-row walk, acc {acc}: {seconds:.3f} s/volume, "
            f"{300 / seconds:.1f} windows/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]; launches "
            f"{launches[acc]}")
        require_launched(launches[acc], ZROW_KERNELS, "config-4")
        if launches[acc]["outhead_row_of"] != CONFIG4_K4_LAUNCHES:
            raise RuntimeError(f"config 4: {launches[acc]['outhead_row_of']} K4 launches, "
                               f"expected {CONFIG4_K4_LAUNCHES}")
    return launches["bf16"]


def phase_brats(device, card: str) -> dict:
    """BASELINE config 8: UNETR-B/16 with 4 in and 4 out channels, 128^3
    windows, overlap 0.5, Gaussian, bf16 kernels, bf16 accumulator."""
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.models.unetr import init_weights, unetr_b16
    from medseg_torch.ops.sliding_window import (
        SlidingWindowSpec,
        sliding_window_inference,
        zrow_supported,
    )

    g = torch.Generator().manual_seed(0)
    model = init_weights(unetr_b16(4, 4, 128, dtype=torch.bfloat16), g).to(device).eval()
    model_fp32 = fp32_twin(model)
    spec = SlidingWindowSpec(roi=(128, 128, 128), overlap=0.5, sw_batch=4, mode="gaussian")
    validator = Validator(model, 4, "mri", spec, acc_dtype="bf16", device=device)
    rng = np.random.default_rng(1)
    small = 0.3 * rng.standard_normal((144, 144, 131, 4), dtype=np.float32)
    with torch.no_grad():
        ref = sliding_window_inference(
            small, lambda w: model_fp32(w, return_encoder_features=False), 4, spec, device=device
        )
    err = rel_l2(validator.infer_volume(small), ref)
    log(f"[brats] 144x144x131x4 volume (flat walk): Validator (kernels, bf16, acc bf16) vs plain "
        f"fp32 SWI rel L2 {err:.3e} (bound {FWD_REL_L2_BOUND})")
    if not err <= FWD_REL_L2_BOUND:
        raise RuntimeError(f"BraTS small-volume SWI rel L2 {err} above {FWD_REL_L2_BOUND}")
    del model_fp32, ref
    torch.cuda.empty_cache()

    volume = 0.3 * rng.standard_normal((240, 240, 155, 4), dtype=np.float32)
    if zrow_supported(volume.shape[:3], spec):
        raise RuntimeError("config 8 at bucket 1 should take the flat walk")
    torch.cuda.reset_peak_memory_stats()
    out, seconds, launches = timed_volume(validator, volume)
    check_volume(out, (240, 240, 155, 4), "config 8")
    log(f"[brats] config 8 240x240x155x4 flat walk, acc bf16: {seconds:.3f} s/volume, "
        f"{18 / seconds:.1f} windows/s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
        f"[{card}]; launches {launches}")
    require_launched(launches, FLAT_KERNELS, "config-8")
    return launches


def phase_cli(device, card: str) -> dict:
    """The serving CLI end to end on a synthetic abdomenCT directory of two
    CT volumes (1.5 x 1.5 x 2 mm voxels), seeded UNETR-B/16 weights."""
    from medseg_torch.cli import infer
    from medseg_torch.config import preset
    from medseg_torch.data.nifti import read_nifti, write_nifti
    from medseg_torch.data.pipelines import val_transforms_device
    from medseg_torch.models.unetr import init_weights, unetr_b16

    rng = np.random.default_rng(2)
    affine = np.diag([1.5, 1.5, 2.0, 1.0])
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data", "abdomenCT")
        os.makedirs(os.path.join(root, "imagesTr"))
        entries = []
        for i in range(2):
            image = rng.normal(100.0, 80.0, size=CLI_VOLUME).astype(np.float32)
            write_nifti(os.path.join(root, "imagesTr", f"ct{i}.nii.gz"), image, affine)
            entries.append({"image": f"imagesTr/ct{i}.nii.gz"})
        with open(os.path.join(root, "dataset.json"), "w") as f:
            json.dump({"training": entries}, f)
        ckpt = os.path.join(tmp, "unetr_b16.pth")
        model = init_weights(unetr_b16(1, N_CLASSES, 96), torch.Generator().manual_seed(0))
        torch.save(model.state_dict(), ckpt)
        del model
        stats_path = os.path.join(tmp, "stats.json")
        reset_launches()
        written = infer.main([
            os.path.join(tmp, "data"), "abdomenCT", ckpt, os.path.join(tmp, "out"),
            str(N_CLASSES), "--bf16", "--sw-overlap", "0.5", "--sw-mode", "gaussian",
            "--stats-json", stats_path,
        ])
        torch.cuda.synchronize()
        launches = all_launches()
        with open(stats_path) as f:
            stats = json.load(f)
        chain = val_transforms_device(preset("abdomenCT", N_CLASSES).data, device)
        for entry, path in zip(entries, written):
            want = chain({"image": os.path.join(root, entry["image"])})
            mask = read_nifti(path)
            if mask.data.shape != tuple(want["image"].shape[:3]) or mask.data.dtype != np.int16:
                raise RuntimeError(f"CLI mask {path}: {mask.data.shape} {mask.data.dtype}, "
                                   f"expected {tuple(want['image'].shape[:3])} int16")
            if not np.allclose(mask.affine, want["image_affine"], atol=1e-4):
                raise RuntimeError(f"CLI mask {path}: affine {mask.affine} != {want['image_affine']}")
            labels = np.unique(mask.data)
            if labels.min() < 0 or labels.max() >= N_CLASSES:
                raise RuntimeError(f"CLI mask {path}: labels {labels}")
    if len(written) != 2:
        raise RuntimeError(f"CLI wrote {written}")
    log(f"[cli] medseg_torch.cli.infer --bf16 on 2 CT volumes {'x'.join(map(str, CLI_VOLUME))} at "
        f"1.5x1.5x2 mm (device preprocessing, z-row walk, acc bf16): first volume "
        f"{stats['first_volume_seconds']:.3f} s, end to end {stats['e2e_volumes_per_sec']:.4f} "
        f"vol/s after it [{card}]; masks {mask.data.shape} int16, labels {labels.tolist()}; "
        f"launches {launches}")
    require_launched(launches, ZROW_KERNELS, "CLI")
    return launches


def phase_train(device, card: str) -> dict:
    from medseg_torch.engine.state import create_train_state
    from medseg_torch.engine.train import make_loss_fn, make_train_step
    from medseg_torch.kernels import conv3d
    from medseg_torch.models.unetr import unetr_b16
    from medseg_torch.ops.losses import dice_ce_loss

    g = torch.Generator().manual_seed(0)
    model = unetr_b16(1, N_CLASSES, CROP, dtype=torch.bfloat16, remat=True)
    state = create_train_state(model, generator=g, learning_rate=1e-4, weight_decay=1e-5,
                               device=device)
    image = torch.randn((TRAIN_BATCH, 1, CROP, CROP, CROP), generator=g).to(device)
    label = torch.randint(0, N_CLASSES, (TRAIN_BATCH, CROP, CROP, CROP), generator=g,
                          dtype=torch.int32).to(device)

    # (a) kernels vs the fp32 module without kernels (TF32 off), same weights
    loss_k = make_loss_fn("ct")(model, image, label)
    loss_k.backward()
    loss_k = loss_k.item()
    grads_k = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    ref = fp32_twin(model)
    route_min_hw = conv3d.OF_MIN_HW
    conv3d.OF_MIN_HW = float("inf")  # no conv routed: cuDNN everywhere
    try:
        loss_r = dice_ce_loss(ref(image, return_encoder_features=False), label, softmax=True,
                              to_onehot_y=True)
        loss_r.backward()
    finally:
        conv3d.OF_MIN_HW = route_min_hw
    loss_r = loss_r.item()
    diff2 = ref2 = 0.0
    per_leaf = []
    for n, p in ref.named_parameters():
        d2 = (grads_k[n] - p.grad).square().sum().item()
        r2 = p.grad.square().sum().item()
        diff2, ref2 = diff2 + d2, ref2 + r2
        per_leaf.append(((d2 / r2) ** 0.5 if r2 > 0 else float("inf"), n, r2))
    del ref, grads_k
    torch.cuda.empty_cache()
    loss_err = abs(loss_k - loss_r) / abs(loss_r)
    grad_err = (diff2 / ref2) ** 0.5
    # leaves carrying at least 0.01% of the reference's squared gradient norm
    per_leaf = [(e, n) for e, n, r2 in per_leaf if r2 >= 1e-4 * ref2]
    worst = ", ".join(f"{n} {e:.2e}" for e, n in sorted(per_leaf, reverse=True)[:4])
    log(f"[train] loss bf16 kernels {loss_k:.6f} vs fp32 module {loss_r:.6f}: rel err "
        f"{loss_err:.3e} (bound {TRAIN_LOSS_REL_BOUND}); global gradient rel L2 {grad_err:.3e} "
        f"(bound {TRAIN_GRAD_REL_L2_BOUND}); largest per-leaf rel L2 (reported, not bounded; leaves with >= 1e-4 of "
        f"the squared norm): "
        f"{worst}")
    if not (loss_err <= TRAIN_LOSS_REL_BOUND and grad_err <= TRAIN_GRAD_REL_L2_BOUND):
        raise RuntimeError(f"training step: loss rel err {loss_err}, gradient rel L2 {grad_err}")

    # (b)-(d) the step itself on that batch
    step = make_train_step(model, task="ct")
    batch = {"image": image, "label": label}
    state, first = step(state, batch)  # warm
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [first]
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = all_launches()
    losses = [v.item() for v in losses]
    log(f"[train] UNETR-B/16 {TRAIN_BATCH}x{CROP}^3 bf16 remat: {1e3 * seconds:.2f} ms/step, "
        f"{TRAIN_BATCH / seconds:.2f} patches/s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
        f"[{card}]; losses {['%.6f' % v for v in losses]}; launches {launches}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"training step: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training step: loss did not fall over {TRAIN_STEPS} steps: {losses}")
    missing = [name for name in TRAIN_KERNELS if launches[name] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched in the training steps: {missing}")
    return launches


def main() -> int:
    from medseg_torch.kernels import kernel_check

    device, card = phase_device()
    phase_build(card)
    table: dict = {}
    phase_kernels(device, card, table, kernel_check.kernel_cases, "kernel")
    phase_kernels(device, card, table, kernel_check.brats_cases, "brats-kernel")
    model, model_fp32 = phase_forward(device, card)
    paths = {"serving": phase_slice(model, model_fp32, device, card)}
    del model, model_fp32
    torch.cuda.empty_cache()
    paths["brats"] = phase_brats(device, card)
    torch.cuda.empty_cache()
    paths["cli"] = phase_cli(device, card)
    torch.cuda.empty_cache()
    phase_kernels(device, card, table, kernel_check.training_cases, "train-kernel")
    paths["train"] = phase_train(device, card)
    kernels = []
    for name, (src, tpu, _) in KERNELS.items():
        row = table[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": paths[HOME_PATH.get(name, "serving")][name],
            "launches_by_path": {path: launches[name] for path, launches in paths.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library_channels_last_ms": row["library_cl_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
