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
96^3 crops, bf16, remat, DiceCE, AdamW lr 1e-4, weight decay 1e-5), and
ranking pretraining, both stages through the step and the pretraining CLI,
with the flat per-conv route (K9) at feature size 32, and the segmentation
CLI (k-fold fine-tuning, best-Dice checkpoints, the final evaluation) on CT
and on BraTS. Phases, each raising on failure:

1. device: requires CUDA; prints the card's name and power limit; TF32 off
   for every fp32 reference;
2. build: the kernel library (nvcc) and, beside it, the native host library
   (g++: gunzip and the Spacing resamplers), timed, with the entry points it
   carries; then native: each of its six entry points against its plain
   numpy version on a BTCV-shaped 512x512x147 int16 .nii.gz volume and its
   label at 0.76x0.76x3 mm respaced to 1.5x1.5x2 mm (gunzip byte-exact,
   trilinear 1e-5, nearest equal but at .5 ties, scale 1e-5, z-score 1e-4,
   the box exact), timed on the host with its CPU model and core count, and
   the chain's resample of 4 volumes serially and in 4 threads at once;
3. every serving kernel against its plain PyTorch version at the path's
   shapes, fp32 and bf16 (K4 also with fp32 and bf16 accumulators, and on a
   row whose last window starts off 8 voxels), then at the BraTS window
   (128^3, four channels), with errors, CUDA-event times and the route each
   case took (K1 and K6: the tensor cores for bf16 with C_in a multiple of
   16, the narrow-input tensor-core kernel for bf16 with C_in <= 8 and no
   prologue, enc1.conv1 at 1 and 4 channels, also at the config-4 batch of
   6; K5 and K2: the tensor cores for bf16 with both halves of their input
   a multiple of 16 wide; K3 and K4: the tensor cores for bf16 with C a
   multiple of 16 and K_pad 8, 16 or 32; the CUDA cores otherwise), K5 also
   at feature size 32's (64+64)->64, every bf16 K1, K3, K4 and K5 case on
   the tensor cores;
4. the fused forward (kernels, bf16) against the module forward (fp32) on
   one batch of four 96^3 windows, at feature size 16 (UNETR-B/16), then at
   feature size 32 (K5 over (64+64)->64), K1, K2, K3 and K5 only on the
   tensor cores;
5. ``Validator.infer_volume`` on small volumes against the plain fp32
   walk through both routes (z-row with K4, flat with K3), then on the
   config-4 volume with an fp32 and a bf16 accumulator (``checked_volume``:
   the launches counted on the volume run eagerly are 50 K4, 50 K2 and 50
   K5 launches, all on the tensor cores, and K1 only on the tensor cores,
   its narrow-input kernel included; the graphed walk's logits are the
   eager walk's bit for bit, and its device kernels, from a profiler trace,
   the eager walk's, name by name);
6. config 8: a small four-channel volume against the plain fp32 forward,
   then a 240x240x155 volume through ``checked_volume`` (K1, K2, K5, K3
   launched; K1, K2, K3 and K5 only on the tensor cores, K1's narrow kernel
   launched);
7. the CLI: ``medseg_torch.cli.infer`` with ``--bf16`` and the device
   preprocessing on a synthetic two-volume CT Decathlon directory; masks
   checked, end-to-end vol/s printed (K1, K2, K4 and K5 only on the
   tensor cores);
8. the training step's kernels (K6, K1's data gradient, K7, K8) against
   their plain versions at its shapes, fp32 and bf16, timed (K7 and K8 also
   on 2 classes and on a ragged 4x97^3 volume, and by their device kernels'
   durations in the profiler's trace); then two K7 calls on config 5's bf16
   logits, whose sums must be bitwise equal;
8b. norm-kernel: N1, the blocks' instance norm (``norm_of``), forward and
   backward, with the leaky ReLU and with the residual add and the leaky
   ReLU, at the main path's shapes (4x16x128^3, 4x16x96^3, 4x48x96^3,
   4x32x48^3, 4x128x12^3, 6x64x24^3), fp32 and bf16, against the plain
   versions: errors, device ms from the profiler's trace beside the bound
   (bytes / 3.35 TB/s), the plain version's and ``F.instance_norm``'s
   (the library yardstick, without the epilogue) CUDA-event ms;
9. the training step: loss and gradients through the kernels (bf16, remat)
   against the fp32 module without kernels at the same weights and batch;
   then ``make_train_step``: one warm step and 10 steps on that batch,
   whose losses must be finite and fall and whose kernel launches are
   counted (K1 and K6 only on the tensor cores, both narrow kernels
   launched);
9b. routes: each training path on the kernels and on the library, in this
    process (``library_route``: the port's route constants and the loss's
    predicate patched for the run, as the JAX package's ablation switches
    route its step; ``ROUTE_RUNS``): config 5's step by default, with every
    3x3x3 conv on cuDNN (no K1 or K6; the JAX ``MEDSEG_TRAIN_CONV=xla``),
    the filter gradients on ``conv3d_weight`` (no K6; K1's data gradient as
    by default; ``MEDSEG_WGRAD=xla``), the plain DiceCE (no K7 or K8;
    ``MEDSEG_FUSED_LOSS=0``) and all three, each run's loss within 1e-3 and
    global gradient within 5e-2 relative L2 of the default's, the default
    launching all four; config 2's step (BASELINE: spleen, 2 classes, batch
    2 of 96^3, bf16, remat) by default (K7 and K8 at K = 2) and all on the
    library, both against its fp32 module at the same bounds; per run the
    hand kernels' launches in one step after a warm one; then config 4's
    volume once on the fused z-row path (K4 launched) and once on the
    module forward through the flat walk (``Validator(use_fast_path=False)``:
    SDPA, cuBLAS and cuDNN, no hand kernel launched; logits within 5e-2
    relative L2 of the fused path's);
10. flat-kernel: K9 against its plain version at the flat route's shape
    (128 -> 64 at 4x48^3) and two more, fp32 and bf16, timed, with the
    route each took (every bf16 case on the tensor cores, mode FLAT);
11. pretrain: ranking pretraining of UNETR-B/16 (bf16, remat) through
    ``make_pretrain_step`` on two noise volumes x two overlapping 96^3
    crops: per stage (feat, then recon on the same state) the loss and
    gradients against the fp32 module without kernels, one ranking step on
    each axis and one contrastive step (finite losses; recon launches K1 and
    K6, on the tensor cores, and leaves the ViT's gradients 0, feat launches
    neither), then one warm and 5 timed steps (ms/step, peak memory);
12. pretrain-flat: the recon step of a feature-size-32 UNETR with the flat
    per-conv route on: decoder3.conv1 through K9 (2 launches per step, its
    forward and the remat recompute, both on the tensor cores), loss and
    gradients against the fp32 twin, ms/step;
13. pretrain-cli: ``medseg_torch.cli.pretraining`` on four synthetic CT
    volumes (one fold, one epoch per stage, a checkpoint every 2 steps):
    both stages' checkpoints and loss-vs-time artifacts, steps/s, the host
    chain's gunzip and resampling through the native library (calls counted);
14. seg-cli: ``medseg_torch.cli.segmentation`` on a synthetic abdomenCT
    directory (four 128x128x96 CT volumes at 1.5x1.5x2 mm, 14 classes, one
    box-shaped organ per class): ``train`` (one fold of two, 4 steps of one
    volume x 4 crops of 96^3, bf16, device augmentation, a validation every 2
    steps, "latest" every 2), then ``eval``, which must reproduce the final
    Dice, precision, recall and Hausdorff exactly (the kernels' statistics
    are added in a fixed order); checkpoints, series and
    figures (or their .npy) on disk; K1, K6, K7 and K8 in the steps, K2, K5
    and K4 on the tensor cores in the final evaluation (z-row walk); train
    steps/s after the first, seconds per validation volume, the final
    evaluation's seconds and Hausdorff's share; the host chain's resampling
    through the native library (calls counted);
15. mri-train-kernel: the BraTS step's C_in = 4 kernels (K1 4->16 and K6 at
    C = 4 @4x128^3: the narrow-input kernels in bf16, the CUDA cores in
    fp32) against their plain versions, timed;
16. seg-cli-mri: the same CLI on a synthetic Task01_BrainTumour directory
    (four 4-channel 160x160x128 volumes, labels 0-3): 2 steps of 4 crops of
    128^3, bf16, sigmoid DiceCE (no K7 or K8), K1 and K6 only on the tensor
    cores in the steps, their narrow kernels launched, the validation's out head (K4 on the z-row walk or
    K3 on the flat walk, as ``zrow_supported`` picks); step ms and peak
    memory. Phases 14-16 add about 1.5 minutes to the run (89 s on an H100:
    69, 8 and 12);
17. determinism: K1, K2, K5 and K6 twice on the same inputs at the serving,
    BraTS and training shapes, fp32 (CUDA cores) and bf16 (tensor cores,
    both narrow-input kernels included), then the fused forward twice on
    four 96^3 windows: outputs, statistics, filter gradients and logits
    bitwise equal;
18. dp: a process group of one rank on NCCL: config 5's step through
    ``make_train_step(mesh=...)`` (1 warm step, then two timed blocks of 5
    in turns with the same steps without a mesh from the same weights;
    parameters bitwise, or within 2 x lr x steps, which is printed), ``Validator(mesh=...)`` on the
    seg-cli's 192x192x191 volume (the sharded z-row walk) and on a
    128x128x97 volume (the sharded flat walk, K3) against the unsharded
    walks, bitwise; K1, K6, K7 and K8 in the steps, K1, K2, K5 and K4 (K3)
    on the tensor cores in the walks, the collectives counted;
19. dp-2: two processes on the one card (gloo through the host,
    ``tools/dryrun_multichip``, each run with a time limit): each rank
    steps on 2 of the 4 crops of config 5, the global gradient against one
    process on all 4 and against one process's mean of the same halves
    (relative L2 within the tool's bounds), the steps timed;
    the sharded z-row walk at two ranks against one on a 192x192x191 volume
    (fp32 accumulator; argmax agreement at least 0.9999, both ranks the
    same bits); then the segmentation CLI on two processes through the
    ``MEDSEG_*`` variables (``--data-parallel``, one fold, 2 steps, one
    validation): the same final metrics on both ranks, rank 0 alone saving
    checkpoints, one log per rank.

The line before the last is the JSON kernel table (K1-K6 and K9 with the
launches of their tensor-core route beside all their launches by path,
path ``config-2`` one step of the default config-2 run, the
route their timed case took, and each kernel's fp32 case times beside the
bf16 ones; the narrow-input kernels of K1 and K6 as rows of their own; on
the paths whose ``Validator`` replays CUDA graphs unchecked by
``checked_volume`` (the CLIs, validations and the data-parallel walks) the
launches the host issued, which a replay adds nothing to); the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

KERNELS = {  # wrapper -> (CUDA source, TPU kernel it replaces, the bf16 case of its time)
    "conv3x3x3_of": ("medseg_torch/kernels/csrc/conv_tc.cu", "medseg/kernels/conv_of.py:761",
                     "enc1.conv2 16->16 affine @4x96^3"),
    "conv3x3x3_of_cat2": ("medseg_torch/kernels/csrc/conv_tc.cu",
                          "medseg/kernels/conv_of.py:1044", "dec3.conv1 (32+32)->32 @4x48^3"),
    "conv3x3x3_of_combine": ("medseg_torch/kernels/csrc/conv_tc.cu",
                             "medseg/kernels/conv_of.py:1205",
                             "dec2.conv1 (16+16)->16 x1ch @4x96^3"),
    "outhead_of": ("medseg_torch/kernels/csrc/outhead_tc.cu", "medseg/kernels/conv_of.py:1423",
                   "out head 16->16 scaled @4x96^3"),
    "outhead_row_of": ("medseg_torch/kernels/csrc/outhead_tc.cu",
                       "medseg/kernels/conv_of.py:1596", "out head row 16->16 acc bfloat16 @6x96^3"),
    "conv3x3x3_wgrad_of": ("medseg_torch/kernels/csrc/wgrad_tc.cu",
                           "medseg/kernels/conv_of.py:914", "wgrad enc1.conv2 16->16 @4x96^3"),
    "dice_ce_sums": ("medseg_torch/kernels/csrc/loss_of.cu", "medseg/kernels/loss_of.py:133",
                     "dice_ce_sums 14 classes @4x96^3"),
    "dice_ce_bwd": ("medseg_torch/kernels/csrc/loss_of.cu", "medseg/kernels/loss_of.py:166",
                    "dice_ce_bwd 14 classes @4x96^3"),
    "conv3x3x3_flat": ("medseg_torch/kernels/csrc/conv_tc.cu", "medseg/kernels/conv3d.py:134",
                       "dec3.conv1 128->64 (feature size 32) @4x48^3"),
    # K1 and K6 at a narrow input (C_in <= 8: enc1.conv1): "<wrapper>[narrow]"
    # counts the launches of that kernel
    "conv3x3x3_of[narrow]": ("medseg_torch/kernels/csrc/conv_narrow_tc.cu",
                             "medseg/kernels/conv_of.py:761", "enc1.conv1 1->16 @4x96^3"),
    "conv3x3x3_wgrad_of[narrow]": ("medseg_torch/kernels/csrc/conv_narrow_tc.cu",
                                   "medseg/kernels/conv_of.py:914",
                                   "wgrad enc1.conv1 1->16 @4x96^3"),
}
# K1, K2, K3, K4, K5, K6 and K9 have a second route, on the CUDA cores
# (fp32, C_in of 1 or 4, K9 at C % 16 != 0, K3/K4 at other widths); the
# timed bf16 case above takes the tensor cores. "<name>[tc]" counts the
# launches that took the tensor-core route
CUDA_CORE_SOURCES = {"conv3x3x3_of": "medseg_torch/kernels/csrc/conv_of.cu",
                     "conv3x3x3_of_cat2": "medseg_torch/kernels/csrc/conv_of.cu",
                     "conv3x3x3_of_combine": "medseg_torch/kernels/csrc/conv_of.cu",
                     "outhead_of": "medseg_torch/kernels/csrc/outhead_of.cu",
                     "outhead_row_of": "medseg_torch/kernels/csrc/outhead_row_of.cu",
                     "conv3x3x3_wgrad_of": "medseg_torch/kernels/csrc/wgrad_of.cu",
                     "conv3x3x3_flat": "medseg_torch/kernels/csrc/conv_flat.cu"}
K1_TC, K6_TC = "conv3x3x3_of[tc]", "conv3x3x3_wgrad_of[tc]"
K1_NARROW, K6_NARROW = "conv3x3x3_of[narrow]", "conv3x3x3_wgrad_of[narrow]"
# K1 (enc1.conv1 on the narrow-input kernel), K5 and K2 run only on the
# tensor cores on the serving paths (feature sizes 16 and 32), and so do K4
# on the z-row walk and K3 on the flat walk and in the fused forward (bf16,
# C 16 or 32, K_pad 8 or 16); K1 and K6 on the bf16 training steps
TC_ONLY = ("conv3x3x3_of", "conv3x3x3_of_cat2", "conv3x3x3_of_combine")
TRAIN_TC_ONLY = ("conv3x3x3_of", "conv3x3x3_wgrad_of")
ZROW_TC_ONLY, FLAT_TC_ONLY = TC_ONLY + ("outhead_row_of",), TC_ONLY + ("outhead_of",)
# the bf16 cases of phase 3 that must take the tensor cores
SERVING_TC_REQUIRED = ("conv3x3x3_of_cat2", "outhead_of", "outhead_row_of")
FS32 = 32  # the second feature size of the fused forward (K5 over (64+64) -> 64)
FWD_REL_L2_BOUND = 5e-2  # bf16 kernels vs fp32 module forward on random weights
# the training step, bf16 through the kernels vs the fp32 module without them
# (same weights and batch): relative error of the loss and relative L2 of all
# gradients concatenated, measured 1.4e-4 and 9.4e-3 on an H100; the bounds
# leave a margin of about 7x and 5x
TRAIN_LOSS_REL_BOUND = 1e-3
TRAIN_GRAD_REL_L2_BOUND = 5e-2
TRAIN_STEPS = 10
TRAIN_BATCH, CROP, N_CLASSES = 4, 96, 14  # BASELINE config 5
# phase 9b: each training path on the kernels and on the library
# (``library_route``)
ROUTE_KERNELS = ("conv3x3x3_of", "conv3x3x3_wgrad_of", "dice_ce_sums", "dice_ce_bwd")
ROUTE_CONFIGS = {"config-5": (N_CLASSES, TRAIN_BATCH), "config-2": (2, 2)}  # classes, batch
ROUTE_RUNS = {  # run -> (the parts on the library, the kernels it must not launch)
    "default": ((), ()),
    "cudnn-convs": (("convs",), ("conv3x3x3_of", "conv3x3x3_wgrad_of")),
    "cudnn-wgrad": (("wgrad",), ("conv3x3x3_wgrad_of",)),
    "plain-loss": (("loss",), ("dice_ce_sums", "dice_ce_bwd")),
    "all-library": (("convs", "wgrad", "loss"), ROUTE_KERNELS),
}
CONFIG4_VOLUME = (512, 512, 160)
TRACE_PAIRS = 3  # pairs of profiler traces of a graphed and an eager volume (checked_volume)
ZROW_KERNELS = ("conv3x3x3_of", "conv3x3x3_of_cat2", "conv3x3x3_of_combine", "outhead_row_of")
FLAT_KERNELS = ("conv3x3x3_of", "conv3x3x3_of_cat2", "conv3x3x3_of_combine", "outhead_of")
NORM_WRAPPERS = ("instance_norm_fwd", "instance_norm_bwd")  # N1, in every block norm on the card
TRAIN_KERNELS = ("conv3x3x3_of", "conv3x3x3_wgrad_of", "dice_ce_sums", "dice_ce_bwd", K1_TC,
                 K6_TC, K1_NARROW, K6_NARROW) + NORM_WRAPPERS
# N1's row of the kernel line: its source, and its timed bf16 cases
NORM_SOURCE = "medseg_torch/kernels/csrc/instnorm.cu"
NORM_TIMED = ("instance_norm fwd residual+leaky 4x16x128^3",
              "instance_norm bwd residual+leaky 4x16x128^3")
# per config-4 volume, one launch per batch of 6 windows: 10 d-starts x 5
# groups of 2 h-rows (3 w-windows each)
CONFIG4_BATCHES = {"outhead_row_of": 50, "conv3x3x3_of_cat2": 50, "conv3x3x3_of_combine": 50}
# each kernel's launches come from the path that is its home
HOME_PATH = {"outhead_of": "brats", "conv3x3x3_wgrad_of": "train", "dice_ce_sums": "train",
             "dice_ce_bwd": "train", "conv3x3x3_flat": "pretrain-flat", K6_NARROW: "train"}
CLI_VOLUME = (200, 200, 120)  # CT voxels at 1.5 x 1.5 x 2 mm: ~300 x 300 x 240 after respacing
# ranking pretraining (the pretraining CLI's defaults: 4 partitions, temperature
# 0.1, lr 1e-4, weight decay 1e-5), bf16 through the kernels vs the fp32
# module without them at the same weights, batch and slices: relative error
# of the loss and relative L2 of all gradients concatenated. The ranking loss
# is a sum of softplus of cosine differences over tau = 0.1, so its gradients
# carry the bf16 rounding of the features amplified: a bound for wiring
# faults (a wrong tap, slice or frozen leaf gives errors of order 1), the
# kernels themselves are held to their plain versions in phase 10
PRETRAIN_TEMP, PRETRAIN_PARTITIONS = 0.1, 4
PRETRAIN_LOSS_REL_BOUND = 2e-2
PRETRAIN_GRAD_REL_L2_BOUND = 3e-1
PRETRAIN_TIMED_STEPS = 5
RECON_KERNELS = ("conv3x3x3_of", "conv3x3x3_wgrad_of", K1_TC, K6_TC)
FLAT_LAUNCHES_PER_STEP = 2  # decoder3.conv1's forward and its recompute under remat
CLI_PRETRAIN_VOLUME = (128, 128, 96)  # CT voxels at 1.5 x 1.5 x 2 mm: ~192^3 after respacing
SEG_CT_VOLUME = (128, 128, 96)  # CT voxels at 1.5 x 1.5 x 2 mm: 192^3 after respacing (z-row)
SEG_MRI_VOLUME = (160, 160, 128)  # four MRI channels at 1 mm
SEG_METRICS = ("dice", "precision", "recall", "hausdorff")
# K1, K2, K5 and K6 twice on the same inputs (phase 17): both routes, and
# the narrow-input kernels of K1 and K6
DETERMINISM_KERNELS = ("conv3x3x3_of", "conv3x3x3_of_cat2", "conv3x3x3_of_combine",
                       "conv3x3x3_wgrad_of")
DP_STEPS = 5  # timed data-parallel steps after a warm one (phase 18)
DP_LR = 1e-4
FLAT_SHARDED_VOLUME = (128, 128, 97)  # an odd grid: the sharded flat walk (K3)
DP2_TIMEOUT = 420  # seconds for each two-process run of phase 19
# the native phase: a BTCV-shaped CT volume (512 x 512 slices, 147 of them at
# 0.76 x 0.76 x 3 mm, int16 in a .nii.gz) and its label, respaced to 1.5 x 1.5
# x 2 mm; the library's resamplers run in as many threads at once as the
# segmentation CLI's loader has
NATIVE_VOLUME, NATIVE_PIXDIM, NATIVE_TARGET = (512, 512, 147), (0.76, 0.76, 3.0), (1.5, 1.5, 2.0)
NATIVE_THREADS = 4
NATIVE_CALLS = ("inflate_gzip", "trilinear_resample", "nearest_resample")
NATIVE_ENTRY_POINTS = ("msn_inflate_gzip", "msn_trilinear_resample", "msn_nearest_resample",
                       "msn_scale_intensity", "msn_znorm_nonzero", "msn_foreground_bbox")


def log(msg: str) -> None:
    print(msg, flush=True)


def host_cpu() -> tuple[str, int]:
    """The host CPU's model name (where the machine hides it, its vendor,
    family and model numbers) and its logical core count."""
    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    if model in ("", "unknown"):
        model = (f"unknown model name ({fields.get('vendor_id', '?')} family "
                 f"{fields.get('cpu family', '?')} model {fields.get('model', '?')})")
    return model, os.cpu_count() or 1


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
    cpu, cores = host_cpu()
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}; host CPU {cpu}, "
        f"{cores} cores")
    return torch.device("cuda", 0), card


def phase_build(card: str) -> None:
    """The CUDA library (nvcc) and, in a thread beside it, the native host
    library (g++)."""
    from medseg_torch import native
    from medseg_torch.kernels import _build

    failed: list = []

    def build_native():
        try:
            native.load()
        except BaseException as e:  # raised below, after the nvcc build
            failed.append(e)

    t0 = time.perf_counter()
    host = threading.Thread(target=build_native)
    host.start()
    _build.lib()
    host.join()
    if failed:
        raise failed[0]
    lib = native.load()
    carried = [name for name in NATIVE_ENTRY_POINTS if hasattr(lib, name)]
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc: "
        f"{'cached' if _build.build_seconds is None else f'{_build.build_seconds:.1f} s'}; "
        f"g++: {'cached' if native.build_seconds is None else f'{native.build_seconds:.1f} s'}; "
        f"native entry points {carried}) [{card}]")


class NativeCalls:
    """Counts the calls into the native library's gunzip and resamplers for
    one run (the data chain calls them through the module's attributes)."""

    def __enter__(self):
        from medseg_torch import native

        self.native, self.counts, self._saved = native, dict.fromkeys(NATIVE_CALLS, 0), {}
        lock = threading.Lock()
        for name in NATIVE_CALLS:
            fn = self._saved[name] = getattr(native, name)

            def counted(*args, _fn=fn, _name=name):
                with lock:
                    self.counts[_name] += 1
                return _fn(*args)
            setattr(native, name, counted)
        return self

    def __exit__(self, *exc) -> None:
        for name, fn in self._saved.items():
            setattr(self.native, name, fn)

    def require(self, names, label: str) -> None:
        missing = [name for name in names if not self.counts[name]]
        if missing:
            raise RuntimeError(f"{label}: the data chain did not call the native library's "
                               f"{missing}: {self.counts}")


def write_btcv_volume(root: str, rng: np.random.Generator) -> dict:
    """A BTCV-shaped CT volume (int16 HU: air, a body ellipse of soft tissue,
    13 box-shaped organs) and its uint8 label, as ``.nii.gz`` at
    NATIVE_PIXDIM."""
    from medseg_torch.data.nifti import write_nifti

    x, y, z = NATIVE_VOLUME
    gx, gy = np.meshgrid(np.arange(x), np.arange(y), indexing="ij")
    body = ((gx - x / 2) / (0.42 * x)) ** 2 + ((gy - y / 2) / (0.34 * y)) ** 2 < 1.0
    image = np.full(NATIVE_VOLUME, -1000, np.int16)
    image[body] = 40
    image += rng.normal(0.0, 20.0, size=NATIVE_VOLUME).astype(np.int16)
    label = np.zeros(NATIVE_VOLUME, np.uint8)
    for k in range(1, N_CLASSES):  # inside the body's middle 40% in x and y
        size = [rng.integers(d // 25, d // 8) for d in (x, y, z)]
        lo = [rng.integers(int(0.3 * d), int(0.7 * d) - s) for d, s in zip((x, y, z), size)]
        box = tuple(slice(a, a + s) for a, s in zip(lo, size))
        label[box] = k
        image[box] += np.int16(10 * k)
    affine = np.diag(list(NATIVE_PIXDIM) + [1.0])
    paths = {"image": os.path.join(root, "btcv.nii.gz"), "label": os.path.join(root, "btcv_label.nii.gz")}
    write_nifti(paths["image"], image, affine)
    write_nifti(paths["label"], label, affine)
    return paths


def clock(fn, *args, warm: bool = False):
    """``fn(*args)`` and its seconds; ``warm``: of a second call, after one
    that pages in its buffers and starts its thread team."""
    if warm:
        fn(*args)
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def phase_native(card: str) -> None:
    """Each of the native library's six entry points against its plain numpy
    version on a BTCV-shaped volume, timed on the host; then the Spacing
    resample of NATIVE_THREADS volumes one after another and in as many
    threads at once (each call opens its own OpenMP team)."""
    import gzip
    import struct
    from concurrent.futures import ThreadPoolExecutor

    from medseg_torch import native
    from medseg_torch.data import transforms as T

    cpu, cores = host_cpu()
    where = f"host CPU {cpu}, {cores} cores [{card}]"
    rows, failed = [], []

    def row(name, lib_s, plain_s, err, ok, detail=""):
        rows.append(name)
        log(f"[native] {name:20s} library {1e3 * lib_s:9.1f} ms plain {1e3 * plain_s:9.1f} ms "
            f"({plain_s / lib_s:6.1f}x) max_abs_err {err:.3e}{detail} {'ok' if ok else 'FAIL'} "
            f"[{where}]")
        if not ok:
            failed.append(name)

    with tempfile.TemporaryDirectory() as tmp:
        paths, write_s = clock(write_btcv_volume, tmp, np.random.default_rng(10))
        with open(paths["image"], "rb") as f:
            blob = f.read()
        size = struct.unpack("<I", blob[-4:])[0]
        raw, lib_s = clock(native.inflate_gzip, blob, size, warm=True)
        want, plain_s = clock(gzip.decompress, blob)
        row("inflate_gzip", lib_s, plain_s, 0.0 if raw == want else float("inf"), raw == want,
            f" ({len(blob) / 2**20:.1f} MiB -> {size / 2**20:.1f} MiB)")
        sample, load_s = clock(T.load, dict(paths))
    image, label = sample["image"], sample["label"]
    affine = sample["image_affine"]
    target = T._zoom_affine(affine, np.asarray(NATIVE_TARGET))
    shape, offset = T._compute_shape_offset(np.array(image.shape[:3]), affine, target)
    target[:3, 3] = offset
    m = (np.linalg.inv(affine) @ target)[:3]

    tri, lib_s = clock(T._native_resample, image, m, shape, "trilinear", warm=True)
    want, plain_s = clock(T.plain_resample, image, m, shape, "trilinear")
    err = float(np.abs(tri - want).max())
    row("trilinear_resample", lib_s, plain_s, err,
        tri.shape == want.shape and np.allclose(tri, want, rtol=1e-5, atol=1e-5),
        f" ({'x'.join(map(str, image.shape))} -> {'x'.join(map(str, shape))})")

    near, lib_s = clock(T._native_resample, label, m, shape, "nearest", warm=True)
    want, plain_s = clock(T.plain_resample, label, m, shape, "nearest")
    # ties (a coordinate on .5 to within the rounding of its sum) may round
    # either way: both are the nearest voxel; everywhere else they agree
    axes = [m[a, 0] * np.arange(shape[0])[:, None, None] + m[a, 1] * np.arange(shape[1])[None, :, None]
            + m[a, 2] * np.arange(shape[2])[None, None, :] + m[a, 3] for a in range(3)]
    ties = np.zeros(tuple(shape), bool)
    for c in axes:
        ties |= np.abs(c - np.floor(c) - 0.5) < 1e-9
    differ = near != want
    ok = (set(np.unique(near)) <= set(np.unique(label)) and not (differ & ~ties).any())
    row("nearest_resample", lib_s, plain_s, float(np.abs(near - want).max()), ok,
        f" ({int(differ.sum())} voxels differ, all at .5 ties; {int(ties.sum())} ties)")

    scaled = tri.copy()
    clock(native.scale_intensity, tri.copy(), -175.0, 250.0, 0.0, 1.0, True)  # warm
    _, lib_s = clock(native.scale_intensity, scaled, -175.0, 250.0, 0.0, 1.0, True)
    want, plain_s = clock(lambda: T.scale_intensity_range({"image": tri})["image"])
    row("scale_intensity", lib_s, plain_s, float(np.abs(scaled - want).max()),
        np.allclose(scaled, want, rtol=1e-5, atol=1e-6))

    normed = scaled.copy()
    clock(native.znorm_nonzero, scaled.copy())  # warm
    _, lib_s = clock(native.znorm_nonzero, normed)
    want, plain_s = clock(T._znorm, scaled.copy(), True)
    row("znorm_nonzero", lib_s, plain_s, float(np.abs(normed - want).max()),
        np.allclose(normed, want, rtol=1e-4, atol=1e-5))

    box, lib_s = clock(native.foreground_bbox, scaled, warm=True)

    def plain_box(x):
        idx = np.nonzero(x > 0)
        return np.array([v for i in idx for v in (i.min(), i.max() + 1)], np.int64)
    want, plain_s = clock(plain_box, scaled)
    row("foreground_bbox", lib_s, plain_s, float(np.abs(box - want).max()),
        box is not None and np.array_equal(box, want), f" (box {box.tolist()})")
    if rows != ["inflate_gzip", "trilinear_resample", "nearest_resample", "scale_intensity",
                "znorm_nonzero", "foreground_bbox"]:
        raise RuntimeError(f"native: entry points checked {rows}")
    if failed:
        raise RuntimeError(f"native: the library disagrees with its plain versions: {failed}")

    # the chain's Spacing resample (image trilinear, label nearest): alone,
    # NATIVE_THREADS one after another, and NATIVE_THREADS in threads at once
    def respace():
        return T.respace(dict(sample), pixdim=NATIVE_TARGET)
    out, one_s = clock(respace)
    if not (np.array_equal(out["image"], tri) and np.array_equal(out["label"], near)):
        raise RuntimeError("native: respace does not return its resamplers' outputs")
    _, serial_s = clock(lambda: [respace() for _ in range(NATIVE_THREADS)])
    with ThreadPoolExecutor(NATIVE_THREADS) as pool:
        _, threaded_s = clock(lambda: list(pool.map(lambda _: respace(), range(NATIVE_THREADS))))
    log(f"[native] the chain: load (gunzip and decode of image and label) {load_s:.3f} s; respace "
        f"(image trilinear + label nearest) {one_s:.3f} s alone, {NATIVE_THREADS} volumes "
        f"{serial_s:.3f} s one after another, {threaded_s:.3f} s in {NATIVE_THREADS} threads at "
        f"once ({serial_s / threaded_s:.2f}x; each call opens an OpenMP team of "
        f"{cores} threads); writing the volume {write_s:.1f} s [{where}]")


def all_launches() -> dict:
    """Launches of each kernel, ``<name>[tc]`` those of K1-K6 and K9 that
    took a tensor-core route, ``<name>[narrow]`` those of K1 and K6 that took
    the narrow-input kernel."""
    from medseg_torch.kernels import conv_flat, conv_of, loss_of, norm_of

    wrappers = {fn.__name__: fn for fn in conv_of.KERNELS + loss_of.KERNELS + conv_flat.KERNELS
                + norm_of.KERNELS}
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name in CUDA_CORE_SOURCES:
        counts[f"{name}[tc]"] = wrappers[name].tc_launches
    for fn in conv_of.NARROW_KERNELS:
        counts[f"{fn.__name__}[narrow]"] = fn.narrow_launches
    return counts


def reset_launches() -> None:
    from medseg_torch.kernels import conv_flat, conv_of, loss_of, norm_of

    conv_of.reset_launches()
    loss_of.reset_launches()
    conv_flat.reset_launches()
    norm_of.reset_launches()


def phase_kernels(device, card: str, table: dict, cases_fn, label: str,
                  tc_required=()) -> None:
    """Every case of ``cases_fn`` in fp32 and bf16, kernel vs plain; fills
    each kernel's row of ``table`` (largest error; times and bound of its
    timed bf16 case, times of its fp32 case of the same name). The bf16
    cases of the kernels named in ``tc_required`` must take the tensor
    cores."""
    from medseg_torch.kernels import kernel_check

    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases_fn(device, dtype):
            tc_before = getattr(case.kernel, "tc_launches", 0)
            narrow_before = getattr(case.kernel, "narrow_launches", 0)
            r = kernel_check.run_case(case, dtype, timed=True)
            tc = getattr(case.kernel, "tc_launches", 0) > tc_before
            narrow = getattr(case.kernel, "narrow_launches", 0) > narrow_before
            route = "narrow tc" if narrow else "tensor cores" if tc else "cuda cores"
            name = case.kernel.__name__
            # the wrapper's row, and its narrow kernel's where the case took it
            for row in (name, f"{name}[narrow]") if narrow else (name,):
                entry = table.setdefault(row, {"max_abs_err": 0.0})
                entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
                if dtype == torch.bfloat16 and case.name == KERNELS[row][2]:
                    entry.update({k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms", "library_cl_ms", "device_ms")})
                    entry["timed_route"] = route
                if dtype == torch.float32 and case.name == KERNELS[row][2]:
                    entry.update({f"fp32_{k}": r[k] for k in ("ms", "library_ms",
                                                              "library_cl_ms")})
            if dtype == torch.bfloat16 and name in tc_required and not tc:
                failed.append((str(dtype), case.name, "not on the tensor cores"))
            lib = "" if r["library_ms"] is None else f" library {r['library_ms']:8.3f} ms"
            if r["library_cl_ms"] is not None:
                lib += f" (channels_last {r['library_cl_ms']:.3f})"
            if r["device_ms"] is not None:
                lib += f" device {r['device_ms']:.4f} ms"
            log(f"[{label}] {str(dtype)[6:]:8s} {case.name:44s} {route:12s} "
                f"out_err {r['out_err']:.2e} "
                f"sums_err {r['stats_err']:.2e} kernel {r['ms']:8.3f} ms plain "
                f"{r['plain_ms']:8.3f} ms{lib} bound {r['bound_ms']:.3f} ms ({r['bound_by']}) "
                f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
            if not r["ok"]:
                failed.append((str(dtype), case.name))
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: {failed}")


def phase_loss_repeat(device, card: str) -> None:
    """Two K7 calls on the same bf16 config-5 logits must return the same
    bits: the blocks' partial sums are added in a fixed order."""
    from medseg_torch.kernels import loss_of

    g = torch.Generator().manual_seed(4)
    shape = (TRAIN_BATCH, CROP, CROP, CROP)
    logits = (torch.randn((TRAIN_BATCH, N_CLASSES, *shape[1:]), generator=g) * 2.0).to(
        device, torch.bfloat16)
    labels = torch.randint(0, N_CLASSES, shape, generator=g, dtype=torch.int32).to(device)
    first = [t.clone() for t in loss_of.dice_ce_sums(logits, labels)]
    second = loss_of.dice_ce_sums(logits, labels)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[train-kernel] dice_ce_sums twice on {N_CLASSES} classes @{TRAIN_BATCH}x{CROP}^3 bf16: "
        f"{'bitwise equal' if same else 'DIFFERENT'} [{card}]")
    if not same:
        raise RuntimeError("dice_ce_sums: two calls on the same inputs gave different sums")


def phase_norm(device, card: str) -> dict:
    """N1 against its plain version at the main path's shapes, fp32 and
    bf16, timed; returns the kernel line's row (its bf16 timed cases)."""
    from medseg_torch.kernels import kernel_check

    row: dict = {"name": "instance_norm", "route": "cuda", "source": NORM_SOURCE,
                 "replaces": None, "max_abs_err": 0.0, "cases": {}}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in kernel_check.norm_cases(device, dtype):
            r = kernel_check.run_case(case, dtype, timed=True)
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
            if dtype == torch.bfloat16 and case.name in NORM_TIMED:
                row["cases"][case.name] = {k: r[k] for k in ("device_ms", "ms", "plain_ms",
                                                             "library_ms", "bound_ms")}
            log(f"[norm-kernel] {str(dtype)[6:]:8s} {case.name:52s} out_err {r['out_err']:.2e} "
                f"sums_err {r['stats_err']:.2e} device {r['device_ms']:.4f} ms (wrapper "
                f"{r['ms']:.3f}) bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{100 * r['bound_ms'] / r['device_ms']:.1f}%) plain {r['plain_ms']:.3f} ms "
                f"library {r['library_ms']:.3f} ms {'ok' if r['ok'] else 'FAIL'} [{card}]")
            if not r["ok"]:
                failed.append((str(dtype), case.name))
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"N1 disagrees with its plain version: {failed}")
    return row


def plain_norms(model):
    """``model`` with each block's instance norm on its plain PyTorch
    version (``norm_of.instance_norm_fwd_plain``: the norm, its cast, the
    residual add and the leaky ReLU as separate operations) in place of N1,
    so that a reference shares no kernel with the path it checks; returns
    it."""
    from medseg_torch.kernels import norm_of
    from medseg_torch.models.blocks import InstanceNorm

    def plain(norm, x, *, leaky=False, residual=None):
        return norm_of.instance_norm_fwd_plain(x, norm.weight, norm.bias, residual, leaky,
                                               norm.eps)[0]

    for module in model.modules():
        if isinstance(module, InstanceNorm):
            module.forward = functools.partial(plain, module)
    return model


def fp32_twin(model):
    """The same weights in a module that computes in fp32, its norms on
    their plain version (``plain_norms``)."""
    twin = copy.deepcopy(model)
    twin.dtype = None
    return plain_norms(twin)


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
    reset_launches()
    got = fast_apply_v3(model, x, weights)[:, :14]
    torch.cuda.synchronize()
    launches = all_launches()
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
        f"module fp32 {plain_ms:.2f} ms per batch of 4 [{card}]; launches {launches}")
    if not err <= FWD_REL_L2_BOUND:
        raise RuntimeError(f"fused forward rel L2 {err} above {FWD_REL_L2_BOUND}")
    require_tc_only(launches, "the fused forward", FLAT_TC_ONLY)
    return model, model_fp32


def phase_forward32(device, card: str) -> dict:
    """The fused forward of a feature-size-32 UNETR (ViT-B, 96^3 windows, 14
    classes) on one batch of four windows against its fp32 module: its
    dec3.conv1 is K5 over (64+64) -> 64, which must take the tensor cores."""
    from medseg_torch.kernels import kernel_check
    from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights
    from medseg_torch.models.unetr import UNETR, init_weights

    g = torch.Generator().manual_seed(4)
    model = UNETR(in_channels=1, out_channels=N_CLASSES, img_size=(CROP,) * 3,
                  feature_size=FS32, dtype=torch.bfloat16)
    model = init_weights(model, g).to(device).eval()
    x = torch.randn((4, 1, CROP, CROP, CROP), generator=g).to(device)
    weights = fused_weights(model)
    model_fp32 = fp32_twin(model)
    with torch.no_grad():
        ref = model_fp32(x, return_encoder_features=False)
    reset_launches()
    got = fast_apply_v3(model, x, weights)[:, :N_CLASSES]
    torch.cuda.synchronize()
    launches = all_launches()
    if not torch.isfinite(got).all():
        raise RuntimeError("feature-32 fused forward: non-finite logits")
    err = rel_l2(got, ref)
    with torch.no_grad():
        fused_ms = kernel_check.time_ms(lambda: fast_apply_v3(model, x, weights), reps=5)
    log(f"[forward-32] UNETR-B (feature size {FS32}) 4x{CROP}^3: fused bf16 vs module fp32 rel "
        f"L2 {err:.3e} (bound {FWD_REL_L2_BOUND}); fused {fused_ms:.2f} ms per batch of 4 "
        f"[{card}]; launches {launches}")
    if not err <= FWD_REL_L2_BOUND:
        raise RuntimeError(f"feature-32 fused forward rel L2 {err} above {FWD_REL_L2_BOUND}")
    require_tc_only(launches, "the feature-32 forward", FLAT_TC_ONLY)
    del model, model_fp32, ref
    torch.cuda.empty_cache()
    return launches


def warm_then_timed(validator, volume, before_timed=lambda: None) -> tuple[torch.Tensor, float]:
    """One warm run, then one timed run (``before_timed`` runs between)."""
    validator.infer_volume(volume)  # warm
    torch.cuda.synchronize()
    before_timed()
    t0 = time.perf_counter()
    out = validator.infer_volume(volume)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class NoGraphs:
    """A ``GraphedForward`` backend that captures nothing: every batch runs
    the fused forward eagerly, each kernel launched from the host."""

    @staticmethod
    def captures(x: torch.Tensor) -> bool:
        return False


@contextlib.contextmanager
def eager_forward(validator):
    """``validator``'s fused forward run eagerly within the block (a runner
    that captures nothing in place of its ``GraphedForward``)."""
    from medseg_torch.kernels.unetr_of import GraphedForward

    graphed = validator.graphed
    eager = GraphedForward(graphed.model, graphed.weights, graphs=NoGraphs)
    validator._apply_fn = validator._apply_acc = eager
    try:
        yield
    finally:
        validator._apply_fn = validator._apply_acc = graphed


def device_kernels(run) -> collections.Counter:
    """The device kernels of one ``run()`` by name, from a profiler trace."""
    from medseg_torch.kernels.kernel_check import trace_kernels

    return collections.Counter(e["name"] for e in trace_kernels(run))


def checked_volume(validator, volume) -> tuple[torch.Tensor, dict]:
    """One warm run, then the run returned. The launches returned are counted
    where they launch: on the module forward (no ``graphed``) over the
    returned run, on the fused path over the volume run eagerly
    (``eager_forward``), since a CUDA graph's replay launches nothing from
    the host. The fused path's graphed volume must then give the eager
    volume's logits bit for bit and run its device kernels, name by name
    and count by count, both read from profiler traces. The profiler now
    and then drops the records of a few hundred kernels from a trace of a
    CT volume's ~28,000, on either path, so a pair of traces that differs
    is logged and traced again, up to ``TRACE_PAIRS`` pairs; a graph that
    ran other kernels differs in every pair."""
    out, _ = warm_then_timed(validator, volume, reset_launches)
    if validator.graphed is None:
        return out, all_launches()
    with eager_forward(validator):
        reset_launches()
        eager_out = validator.infer_volume(volume)
        torch.cuda.synchronize()
        launches = all_launches()
    if not torch.equal(out, eager_out):
        raise RuntimeError(f"the graphed volume's logits are not the eager volume's: largest "
                           f"|diff| {(out - eager_out).abs().max().item():.3e}")
    del eager_out
    for pair in range(1, TRACE_PAIRS + 1):
        graphed = device_kernels(lambda: validator.infer_volume(volume))
        with eager_forward(validator):
            eager = device_kernels(lambda: validator.infer_volume(volume))
        if graphed == eager:
            break
        diff = {name: (graphed[name], eager[name]) for name in graphed | eager
                if graphed[name] != eager[name]}
        log(f"[graphs] {volume.shape} volume, trace pair {pair}: {sum(graphed.values())} device "
            f"kernels graphed, {sum(eager.values())} eager; {len(diff)} names differ, (graphed, "
            f"eager) by name {sorted(diff.values())}")
    else:
        raise RuntimeError(f"the graphed volume's device kernels are not the eager volume's in "
                           f"{TRACE_PAIRS} pairs of traces: (graphed, eager) {diff}")
    log(f"[graphs] {volume.shape} volume: {sum(graphed.values())} device kernels in the graphed "
        f"walk, the eager walk's by name and count (trace pair {pair}), logits bitwise equal "
        f"({validator.graphed.captures} captures, "
        f"{validator.graphed.replays} replays so far)")
    return out, launches


def check_volume(out: torch.Tensor, shape, label: str) -> None:
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.float32:
        raise RuntimeError(f"{label}: output {tuple(out.shape)} {out.dtype}, expected {shape}")
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: non-finite values")


def require_launched(launches: dict, names, label: str) -> None:
    missing = [name for name in names if launches[name] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the {label} path: {missing}")


def require_tc_only(launches: dict, label: str, names=TC_ONLY) -> None:
    """The kernels ``names`` (K5 and K2, and the walk's out head) launched,
    every launch on the tensor cores."""
    off = {name: (launches[name], launches[f"{name}[tc]"]) for name in names
           if not launches[name] or launches[name] != launches[f"{name}[tc]"]}
    if off:
        raise RuntimeError(f"{label}: (launches, tensor-core launches) {off}: expected all on "
                           "the tensor cores")


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
            launches = all_launches()
            require_launched(launches, ZROW_KERNELS if route == "z-row" else FLAT_KERNELS,
                             f"small {route}")
            require_tc_only(launches, f"small {route}",
                            ZROW_TC_ONLY if route == "z-row" else FLAT_TC_ONLY)
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
        out, launches[acc] = checked_volume(validator, volume)
        check_volume(out, (512, 512, 160, 14), f"config 4 (acc {acc})")
        log(f"[slice] config 4 512x512x160 z-row walk, acc {acc} [{card}]; launches "
            f"{launches[acc]}")
        require_launched(launches[acc], ZROW_KERNELS + (K1_TC, K1_NARROW), "config-4")
        require_tc_only(launches[acc], f"config 4 (acc {acc})", ZROW_TC_ONLY)
        counts = {name: launches[acc][name] for name in CONFIG4_BATCHES}
        if counts != CONFIG4_BATCHES:
            raise RuntimeError(f"config 4: launches {counts}, expected {CONFIG4_BATCHES}")
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
    out, launches = checked_volume(validator, volume)
    check_volume(out, (240, 240, 155, 4), "config 8")
    log(f"[brats] config 8 240x240x155x4 flat walk, acc bf16 [{card}]; launches {launches}")
    require_launched(launches, FLAT_KERNELS + (K1_NARROW,), "config-8")
    require_tc_only(launches, "config 8", FLAT_TC_ONLY)
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
    require_tc_only(launches, "the CLI", ZROW_TC_ONLY)
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
    losses = [first]
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = all_launches()
    losses = [v.item() for v in losses]
    log(f"[train] UNETR-B/16 {TRAIN_BATCH}x{CROP}^3 bf16 remat, {TRAIN_STEPS} steps after a warm "
        f"one [{card}]; losses {['%.6f' % v for v in losses]}; launches {launches}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"training step: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training step: loss did not fall over {TRAIN_STEPS} steps: {losses}")
    missing = [name for name in TRAIN_KERNELS if launches[name] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched in the training steps: {missing}")
    require_tc_only(launches, "the config-5 steps", TRAIN_TC_ONLY)
    return launches


# ---- phase 9b: each path on the kernels and on the library ----------------


def library_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The filter gradient (C_out, C_in, 3, 3, 3) of a same-pad 3x3x3 conv
    by the library's conv in place of K6: on the card cuDNN on the bf16
    operands (fp32 sums, the numerics class of the JAX package's
    ``_conv_dk``), on the CPU on fp32 copies of them."""
    if not x.is_cuda:
        x, g = x.float(), g.float()
    return torch.nn.grad.conv3d_weight(x, (g.shape[1], x.shape[1], 3, 3, 3), g, padding=1)


@contextlib.contextmanager
def library_route(parts=()):
    """Within the block the parts of the training step named in ``parts``
    take the library in place of the hand kernels, as the JAX package's
    ablation switches do on its side: "convs" every 3x3x3 conv on
    ``F.conv3d`` (``conv3d.OF_MIN_HW`` past every plane; its
    ``MEDSEG_TRAIN_CONV=xla``), "wgrad" the routed convs' filter gradient on
    ``library_wgrad`` with K1's data gradient kept (``MEDSEG_WGRAD=xla``),
    "loss" the CT loss on the plain ``dice_ce_loss``
    (``MEDSEG_FUSED_LOSS=0``). Restores the port after."""
    from medseg_torch.engine import train
    from medseg_torch.kernels import conv3d, conv_of

    patches = {"convs": (conv3d, "OF_MIN_HW", float("inf")),
               "wgrad": (conv_of, "conv3x3x3_wgrad_of", library_wgrad),
               "loss": (train, "fused_loss_supported", lambda *args: False)}
    saved = [(module, name, getattr(module, name))
             for module, name, _ in (patches[part] for part in parts)]
    try:
        for part in parts:
            module, name, value = patches[part]
            setattr(module, name, value)
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def route_step_inputs(n_classes: int, batch: int, device):
    """UNETR-B/16 (bf16, remat) with ``n_classes`` outputs, its AdamW state
    (lr 1e-4, weight decay 1e-5) and one batch of 96^3 crops, all from seed
    0 (config 5: 14 classes, batch 4, the same weights and batch as phase
    9; config 2: 2 classes, batch 2)."""
    from medseg_torch.engine.state import create_train_state
    from medseg_torch.models.unetr import unetr_b16

    g = torch.Generator().manual_seed(0)
    model = unetr_b16(1, n_classes, CROP, dtype=torch.bfloat16, remat=True)
    state = create_train_state(model, generator=g, learning_rate=1e-4, weight_decay=1e-5,
                               device=device)
    image = torch.randn((batch, 1, CROP, CROP, CROP), generator=g).to(device)
    label = torch.randint(0, n_classes, (batch, CROP, CROP, CROP), generator=g,
                          dtype=torch.int32).to(device)
    return model, state, {"image": image, "label": label}


def flat_grad(model) -> torch.Tensor:
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().ravel()
                      for p in model.parameters()])


def measure_route(n_classes: int, batch: int, device) -> dict:
    """On the route in force: the loss and the flattened gradient at the
    seed's weights, then ``make_train_step``: one warm step and one whose
    kernel launches are counted."""
    from medseg_torch.engine.train import make_loss_fn, make_train_step

    model, state, b = route_step_inputs(n_classes, batch, device)
    loss = make_loss_fn("ct")(model, b["image"], b["label"])
    loss.backward()
    result = {"loss": loss.item(), "grad": flat_grad(model)}
    model.zero_grad(set_to_none=True)
    step = make_train_step(model, task="ct")
    state, _ = step(state, b)  # warm
    torch.cuda.synchronize()
    reset_launches()
    step(state, b)
    torch.cuda.synchronize()
    result["launches"] = all_launches()
    del model, state, b, step
    torch.cuda.empty_cache()
    return result


def hand_launches(r: dict) -> dict:
    """The kernels a run launched and how often (the routes' counts left out)."""
    return {k: v for k, v in r["launches"].items() if v and "[" not in k}


def check_route(label: str, r: dict, ref: dict, card: str, ref_label: str) -> None:
    loss_err = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_err = rel_l2(r["grad"], ref["grad"])
    log(f"[routes] {label}: loss {r['loss']:.6f} vs {ref_label} {ref['loss']:.6f}, rel err "
        f"{loss_err:.3e} (bound {TRAIN_LOSS_REL_BOUND}); global gradient rel L2 {grad_err:.3e} "
        f"(bound {TRAIN_GRAD_REL_L2_BOUND}) [{card}]")
    if not (loss_err <= TRAIN_LOSS_REL_BOUND and grad_err <= TRAIN_GRAD_REL_L2_BOUND):
        raise RuntimeError(f"routes, {label}: loss rel err {loss_err}, gradient rel L2 {grad_err}")


def check_replaced(label: str, r: dict, default: dict, replaced) -> None:
    """The run launched none of the kernels its library parts replace and
    the others as often as the default did ("wgrad": K1's data gradient
    still runs)."""
    bad = {k: (r["launches"][k], default["launches"][k]) for k in ROUTE_KERNELS
           if r["launches"][k] != (0 if k in replaced else default["launches"][k])}
    if bad:
        raise RuntimeError(f"routes, {label}: (launches, default's) {bad}; replaced {replaced}")


def phase_routes(device, card: str) -> dict:
    """Config 5's step on each route of ``ROUTE_RUNS``, config 2's step on
    the kernels and on the library against its fp32 module, and config 4's
    volume on the fused path and on the module forward. Returns the default
    config-2 step's launches."""
    from medseg_torch.ops.losses import dice_ce_loss

    runs = {}
    for name, (parts, _) in ROUTE_RUNS.items():
        with library_route(parts):
            runs[name] = measure_route(*ROUTE_CONFIGS["config-5"], device)

    # config 2: the fp32 module on the library, then both routes' steps
    model, _, b = route_step_inputs(*ROUTE_CONFIGS["config-2"], device)
    ref = fp32_twin(model)
    del model
    with library_route(("convs",)):  # cuDNN everywhere
        loss = dice_ce_loss(ref(b["image"], return_encoder_features=False), b["label"],
                            softmax=True, to_onehot_y=True)
        loss.backward()
    config2_ref = {"loss": loss.item(), "grad": flat_grad(ref)}
    del ref, loss, b
    torch.cuda.empty_cache()
    config2 = {}
    for name in ("default", "all-library"):
        with library_route(ROUTE_RUNS[name][0]):
            config2[name] = measure_route(*ROUTE_CONFIGS["config-2"], device)

    default = runs["default"]
    missing = [k for k in ROUTE_KERNELS if not default["launches"][k]]
    if missing:
        raise RuntimeError(f"routes: the default config-5 step did not launch {missing}")
    for name, (_, replaced) in ROUTE_RUNS.items():
        r = runs[name]
        log(f"[routes] config 5 {name}: hand kernels in one step {hand_launches(r)} [{card}]")
        if name != "default":
            check_route(f"config 5 {name}", r, default, card, "default")
            check_replaced(f"config 5 {name}", r, default, replaced)
    for name, r in config2.items():
        log(f"[routes] config 2 {name}: hand kernels in one step {hand_launches(r)} [{card}]")
        check_route(f"config 2 {name}", r, config2_ref, card, "fp32 module")
    missing = [k for k in ROUTE_KERNELS if not config2["default"]["launches"][k]]
    if missing:
        raise RuntimeError(f"routes: the default config-2 step did not launch {missing}")
    check_replaced("config 2 all-library", config2["all-library"], config2["default"],
                   ROUTE_KERNELS)
    launches = config2["default"]["launches"]
    del runs, config2, config2_ref
    torch.cuda.empty_cache()
    routes_serving(device, card)
    return launches


def routes_serving(device, card: str) -> None:
    """Config 4's volume once on the fused z-row path and once on the module
    forward through the flat walk (``use_fast_path=False``: SDPA, cuBLAS and
    cuDNN, no hand kernel: a copy of the model on ``plain_norms``): the
    fused walk launches K4, the eager one no hand kernel, and their logits
    agree within ``FWD_REL_L2_BOUND``."""
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.models.unetr import init_weights, unetr_b16
    from medseg_torch.ops.sliding_window import SlidingWindowSpec

    g = torch.Generator().manual_seed(0)
    model = init_weights(unetr_b16(1, N_CLASSES, CROP, dtype=torch.bfloat16), g).to(device).eval()
    spec = SlidingWindowSpec(roi=(CROP,) * 3, overlap=0.5, sw_batch=4, mode="gaussian")
    volume = np.random.default_rng(0).standard_normal(CONFIG4_VOLUME + (1,), dtype=np.float32)
    fused = Validator(model, N_CLASSES, "ct", spec, device=device)
    eager = Validator(plain_norms(copy.deepcopy(model)), N_CLASSES, "ct", spec,
                      use_fast_path=False, device=device)
    if not fused.use_fast_path:
        raise RuntimeError("routes: config 4's window is off the fused path")
    outs, launches = {}, {}
    for name, validator in (("fused", fused), ("eager", eager)):
        reset_launches()
        outs[name] = validator.infer_volume(volume)
        torch.cuda.synchronize()
        launches[name] = all_launches()
        check_volume(outs[name], CONFIG4_VOLUME + (N_CLASSES,), f"routes, config 4 {name}")
    launched = [k for k, v in launches["eager"].items() if v]
    if launched or not launches["fused"]["outhead_row_of"]:
        raise RuntimeError(f"routes: the eager walk launched {launched}, the fused one "
                           f"{launches['fused']}")
    err = rel_l2(outs["fused"], outs["eager"])
    agree = (outs["fused"].argmax(-1) == outs["eager"].argmax(-1)).float().mean().item()
    log(f"[routes] config 4 fused vs eager: volume logits rel L2 {err:.3e} (bound "
        f"{FWD_REL_L2_BOUND}), argmax agreement {agree:.5f} [{card}]")
    if not err <= FWD_REL_L2_BOUND:
        raise RuntimeError(f"routes: fused vs eager volume rel L2 {err}")


def pretrain_model(feature_size: int = 16):
    """UNETR-B/16's widths (ViT-B, 96^3 crops, 14 out channels) at
    ``feature_size``, bf16 compute, remat (config 5's setting)."""
    from medseg_torch.models.unetr import UNETR

    return UNETR(in_channels=1, out_channels=N_CLASSES, img_size=(CROP,) * 3,
                 feature_size=feature_size, dtype=torch.bfloat16, remat=True)


def pretrain_batch(g: torch.Generator, device) -> torch.Tensor:
    """Two seeded noise volumes of 128^3, two overlapping 96^3 crops of each,
    in the loader's order [vol1_crop1, vol1_crop2, vol2_crop1, vol2_crop2]."""
    from medseg_torch.tools.profile_pretrain import batch

    return batch(g, device)


def pretrain_indices(update_arc: str, axis: int, rng: np.random.Generator) -> np.ndarray:
    from medseg_torch.engine.pretrain import feature_dim_for_axis
    from medseg_torch.ops.ranking import sample_partition_indices

    dim = feature_dim_for_axis(CROP, update_arc, axis)
    return sample_partition_indices(rng, dim, PRETRAIN_PARTITIONS)


def compare_pretrain(model, images, update_arc: str, idx, label: str, card: str) -> None:
    """One ranking loss and its gradients through the kernels (bf16) against
    the fp32 twin without kernels (no conv routed, TF32 off), same weights,
    batch and slices (axis 0)."""
    from medseg_torch.engine.pretrain import make_pretrain_loss
    from medseg_torch.kernels import conv3d

    kw = dict(update_arc=update_arc, loss_type="ranking", num_partitions=PRETRAIN_PARTITIONS,
              temperature=PRETRAIN_TEMP)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=images.device)
    model.zero_grad(set_to_none=True)
    loss_k = make_pretrain_loss(model, **kw)(images, idx, 0)
    loss_k.backward()
    grads_k = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    ref = fp32_twin(model)
    routing = conv3d.OF_MIN_HW, conv3d.PALLAS_PER_CONV
    conv3d.OF_MIN_HW, conv3d.PALLAS_PER_CONV = float("inf"), False
    try:
        loss_r = make_pretrain_loss(ref, **kw)(images, idx, 0)
        loss_r.backward()
    finally:
        conv3d.OF_MIN_HW, conv3d.PALLAS_PER_CONV = routing
    diff2 = ref2 = got2 = 0.0
    for n, p in ref.named_parameters():
        if (p.grad is None) != (grads_k[n] is None):
            raise RuntimeError(f"pretrain {label}: {n} has a gradient on one side only")
        if p.grad is None:
            continue
        diff2 += (grads_k[n] - p.grad).square().sum().item()
        ref2 += p.grad.square().sum().item()
        got2 += grads_k[n].square().sum().item()
    del ref, grads_k
    torch.cuda.empty_cache()
    loss_k, loss_r = loss_k.item(), loss_r.item()
    loss_err = abs(loss_k - loss_r) / abs(loss_r)
    grad_err = (diff2 / ref2) ** 0.5
    log(f"[{label}] loss bf16 kernels {loss_k:.6f} vs fp32 module {loss_r:.6f}: rel err "
        f"{loss_err:.3e} (bound {PRETRAIN_LOSS_REL_BOUND}); global gradient norm {got2 ** 0.5:.6e} "
        f"vs {ref2 ** 0.5:.6e}, rel L2 {grad_err:.3e} (bound {PRETRAIN_GRAD_REL_L2_BOUND})")
    if not (np.isfinite(loss_k) and loss_err <= PRETRAIN_LOSS_REL_BOUND
            and grad_err <= PRETRAIN_GRAD_REL_L2_BOUND):
        raise RuntimeError(f"pretrain {label}: loss rel err {loss_err}, gradient rel L2 {grad_err}")


def time_pretrain_steps(step, state, images, update_arc: str, rng) -> tuple[float, float]:
    """One warm step, then PRETRAIN_TIMED_STEPS steps, each read back with
    ``float(loss)`` as the CLI does; ms/step and peak GiB."""
    state, loss = step(state, images, pretrain_indices(update_arc, 0, rng), axis=0)
    float(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(PRETRAIN_TIMED_STEPS):
        state, loss = step(state, images, pretrain_indices(update_arc, 0, rng), axis=0)
        float(loss)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / PRETRAIN_TIMED_STEPS
    return ms, torch.cuda.max_memory_allocated() / 2**30


def phase_pretrain(device, card: str) -> dict:
    """Ranking pretraining of UNETR-B/16 through ``make_pretrain_step``: the
    feat stage, then the recon stage on the same state; per stage one
    ranking step on each axis and one contrastive step (launches counted),
    then the timed steps."""
    from medseg_torch.engine.pretrain import make_pretrain_step
    from medseg_torch.engine.state import create_train_state

    g = torch.Generator().manual_seed(0)
    model = pretrain_model()
    state = create_train_state(model, generator=g, learning_rate=1e-4, weight_decay=1e-5,
                               device=device)
    images = pretrain_batch(g, device)
    rng = np.random.default_rng(0)
    launches = {}
    for arc in ("feat", "recon"):
        compare_pretrain(model, images, arc, pretrain_indices(arc, 0, rng), f"pretrain-{arc}", card)
        steps = {loss: make_pretrain_step(model, update_arc=arc, loss_type=loss,
                                          num_partitions=PRETRAIN_PARTITIONS,
                                          temperature=PRETRAIN_TEMP)
                 for loss in ("ranking", "contrastive")}
        reset_launches()
        losses = []
        for axis in (0, 1, 2):
            state, loss = steps["ranking"](state, images, pretrain_indices(arc, axis, rng), axis=axis)
            losses.append(loss)
        state, loss = steps["contrastive"](state, images, pretrain_indices(arc, 0, rng), axis=0)
        losses.append(loss)
        torch.cuda.synchronize()
        launches[f"pretrain-{arc}"] = counts = all_launches()
        losses = [v.item() for v in losses]
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"pretrain {arc}: non-finite loss {losses}")
        if arc == "recon":
            moved = [n for n, p in model.named_parameters()
                     if n.startswith("vit.") and p.grad.count_nonzero().item()]
            if moved:
                raise RuntimeError(f"pretrain recon: frozen ViT parameters got gradients: {moved}")
            require_launched(counts, RECON_KERNELS, "pretrain recon")
        elif any(counts[name] for name in RECON_KERNELS):
            raise RuntimeError(f"pretrain feat ran the decoder's kernels: {counts}")
        ms, peak = time_pretrain_steps(steps["ranking"], state, images, arc, rng)
        log(f"[pretrain-{arc}] UNETR-B/16 4x{CROP}^3 bf16 remat: {ms:.2f} ms/step, peak "
            f"{peak:.1f} GiB [{card}]; losses (ranking axes 0/1/2, contrastive) "
            f"{['%.6f' % v for v in losses]}; launches {counts}")
    del model, state, images
    torch.cuda.empty_cache()
    return launches


def phase_pretrain_flat(device, card: str) -> dict:
    """The recon step at feature size 32 with the flat per-conv route on:
    decoder3.conv1 (128 -> 64 at 48^3) runs through K9."""
    from medseg_torch.engine.pretrain import make_pretrain_step
    from medseg_torch.engine.state import create_train_state
    from medseg_torch.kernels import conv3d

    g = torch.Generator().manual_seed(1)
    model = pretrain_model(feature_size=32)
    state = create_train_state(model, generator=g, learning_rate=1e-4, weight_decay=1e-5,
                               device=device)
    images = pretrain_batch(g, device)
    rng = np.random.default_rng(1)
    route = conv3d.PALLAS_PER_CONV
    conv3d.PALLAS_PER_CONV = True
    try:
        compare_pretrain(model, images, "recon", pretrain_indices("recon", 0, rng),
                         "pretrain-flat", card)
        step = make_pretrain_step(model, update_arc="recon", loss_type="ranking",
                                  num_partitions=PRETRAIN_PARTITIONS, temperature=PRETRAIN_TEMP)
        reset_launches()
        state, loss = step(state, images, pretrain_indices("recon", 0, rng), axis=0)
        loss = loss.item()
        launches = all_launches()
        ms, peak = time_pretrain_steps(step, state, images, "recon", rng)
    finally:
        conv3d.PALLAS_PER_CONV = route
    log(f"[pretrain-flat] UNETR-B (feature size 32) recon 4x{CROP}^3 bf16 remat, flat route on: "
        f"{ms:.2f} ms/step, peak {peak:.1f} GiB [{card}]; loss {loss:.6f}; launches {launches}")
    if not np.isfinite(loss):
        raise RuntimeError(f"pretrain flat: non-finite loss {loss}")
    k9 = (launches["conv3x3x3_flat"], launches["conv3x3x3_flat[tc]"])
    if k9 != (FLAT_LAUNCHES_PER_STEP,) * 2:
        raise RuntimeError(f"pretrain flat: (K9 launches, on the tensor cores) {k9} in one recon "
                           f"step, expected {FLAT_LAUNCHES_PER_STEP} of each")
    require_launched(launches, RECON_KERNELS, "pretrain flat")
    del model, state, images
    torch.cuda.empty_cache()
    return launches


def phase_pretrain_cli(device, card: str) -> dict:
    """The pretraining CLI end to end on a synthetic abdomenCT directory of
    four CT volumes (1.5 x 1.5 x 2 mm voxels): one fold of two, one epoch per
    stage, checkpoints every 2 steps, the default full-width model in bf16."""
    from medseg_torch.cli import pretraining
    from medseg_torch.data.nifti import write_nifti

    rng = np.random.default_rng(3)
    affine = np.diag([1.5, 1.5, 2.0, 1.0])
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data", "abdomenCT")
        os.makedirs(os.path.join(root, "imagesTr"))
        entries = []
        for i in range(4):
            image = rng.normal(100.0, 80.0, size=CLI_PRETRAIN_VOLUME).astype(np.float32)
            write_nifti(os.path.join(root, "imagesTr", f"ct{i}.nii.gz"), image, affine)
            entries.append({"image": f"imagesTr/ct{i}.nii.gz"})
        with open(os.path.join(root, "dataset.json"), "w") as f:
            json.dump({"training": entries}, f)
        argv = [os.path.join(tmp, "data"), "abdomenCT", os.path.join(tmp, "out"), str(N_CLASSES),
                "1e-4", str(PRETRAIN_TEMP), "ranking", "--bf16", "--folds", "2", "--max-folds",
                "1", "--max-iterations", "1", "--eval-num", "2", "--no-progress"]
        args = pretraining.build_parser().parse_args(argv)
        plot = pretraining.plot_loss_vs_time
        artifact = ".png"
        if importlib.util.find_spec("matplotlib") is None:
            artifact = ".npy"
            log("[pretrain-cli] matplotlib is not installed on this machine: in this phase only, "
                "the loss-vs-time figure is replaced by an .npy file of its series")
            pretraining.plot_loss_vs_time = lambda path, losses, times: np.save(
                path[: -len(".png")] + artifact, np.stack([losses, times]))
        reset_launches()
        t0 = time.perf_counter()
        try:
            with NativeCalls() as calls:
                out_dirs = pretraining.main(argv)
        finally:
            pretraining.plot_loss_vs_time = plot
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
        if len(out_dirs) != 1:
            raise RuntimeError(f"pretraining CLI ran folds {out_dirs}")
        steps = 0
        for arc in pretraining.STAGES:
            stage = os.path.join(out_dirs[0], pretraining.stage_prefix(args, arc))
            for path in (os.path.join(stage, "best", "model.pt"),
                         os.path.join(stage, "best", "train.pt"), stage + "_loss_vs_time" + artifact):
                if not os.path.exists(path):
                    raise RuntimeError(f"pretraining CLI did not write {path}")
            with open(os.path.join(stage, "meta.json")) as f:
                meta = json.load(f)
            if meta.get("completed") != 1:
                raise RuntimeError(f"pretraining CLI: stage {arc} not marked completed: {meta}")
            steps = meta["step"]
    log(f"[pretrain-cli] medseg_torch.cli.pretraining --bf16 on 2 of 4 CT volumes "
        f"{'x'.join(map(str, CLI_PRETRAIN_VOLUME))} at 1.5x1.5x2 mm (one fold, one epoch per stage): "
        f"{steps} steps in {seconds:.2f} s end to end, {steps / seconds:.3f} steps/s (host "
        f"preprocessing through the native library, both stages, checkpoints) [{card}]; native "
        f"calls {calls.counts}; launches {launches}")
    calls.require(NATIVE_CALLS[:2], "pretraining CLI")
    require_launched(launches, RECON_KERNELS, "pretraining CLI")
    return launches


class SegCliProbe:
    """Wrappers around the segmentation CLI's train step, ``Validator.__call__``
    and ``predict_mask``, and the Hausdorff metric, for one CLI run: each
    step's seconds (synchronized), peak memory and kernel launches; each
    validation's seconds, volumes, walks, launches and Hausdorff seconds."""

    def __init__(self, seg) -> None:
        from medseg_torch.engine import evaluate
        from medseg_torch.ops import metrics

        self.seg, self.evaluate, self.metrics = seg, evaluate, metrics
        self.steps: list[dict] = []
        self.validations: list[dict] = []
        self.predictions: list[tuple] = []  # (image shape, the walk, seconds)

    def __enter__(self):
        from medseg_torch.ops.sliding_window import zrow_supported

        seg, Validator, metrics = self.seg, self.evaluate.Validator, self.metrics
        self._saved = (seg.make_train_step, Validator.__call__, Validator.predict_mask,
                       metrics.hausdorff_distance)
        make_step, call, predict, hausdorff = self._saved
        probe = self

        def make_train_step(model, **kw):
            step = make_step(model, **kw)

            def timed(state, batch):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = all_launches()
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                probe.steps.append({
                    "seconds": time.perf_counter() - t0,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": diff_launches(all_launches(), before),
                })
                return out
            return timed

        def validator_call(self, volumes, *, all_metrics=False):
            record = {"all_metrics": all_metrics, "volumes": 0, "hausdorff_seconds": 0.0}
            probe.validations.append(record)

            def counted():
                for volume in volumes:
                    record["volumes"] += 1
                    yield volume

            torch.cuda.synchronize()
            before = all_launches()
            t0 = time.perf_counter()
            result = call(self, counted(), all_metrics=all_metrics)
            torch.cuda.synchronize()
            record["seconds"] = time.perf_counter() - t0
            record["launches"] = diff_launches(all_launches(), before)
            return result

        def predict_mask(self, image, spec=None):
            shape = tuple(int(v) for v in image.shape[-4:-1])
            walk = "z-row" if zrow_supported(shape, spec or self.spec) else "flat"
            t0 = time.perf_counter()
            mask = predict(self, image, spec)
            torch.cuda.synchronize()
            probe.predictions.append((shape, walk, time.perf_counter() - t0))
            return mask

        def timed_hausdorff(*args, **kw):
            t0 = time.perf_counter()
            value = hausdorff(*args, **kw)
            probe.validations[-1]["hausdorff_seconds"] += time.perf_counter() - t0
            return value

        seg.make_train_step = make_train_step
        Validator.__call__, Validator.predict_mask = validator_call, predict_mask
        metrics.hausdorff_distance = timed_hausdorff
        return self

    def __exit__(self, *exc) -> None:
        (self.seg.make_train_step, self.evaluate.Validator.__call__,
         self.evaluate.Validator.predict_mask, self.metrics.hausdorff_distance) = self._saved

    def step_launches(self) -> dict:
        return sum_launches(step["launches"] for step in self.steps)


def diff_launches(after: dict, before: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


def sum_launches(counts) -> dict:
    total: dict = {}
    for c in counts:
        for name, n in c.items():
            total[name] = total.get(name, 0) + n
    return total


def write_ct_task(root: str, rng: np.random.Generator, n: int) -> None:
    """``n`` CT volumes of SEG_CT_VOLUME voxels at 1.5 x 1.5 x 2 mm: soft
    tissue (-100 HU) with one box-shaped organ of each of the 13 foreground
    classes (40 + 8k HU), at seeded sizes and places in a 4 x 4 grid of
    columns, so that every class has a surface."""
    from medseg_torch.data.nifti import write_nifti

    affine = np.diag([1.5, 1.5, 2.0, 1.0])
    x, y, z = SEG_CT_VOLUME
    os.makedirs(os.path.join(root, "imagesTr"))
    os.makedirs(os.path.join(root, "labelsTr"))
    entries = []
    for i in range(n):
        image = rng.normal(-100.0, 30.0, size=SEG_CT_VOLUME).astype(np.float32)
        label = np.zeros(SEG_CT_VOLUME, np.float32)
        for k in range(1, N_CLASSES):
            cx, cy = (k - 1) % 4 * (x // 4), (k - 1) // 4 * (y // 4)
            sx, sy, sz = rng.integers(10, x // 4 - 4), rng.integers(10, y // 4 - 4), rng.integers(16, z // 2)
            ox, oy, oz = cx + rng.integers(2, x // 4 - sx), cy + rng.integers(2, y // 4 - sy), rng.integers(4, z - sz - 4)
            box = (slice(ox, ox + sx), slice(oy, oy + sy), slice(oz, oz + sz))
            label[box] = k
            image[box] = rng.normal(40.0 + 8 * k, 20.0, size=(sx, sy, sz))
        write_nifti(os.path.join(root, "imagesTr", f"ct{i}.nii"), image, affine)
        write_nifti(os.path.join(root, "labelsTr", f"ct{i}.nii"), label, affine)
        entries.append({"image": f"imagesTr/ct{i}.nii", "label": f"labelsTr/ct{i}.nii"})
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"training": entries}, f)


def write_brats_task(root: str, rng: np.random.Generator, n: int) -> None:
    """``n`` four-channel MRI volumes of SEG_MRI_VOLUME voxels at 1 mm: noise
    with a seeded tumour of nested spheres (edema 1, non-enhancing core 2,
    enhancing core 3) that each channel sees brighter."""
    from medseg_torch.data.nifti import write_nifti

    os.makedirs(os.path.join(root, "imagesTr"))
    os.makedirs(os.path.join(root, "labelsTr"))
    grid = np.stack(np.meshgrid(*map(np.arange, SEG_MRI_VOLUME), indexing="ij"), -1)
    entries = []
    for i in range(n):
        centre = rng.integers(np.array(SEG_MRI_VOLUME) // 4, 3 * np.array(SEG_MRI_VOLUME) // 4)
        r = np.sqrt(((grid - centre) ** 2).sum(-1))
        label = np.zeros(SEG_MRI_VOLUME, np.float32)
        for k, radius in ((1, rng.uniform(22, 32)), (2, rng.uniform(10, 16)), (3, rng.uniform(4, 8))):
            label[r < radius] = k
        image = rng.normal(0.0, 1.0, size=SEG_MRI_VOLUME + (4,)).astype(np.float32)
        image += (label[..., None] * np.array([0.5, 1.0, 0.8, 1.2], np.float32))
        write_nifti(os.path.join(root, "imagesTr", f"mri{i}.nii"), image)
        write_nifti(os.path.join(root, "labelsTr", f"mri{i}.nii"), label)
        entries.append({"image": f"imagesTr/mri{i}.nii", "label": f"labelsTr/mri{i}.nii"})
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"training": entries}, f)


def seg_cli_files(out_dir: str, checkpoints: tuple, figures: tuple) -> None:
    """The CLI's checkpoints, metric series and figures are on disk."""
    paths = [os.path.join(out_dir, "checkpoints", name, f) for name in checkpoints
             for f in ("model.pt", "train.pt")]
    paths += [os.path.join(out_dir, "checkpoints", "meta.json")]
    paths += [os.path.join(out_dir, f"lr_0.0001_{s}.npy") for s in ("loss", "dice")]
    paths += [os.path.join(out_dir, f"final_{m}_per_class.npy") for m in SEG_METRICS]
    paths += [os.path.join(out_dir, f) for f in figures]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise RuntimeError(f"segmentation CLI did not write {missing}")


def seg_cli_figures(label: str) -> tuple:
    """The curves and overlays, or where matplotlib is not installed, the
    overlays' .npy (the curves are then their loss and Dice series)."""
    from medseg_torch.cli import segmentation

    if segmentation.have_matplotlib():
        return ("curves.png", "overlays.pdf")
    log(f"[{label}] matplotlib is not installed on this machine: the CLI leaves the curves to "
        "their .npy series and writes the overlays as overlays.npy")
    return ("overlays.npy",)


def check_seg_metrics(result: dict, out_dir: str, label: str) -> None:
    """Finite mean Dice, precision and recall; per class a finite Dice and
    recall (every class is in every label), a finite or NaN precision (NaN
    where the class was never predicted) and Hausdorff (NaN where either mask
    is empty)."""
    per = {m: np.load(os.path.join(out_dir, f"final_{m}_per_class.npy")) for m in SEG_METRICS}
    bad = [m for m in ("dice", "precision", "recall") if not np.isfinite(result[m])]
    bad += [m for m in ("dice", "recall") if not np.isfinite(per[m]).all()]
    bad += [m for m in ("precision", "hausdorff") if np.isinf(per[m]).any()]
    if bad:
        raise RuntimeError(f"{label}: metrics {bad} not as the contract allows: {result}, {per}")


def phase_seg_cli(device, card: str) -> dict:
    """The segmentation CLI end to end on a synthetic abdomenCT directory of
    four CT volumes with 14 classes: ``train`` (one fold of two, 4 steps of
    one volume x 4 crops of 96^3, bf16, device augmentation, a validation
    every 2 steps and "latest" every 2), then ``eval`` of the best
    checkpoint, which must reproduce the final metrics."""
    from medseg_torch.cli import segmentation

    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as tmp:
        write_ct_task(os.path.join(tmp, "data", "abdomenCT"), rng, 4)
        argv = [os.path.join(tmp, "data"), "abdomenCT", os.path.join(tmp, "out"),
                str(N_CLASSES), "", "train", "1e6", "1e-4", "--bf16", "--folds", "2",
                "--max-folds", "1", "--max-iterations", "4", "--eval-num", "2",
                "--save-latest-every", "2", "--device-augment", "--no-progress"]
        reset_launches()
        t0 = time.perf_counter()
        with SegCliProbe(segmentation) as train, NativeCalls() as calls:
            result = segmentation.main(argv)[0]
        train_seconds = time.perf_counter() - t0
        argv[5] = "eval"
        with SegCliProbe(segmentation) as evaluation:
            again = segmentation.main(argv)[0]
        torch.cuda.synchronize()
        launches = all_launches()
        out_dir = os.path.join(tmp, "out", "abdomenCT_0")
        figures = seg_cli_figures("seg-cli")
        seg_cli_files(out_dir, ("best", "latest"), figures)
        check_seg_metrics(result, out_dir, "seg-cli")
    # eval mode must reproduce all four final metrics exactly: the forward is
    # bitwise reproducible (K1, K2 and K5 add their statistics in a fixed
    # order) and eval restores the same best checkpoint; the differences are
    # printed
    diffs = {m: 0.0 if np.isnan(again[m]) and np.isnan(result[m]) else abs(again[m] - result[m])
             for m in SEG_METRICS}
    if any(diffs.values()):
        raise RuntimeError(f"seg-cli: eval mode {again} does not reproduce the final metrics "
                           f"{result} exactly: differences {diffs}")
    steps = [s["seconds"] for s in train.steps]
    dice_only = [v for v in train.validations if not v["all_metrics"]]
    final = [v for v in train.validations if v["all_metrics"]][0]
    per_volume = sum(v["seconds"] for v in dice_only) / sum(v["volumes"] for v in dice_only)
    infer = [sec for _, walk, sec in train.predictions]
    walks = sorted({(shape, walk) for shape, walk, _ in train.predictions})
    log(f"[seg-cli] medseg_torch.cli.segmentation train --bf16 --device-augment, UNETR-B/16 "
        f"abdomenCT 14 classes, 4 CT volumes {'x'.join(map(str, SEG_CT_VOLUME))} at 1.5x1.5x2 mm "
        f"(one fold: 2 train / 2 val): {len(steps)} steps, {(len(steps) - 1) / sum(steps[1:]):.3f} "
        f"train steps/s after the first (step s {['%.3f' % v for v in steps]}, peak "
        f"{max(s['peak_gib'] for s in train.steps):.1f} GiB); validation {per_volume:.3f} s per "
        f"volume ({len(dice_only)} Dice validations, sliding-window inference "
        f"{['%.3f' % v for v in infer]} s per call; walks {walks}); final evaluation "
        f"{final['seconds']:.3f} s for {final['volumes']} volumes, Hausdorff "
        f"{final['hausdorff_seconds']:.3f} s ({100 * final['hausdorff_seconds'] / final['seconds']:.1f}%); "
        f"CLI train run {train_seconds:.1f} s end to end, the host chain through the native "
        f"library (calls {calls.counts}) [{card}]")
    log(f"[seg-cli] final: dice {result['dice']:.5f} precision {result['precision']:.5f} recall "
        f"{result['recall']:.5f} hausdorff {result['hausdorff']:.3f}; eval mode's differences "
        f"{diffs} (expected 0 each); figures {figures}; "
        f"eval-mode final evaluation {evaluation.validations[0]['seconds']:.3f} s; launches "
        f"{launches}")
    calls.require(NATIVE_CALLS[1:], "seg-cli")
    require_launched(launches, TRAIN_KERNELS + ZROW_KERNELS, "seg-cli")
    require_launched(train.step_launches(), TRAIN_KERNELS, "seg-cli train step")
    require_tc_only(final["launches"], "the seg-cli final evaluation", ZROW_TC_ONLY)
    if ("z-row" not in {walk for _, walk in walks}):
        raise RuntimeError(f"seg-cli: no validation volume took the z-row walk: {walks}")
    return launches


def phase_seg_cli_mri(device, card: str) -> dict:
    """The segmentation CLI on a synthetic Task01_BrainTumour directory (four
    4-channel volumes, labels 0-3, n_classes 4): one fold, 2 steps of one
    volume x 4 crops of 128^3, bf16, sigmoid DiceCE, a validation after
    step 2, the final evaluation."""
    from medseg_torch.cli import segmentation

    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as tmp:
        write_brats_task(os.path.join(tmp, "data", "Task01_BrainTumour"), rng, 4)
        argv = [os.path.join(tmp, "data"), "Task01_BrainTumour", os.path.join(tmp, "out"), "4", "",
                "train", "1e6", "1e-4", "--bf16", "--folds", "2", "--max-folds", "1",
                "--max-iterations", "2", "--eval-num", "2", "--no-progress"]
        reset_launches()
        with SegCliProbe(segmentation) as probe:
            result = segmentation.main(argv)[0]
        torch.cuda.synchronize()
        launches = all_launches()
        out_dir = os.path.join(tmp, "out", "Task01_BrainTumour_0")
        seg_cli_files(out_dir, ("best",), seg_cli_figures("seg-cli-mri"))
        check_seg_metrics(result, out_dir, "seg-cli-mri")
    step = probe.step_launches()
    validation = sum_launches(v["launches"] for v in probe.validations)
    walks = {walk for shape, walk, _ in probe.predictions[: sum(v["volumes"] for v in probe.validations)]}
    head = "outhead_row_of" if walks == {"z-row"} else "outhead_of"
    log(f"[seg-cli-mri] medseg_torch.cli.segmentation train --bf16, UNETR-B/16 Task01_BrainTumour "
        f"(4 channels, sigmoid DiceCE), 4 volumes {'x'.join(map(str, SEG_MRI_VOLUME))}: step ms "
        f"{['%.2f' % (1e3 * s['seconds']) for s in probe.steps]} (4 crops of 128^3), peak "
        f"{max(s['peak_gib'] for s in probe.steps):.1f} GiB [{card}]; validation walks {walks} "
        f"(out head {head}); final dice {result['dice']:.5f} precision {result['precision']:.5f} "
        f"recall {result['recall']:.5f} hausdorff {result['hausdorff']:.3f}; step launches {step}; "
        f"launches {launches}")
    if len(walks) != 1:
        raise RuntimeError(f"seg-cli-mri: validation walks {walks}")
    require_launched(step, (K1_NARROW, K6_NARROW), "seg-cli-mri train step's narrow-input")
    require_tc_only(step, "the seg-cli-mri train step", TRAIN_TC_ONLY)
    if step["dice_ce_sums"] or step["dice_ce_bwd"]:
        raise RuntimeError(f"seg-cli-mri: the sigmoid loss launched K7/K8: {step}")
    require_launched(validation, (head,), "seg-cli-mri validation")
    return launches


def phase_determinism(device, card: str) -> dict:
    """K1, K2, K5 and K6 twice on both routes at the path's shapes (the
    narrow-input kernels of K1 and K6 among them), and the fused
    forward twice on four 96^3 windows: every output, statistic and logit
    the same bits (``tools/probe_determinism.py``'s checks)."""
    from medseg_torch.kernels import kernel_check
    from medseg_torch.models.unetr import init_weights, unetr_b16
    from medseg_torch.tools import probe_determinism

    reset_launches()
    failed = probe_determinism.kernels(
        device, card, names=DETERMINISM_KERNELS, calls=2, label="determinism",
        cases_fns=(kernel_check.kernel_cases, kernel_check.brats_cases,
                   kernel_check.training_cases, kernel_check.mri_training_cases))
    g = torch.Generator().manual_seed(0)
    model = init_weights(unetr_b16(1, N_CLASSES, CROP, dtype=torch.bfloat16), g).to(device).eval()
    x = torch.randn((4, 1, CROP, CROP, CROP), generator=g).to(device)
    if not probe_determinism.fused_forward(model, x, card, "determinism"):
        failed.append("fused forward")
    torch.cuda.synchronize()
    launches = all_launches()
    log(f"[determinism] {'every case bitwise' if not failed else failed}; launches {launches}")
    routes = {name: (launches[name], launches[f"{name}[tc]"]) for name in DETERMINISM_KERNELS}
    if not all(n > tc > 0 for n, tc in routes.values()):
        raise RuntimeError(f"determinism: (launches, tensor-core launches) {routes}: each of K1, "
                           "K2, K5 and K6 must run on both routes")
    require_launched(launches, (K1_NARROW, K6_NARROW), "determinism")
    if failed:
        raise RuntimeError(f"not bitwise reproducible: {failed}")
    return launches


def phase_dp(device, card: str) -> dict:
    """The slice's paths on a real NCCL process group of one rank: config
    5's data-parallel step against the step without a mesh, and the sharded
    z-row and flat walks against the unsharded ones."""
    import torch.distributed as dist

    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.engine.state import create_train_state
    from medseg_torch.engine.train import make_train_step
    from medseg_torch.models.unetr import unetr_b16
    from medseg_torch.ops.sliding_window import SlidingWindowSpec, zrow_supported
    from medseg_torch.parallel import make_mesh
    from medseg_torch.tools.dryrun_multichip import Launches

    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(device)
        path = Launches()  # the data-parallel path's launches, not its references'
        states = [create_train_state(unetr_b16(1, N_CLASSES, CROP, dtype=torch.bfloat16,
                                               remat=True),
                                     generator=torch.Generator().manual_seed(0),
                                     learning_rate=DP_LR, weight_decay=1e-5, device=device)
                  for _ in range(2)]
        g = torch.Generator().manual_seed(1)
        batch = {"image": torch.randn((TRAIN_BATCH, 1, CROP, CROP, CROP), generator=g).to(device),
                 "label": torch.randint(0, N_CLASSES, (TRAIN_BATCH, CROP, CROP, CROP), generator=g,
                                        dtype=torch.int32).to(device)}
        steps = {"mesh": make_train_step(states[0].model, task="ct", mesh=mesh),
                 "no mesh": make_train_step(states[1].model, task="ct")}
        ms = {label: [] for label in steps}
        losses = {label: [] for label in steps}
        # a warm step each, then timed blocks in turns (host-bound steps vary)
        for block, label in enumerate(("mesh", "no mesh", "no mesh", "mesh", "mesh", "no mesh")):
            i = 0 if label == "mesh" else 1
            with path if label == "mesh" else Launches():
                if block < 2:
                    states[i], first = steps[label](states[i], batch)  # warm
                    losses[label].append(first)
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DP_STEPS):
                    states[i], loss = steps[label](states[i], batch)
                    losses[label].append(loss)
                torch.cuda.synchronize()
            ms[label].append(1e3 * (time.perf_counter() - t0) / DP_STEPS)
        losses = {label: ["%.6f" % v.item() for v in out] for label, out in losses.items()}
        pairs = list(zip(states[0].model.parameters(), states[1].model.parameters()))
        bitwise = all(torch.equal(p, q) for p, q in pairs)
        diff = max((p - q).abs().max().item() for p, q in pairs)
        bound = 2 * DP_LR * (2 * DP_STEPS + 1)
        log(f"[dp] config 5 step through make_train_step(mesh=NCCL world 1): "
            f"{['%.2f' % v for v in ms['mesh']]} ms/step vs {['%.2f' % v for v in ms['no mesh']]} "
            f"without a mesh (blocks of {DP_STEPS} in turns) [{card}]; parameters after "
            f"{2 * DP_STEPS + 1} steps {'bitwise equal' if bitwise else 'differ'} "
            f"(largest |diff| {diff:.3e}, bound {bound:.1e}); losses mesh {losses['mesh']} vs "
            f"{losses['no mesh']}; step launches {path.counts}")
        if not (bitwise or diff <= bound):
            raise RuntimeError(f"dp: the data-parallel step's parameters differ by {diff}")
        require_launched(path.counts, TRAIN_KERNELS, "dp step")
        model = states[0].model.eval()
        del states, batch, pairs
        torch.cuda.empty_cache()

        rng = np.random.default_rng(8)
        spec = SlidingWindowSpec(roi=(CROP,) * 3, overlap=0.25, sw_batch=4, bucket_multiple=32)
        walks = {}
        for shape, walk in (((192, 192, 191), "z-row"), (FLAT_SHARDED_VOLUME, "flat")):
            if zrow_supported(shape, spec) != (walk == "z-row"):
                raise RuntimeError(f"{shape} should take the {walk} walk")
            volume = rng.standard_normal(shape + (1,), dtype=np.float32)
            sharded = Validator(model, N_CLASSES, "ct", spec, device=device, mesh=mesh)
            single = Validator(model, N_CLASSES, "ct", spec, device=device)
            walks[walk] = Launches()
            with walks[walk], path:
                got, seconds = warm_then_timed(sharded, volume)
            want, single_seconds = warm_then_timed(single, volume)
            check_volume(got, shape + (N_CLASSES,), f"dp {walk}")
            same = torch.equal(got, want)
            log(f"[dp] Validator(mesh=NCCL world 1) {'x'.join(map(str, shape))}, sharded {walk} "
                f"walk: {seconds:.3f} s/volume vs {single_seconds:.3f} unsharded [{card}]; "
                f"{'bitwise equal' if same else 'DIFFERENT'} (largest |diff| "
                f"{(got - want).abs().max().item():.3e}); launches {walks[walk].counts}")
            if not same:
                raise RuntimeError(f"dp: the sharded {walk} walk at one rank is not the unsharded")
        require_launched(walks["z-row"].counts, ZROW_KERNELS, "dp sharded z-row walk")
        require_tc_only(walks["z-row"].counts, "the dp sharded z-row walk", ZROW_TC_ONLY)
        require_launched(walks["flat"].counts, FLAT_KERNELS, "dp sharded flat walk")
        require_tc_only(walks["flat"].counts, "the dp sharded flat walk", FLAT_TC_ONLY)
        log(f"[dp] collectives issued to the NCCL group: {mesh.collectives}")
    finally:
        dist.destroy_process_group()
    return path.counts


def phase_dp2(device, card: str) -> dict:
    """Two processes on the one card (gloo): the data-parallel gradient and
    the sharded walk against one process, then the segmentation CLI at two
    ranks."""
    from medseg_torch.tools import dryrun_multichip

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports, bad = dryrun_multichip.launch(2, "cuda", "full", steps=3, timeout=DP2_TIMEOUT)
    seconds = time.perf_counter() - t0
    r0 = reports[0]
    log(f"[dp-2] UNETR-B/16 bf16 remat, 2 ranks x 2 crops of {CROP}^3 on one card "
        f"({', '.join(r['backend'] for r in reports)}): global gradient vs one process on 4 crops "
        f"rel L2 {r0['grad_rel_l2']:.3e} (bound {dryrun_multichip.GRAD_REL_L2_BOUND['full']}), vs "
        f"the same halves in one process {r0['grad_halves_rel_l2']:.3e} (bound "
        f"{dryrun_multichip.HALVES_REL_L2_BOUND}); "
        f"step {r0['step_ms']:.1f} ms (rank 1 {reports[1]['step_ms']:.1f}) [{card}]; sharded "
        f"z-row walk 192x192x191 at 2 ranks {r0['walk_seconds']:.3f} s/volume vs "
        f"{r0['walk_seconds_single_process']:.3f} at one (fp32 accumulator): largest |diff| "
        f"{r0['walk_max_abs_diff']:.3e} of {r0['walk_largest_logit']:.3f}, argmax agreement "
        f"{r0['argmax_agreement']:.7f}, ranks identical {all(r['ranks_identical'] for r in reports)}"
        f", counts exact {r0['counts_equal']}; collectives {[r['collectives'] for r in reports]}; "
        f"{seconds:.1f} s for the run")
    if bad:
        raise RuntimeError(f"dp-2: {bad}")
    launches = sum_launches(r["launches"] for r in reports)

    rng = np.random.default_rng(9)
    with tempfile.TemporaryDirectory() as tmp:
        write_ct_task(os.path.join(tmp, "data", "abdomenCT"), rng, 4)
        argv = [os.path.join(tmp, "data"), "abdomenCT", os.path.join(tmp, "out"),
                str(N_CLASSES), "", "train", "1e6", "1e-4", "--bf16", "--folds", "2",
                "--max-folds", "1", "--max-iterations", "2", "--eval-num", "2",
                "--device-augment", "--data-parallel", "--no-progress"]
        t0 = time.perf_counter()
        cli, bad = dryrun_multichip.launch(2, "cuda", cli_argv=argv, timeout=DP2_TIMEOUT)
        wall = time.perf_counter() - t0
        out_dir = os.path.join(tmp, "out", "abdomenCT_0")
        expected = [os.path.join(out_dir, f"lr_0.0001_train_size_1000000_host{r}_logger.txt")
                    for r in range(2)]
        expected.append(os.path.join(out_dir, "checkpoints", "best", "model.pt"))
        missing = [p for p in expected if not os.path.exists(p)]
    steps = cli[0]["step_seconds"]
    log(f"[dp-2] medseg_torch.cli.segmentation --data-parallel on 2 processes (one card, gloo), "
        f"abdomenCT 14 classes, one volume x 4 crops per rank: steps {['%.3f' % v for v in steps]}"
        f" s ({(len(steps) - 1) / sum(steps[1:]):.3f} steps/s after the first), CLI "
        f"{cli[0]['cli_seconds']:.1f} s in rank 0, {wall:.1f} s wall for both [{card}]; final "
        f"dice per rank {[r['final'][0]['dice'] for r in cli]}, saves per rank "
        f"{[r['saves'] for r in cli]}")
    if bad or missing:
        raise RuntimeError(f"dp-2 CLI: {bad}, missing {missing}")
    launches = sum_launches([launches] + [r["launches"] for r in cli])
    require_launched(launches, TRAIN_KERNELS + ZROW_KERNELS, "dp-2")
    return launches


def kernel_rows(table: dict, paths: dict) -> list[dict]:
    """The kernel JSON line's rows: per kernel of ``KERNELS`` its launches on
    its home path and on each path, its largest error and its timed case's
    numbers (``table``, from ``phase_kernels``)."""
    kernels = []
    for name, (src, tpu, _) in KERNELS.items():
        row = table[name]
        home = paths[HOME_PATH.get(name, "serving")]
        kernel = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": home[name],
            "launches_by_path": {path: launches[name] for path, launches in paths.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library_channels_last_ms": row["library_cl_ms"],
            "device_ms": row.get("device_ms"),
            "fp32_ms": row.get("fp32_ms"), "fp32_library_ms": row.get("fp32_library_ms"),
            "fp32_library_channels_last_ms": row.get("fp32_library_cl_ms"),
            "timed_route": row.get("timed_route"),
        }
        if name in CUDA_CORE_SOURCES:  # K1-K6, K9: the launches of each of their routes
            tc = f"{name}[tc]"
            kernel.update({
                "cuda_core_source": CUDA_CORE_SOURCES[name],
                "tc_launches": home[tc],
                "tc_launches_by_path": {path: launches[tc] for path, launches in paths.items()},
            })
        kernels.append(kernel)
    return kernels


def main() -> int:
    from medseg_torch.kernels import kernel_check

    t_start = time.perf_counter()
    device, card = phase_device()
    phase_build(card)
    phase_native(card)
    table: dict = {}
    phase_kernels(device, card, table, kernel_check.kernel_cases, "kernel",
                  tc_required=SERVING_TC_REQUIRED)
    phase_kernels(device, card, table, kernel_check.brats_cases, "brats-kernel",
                  tc_required=SERVING_TC_REQUIRED)
    model, model_fp32 = phase_forward(device, card)
    paths = {"forward-32": phase_forward32(device, card)}
    paths["serving"] = phase_slice(model, model_fp32, device, card)
    del model, model_fp32
    torch.cuda.empty_cache()
    paths["brats"] = phase_brats(device, card)
    torch.cuda.empty_cache()
    paths["cli"] = phase_cli(device, card)
    torch.cuda.empty_cache()
    phase_kernels(device, card, table, kernel_check.training_cases, "train-kernel")
    phase_loss_repeat(device, card)
    norm_row = phase_norm(device, card)
    torch.cuda.empty_cache()
    paths["train"] = phase_train(device, card)
    torch.cuda.empty_cache()
    paths["config-2"] = phase_routes(device, card)
    torch.cuda.empty_cache()
    phase_kernels(device, card, table, kernel_check.flat_cases, "flat-kernel",
                  tc_required=("conv3x3x3_flat",))
    paths.update(phase_pretrain(device, card))
    paths["pretrain-flat"] = phase_pretrain_flat(device, card)
    paths["pretrain-cli"] = phase_pretrain_cli(device, card)
    torch.cuda.empty_cache()
    paths["seg-cli"] = phase_seg_cli(device, card)
    torch.cuda.empty_cache()
    phase_kernels(device, card, table, kernel_check.mri_training_cases, "mri-train-kernel")
    paths["seg-cli-mri"] = phase_seg_cli_mri(device, card)
    torch.cuda.empty_cache()
    paths["determinism"] = phase_determinism(device, card)
    torch.cuda.empty_cache()
    paths["dp"] = phase_dp(device, card)
    torch.cuda.empty_cache()
    paths["dp-2"] = phase_dp2(device, card)
    kernels = kernel_rows(table, paths)
    norm_row["launches_by_path"] = {path: launches.get("instance_norm_fwd")
                                    for path, launches in paths.items()}
    kernels.append(norm_row)
    log(f"[total] {time.perf_counter() - t_start:.1f} s, the build included [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
