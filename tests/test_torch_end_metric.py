"""End-metric parity: pretraining then fine-tuning through both packages'
CLIs on one synthetic CT set, and the trained Dice compared (``slow``).

Six seeded ``.nii.gz`` CT volumes at 1.5 x 1.5 x 2 mm (respaced to 1 mm by
both host chains, each through its C++ library), a bright box as class 1.
Both packages run at ``tests/test_cli.py``'s tiny width with one loader
thread, so that every random crop is drawn in the same order on both sides.

1. ``medseg.cli.pretraining`` and ``medseg_torch.cli.pretraining`` (two
   epochs per stage, fp32) from the same initial weights (the JAX CLI's
   init, moved into the port's model by ``state_dict_from_flax``): their
   per-epoch loss curves agree to ``PRETRAIN_LOSS_RTOL``.
2. The port's pretrained model (the recon stage's best) is written as one
   MONAI-schema ``.pth``; ``medseg.cli.segmentation`` and
   ``medseg_torch.cli.segmentation`` fine-tune from it (4 steps, a
   validation every 2, fp32): their training losses agree to
   ``FINETUNE_LOSS_RTOL`` and their final mean Dice to ``DICE_ATOL``.

The measured differences are printed (``-s``) and recorded in ``PERF.md``.
The fine-tuning bounds sit about 10x above the sound runs' readings (losses
9.213e-06, Dice 4.835e-05) and below the readings of two planted faults in
the port's train step: no optimizer update (losses 3.685e-02, Dice
1.421e-02) and half of each batch dropped (losses 6.517e-02, Dice
8.862e-04).
"""

import json
import os

import numpy as np
import pytest
import torch

from medseg_torch.data.nifti import write_nifti

PRETRAIN_LOSS_RTOL = 1e-3
FINETUNE_LOSS_RTOL = 1e-4
DICE_ATOL = 5e-4
SHAPE = (40, 40, 24)  # 1.5 x 1.5 x 2 mm -> 59 x 59 x 47 at 1 mm
TINY = ["--crop-size", "32", "--feature-size", "2", "--hidden-size", "16", "--mlp-dim", "32",
        "--num-heads", "2", "--num-layers", "4", "--num-workers", "1", "--no-progress"]
FOLD = ["--folds", "2", "--max-folds", "1"]
LR = "1e-3"


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_ct_set(root, n=6):
    rng = np.random.default_rng(21)
    task = os.path.join(root, "TinyCT")
    os.makedirs(os.path.join(task, "imagesTr"))
    os.makedirs(os.path.join(task, "labelsTr"))
    affine = np.diag([1.5, 1.5, 2.0, 1.0])
    entries = []
    for i in range(n):
        image = rng.normal(0.0, 40.0, size=SHAPE).astype(np.float32)
        label = np.zeros(SHAPE, np.float32)
        lo = rng.integers(4, 14, size=3)
        size = rng.integers(10, 16, size=3)
        box = tuple(slice(a, min(a + s, d - 2)) for a, s, d in zip(lo, size, SHAPE))
        label[box] = 1.0
        image[box] += 160.0
        write_nifti(os.path.join(task, "imagesTr", f"ct{i}.nii.gz"), image, affine)
        write_nifti(os.path.join(task, "labelsTr", f"ct{i}.nii.gz"), label, affine)
        entries.append({"image": f"imagesTr/ct{i}.nii.gz", "label": f"labelsTr/ct{i}.nii.gz"})
    with open(os.path.join(task, "dataset.json"), "w") as f:
        json.dump({"training": entries}, f)
    return root


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


@pytest.mark.slow
def test_pretrain_then_finetune_dice_matches_across_packages(tmp_path, monkeypatch):
    import jax

    from medseg.cli import pretraining as jpre
    from medseg.cli import segmentation as jseg
    from medseg_torch.cli import pretraining as tpre
    from medseg_torch.cli import segmentation as tseg
    from medseg_torch.engine.checkpoint import state_dict_from_flax

    data = make_ct_set(str(tmp_path / "data"))

    # 1. pretraining from one init, loss curves captured per stage
    curves = {"jax": [], "port": []}
    init = {}
    jax_create = jpre.create_train_state

    def jax_create_recorded(*args, **kw):
        state = jax_create(*args, **kw)
        # a host copy: the jitted step donates the state's buffers
        init["params"] = jax.tree_util.tree_map(np.array, state.params)
        return state

    port_create = tpre.create_train_state

    def port_create_from_jax_init(*args, **kw):
        state = port_create(*args, **kw)
        state.model.load_state_dict(state_dict_from_flax(init["params"]))
        return state

    monkeypatch.setattr(jpre, "create_train_state", jax_create_recorded)
    monkeypatch.setattr(tpre, "create_train_state", port_create_from_jax_init)
    monkeypatch.setattr(jpre, "plot_loss_vs_time", lambda p, l, t: curves["jax"].append(list(l)))
    monkeypatch.setattr(tpre, "plot_loss_vs_time", lambda p, l, t: curves["port"].append(list(l)))
    pre_args = [data, "TinyCT", None, "2", LR, "0.1", "ranking", *FOLD,
                "--max-iterations", "2", "--eval-num", "100", *TINY]
    jpre.main([a if a is not None else str(tmp_path / "jax_pre") for a in pre_args])
    out = tpre.main([a if a is not None else str(tmp_path / "port_pre") for a in pre_args]
                    + ["--device", "cpu"])
    assert len(curves["jax"]) == len(curves["port"]) == 2  # feat, recon
    pre_rel = max(_rel(p, j).max() for p, j in zip(curves["port"], curves["jax"]))
    print(f"pretraining loss curves: jax {curves['jax']} port {curves['port']}; largest "
          f"relative difference {pre_rel:.3e} (bound {PRETRAIN_LOSS_RTOL})")

    # 2. one MONAI-schema .pth from the port's pretrained model, both CLIs
    # fine-tune from it
    args = tpre.build_parser().parse_args([a or "x" for a in pre_args])
    best = os.path.join(out[0], tpre.stage_prefix(args, "recon"), "best", "model.pt")
    pth = str(tmp_path / "pretrained.pth")
    torch.save(torch.load(best), pth)
    seg_args = [data, "TinyCT", None, "2", pth, "train", "1e6", LR, *FOLD,
                "--max-iterations", "4", "--eval-num", "2", *TINY]
    jax_root, port_root = str(tmp_path / "jax_seg"), str(tmp_path / "port_seg")
    want = jseg.main([a if a is not None else jax_root for a in seg_args])[0]
    got = tseg.main([a if a is not None else port_root for a in seg_args] + ["--device", "cpu"])[0]
    loss_j = np.load(os.path.join(jax_root, "TinyCT_0", f"lr_{float(LR)}_loss.npy"))
    loss_t = np.load(os.path.join(port_root, "TinyCT_0", f"lr_{float(LR)}_loss.npy"))
    loss_rel = _rel(loss_t, loss_j).max()
    dice_diff = abs(got["dice"] - want["dice"])
    print(f"fine-tuning losses: jax {loss_j.tolist()} port {loss_t.tolist()}; largest relative "
          f"difference {loss_rel:.3e} (bound {FINETUNE_LOSS_RTOL}); final Dice jax "
          f"{want['dice']:.6f} port {got['dice']:.6f}, |diff| {dice_diff:.3e} (bound {DICE_ATOL}); "
          f"per class jax {np.round(want['dice_per_class'], 6).tolist()} port "
          f"{np.round(got['dice_per_class'], 6).tolist()}")
    assert pre_rel <= PRETRAIN_LOSS_RTOL
    assert loss_j.shape == loss_t.shape == (4,)
    assert loss_rel <= FINETUNE_LOSS_RTOL
    assert np.isfinite(got["dice"]) and dice_diff <= DICE_ATOL
