"""The port's data-parallel runtime (``medseg_torch.parallel``) at two ranks
on the CPU (gloo), against the JAX package's single-device and mesh results.

One run of ``tests/torch_dist_worker.py`` on two processes
(``parallel.launch.run_ranks``: a ``file://`` rendezvous under ``tmp_path``,
so that parallel test workers never share a port, and a time limit after
which every rank is killed) computes, from the inputs written here:

- one data-parallel step of the tiny UNETR of ``tests/test_parallel.py``
  (each rank 4 of the 8 crops), held to the JAX single-device
  ``make_train_step`` on the whole batch at the same weights
  (``state_dict_from_flax``): the loss (mean of the ranks' losses) to 1e-4
  relative; the averaged gradients leaf by leaf to 1e-4 relative L2 (the
  leaves an instance norm cancels, whose true gradient is 0, to 1e-4 of the
  largest gradient, as ``tests/test_torch_train.py`` holds them); the
  parameters after the step within 2 * lr (AdamW turns noise-level
  gradients into updates of up to lr, ``tests/test_parallel.py``'s bound);
- the sharded flat walk, plain and weighted forms, against the JAX
  ``sliding_window_inference_sharded`` on the 8-device virtual CPU mesh
  ("ndchw" and "flatk"), rtol and atol 1e-4;
- the sharded z-row walk (fp32 accumulator) on ``tests/test_swi_zrow.py``'s
  grids against the JAX ``sliding_window_inference_zrow_sharded`` with its
  parity-plane apply, fp32: rtol and atol 1e-5 (only the order of fp32
  sums differs);
- ``psum_metric_counts`` against the JAX one, exactly;
- the device augmentation at two ranks equals the single-process result on
  the global batch, exactly.

Replicated results (parameters, walks, counts) must be the same bits on
both ranks. Then the dry-run tool (``tools/dryrun_multichip``) at two tiny
ranks and the segmentation CLI at two ranks (gloo, ``--data-parallel``).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_recovery import TINY_CLI, make_smoke_dataset

from medseg.engine.state import create_train_state as j_create_state
from medseg.engine.train import make_train_step as j_make_step
from medseg.models.unetr import UNETR as JUNETR
from medseg.ops.losses import dice_ce_loss as j_dice_ce
from medseg.ops.sliding_window import SlidingWindowSpec as JSpec
from medseg.ops.sliding_window import sliding_window_inference_sharded as j_swi_sharded
from medseg.ops.swi_zrow import sliding_window_inference_zrow_sharded as j_zrow_sharded
from medseg.parallel.mesh import make_mesh as j_make_mesh
from medseg.parallel.mesh import psum_metric_counts as j_psum_counts
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.ops.augment import augment_batch
from medseg_torch.parallel.launch import run_ranks
from medseg_torch.tools import dryrun_multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
RANK_ENV = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
TIMEOUT = 240  # seconds for both ranks; each takes about 10 s alone
TINY = dict(in_channels=1, out_channels=2, img_size=(16, 16, 16), feature_size=2, hidden_size=8,
            mlp_dim=16, num_heads=2, num_layers=4, patch_size=16)
LR, WD = 1e-3, 1e-5
ZROW_GRIDS = (((20, 18, 14, 3), 0.5), ((40, 36, 32, 1), 0.25), ((8, 8, 8, 2), 0.25))
NORM_CANCELLED = re.compile(
    r"(encoder1\.layer|conv_block)\.conv[123]\.conv\.bias|encoder1\.layer\.conv3\.conv\.weight"
    r"|decoder\d\.transp_conv\.conv\.bias"
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The inputs, the JAX state, and both ranks' outputs."""
    tmp = tmp_path_factory.mktemp("world2")
    rng = np.random.default_rng(12345)
    jmodel = JUNETR(**TINY)
    image = rng.normal(size=(8, 16, 16, 16, 1)).astype(np.float32)
    label = rng.integers(0, 2, size=(8, 16, 16, 16)).astype(np.int32)
    jstate = j_create_state(jmodel, rng=jax.random.key(0), sample_input=jnp.asarray(image[:1]),
                            learning_rate=LR, weight_decay=WD)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.array, jstate.params))
    inputs = {f"sd/{k}": v.numpy() for k, v in sd.items()}
    inputs.update(image=np.ascontiguousarray(np.moveaxis(image, -1, 1)), label=label,
                  vol=rng.normal(size=(20, 18, 14, 3)).astype(np.float32),
                  w=rng.normal(size=(3, 5)).astype(np.float32))
    for i, (shape, _) in enumerate(ZROW_GRIDS):
        inputs[f"zrow_vol{i}"] = rng.normal(size=shape).astype(np.float32)
        inputs[f"zrow_w{i}"] = rng.normal(size=(shape[-1], 5)).astype(np.float32)
    classes = rng.integers(0, 3, size=(2, 16, 6, 6, 6))  # 16 rows: 8 per rank, 2 per device
    inputs["pred"], inputs["target"] = (np.eye(3, dtype=np.float32)[c] for c in classes)
    inputs.update(aug_image=rng.normal(size=(4, 1, 8, 8, 8)).astype(np.float32),
                  aug_label=rng.integers(0, 3, size=(4, 1, 8, 8, 8)).astype(np.int64),
                  aug_seed=np.array(7))
    np.savez(tmp / "inputs.npz", **inputs)
    run_ranks([WORKER, str(tmp / "inputs.npz"), str(tmp)], 2, timeout=TIMEOUT, env=RANK_ENV,
              workdir=str(tmp))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return jmodel, jstate, inputs, image, label, ranks


def test_each_rank_steps_on_half_the_batch(world2):
    *_, ranks = world2
    assert [int(r["local_rows"][0]) for r in ranks] == [4, 4]


def test_ranks_hold_the_same_bits(world2):
    *_, ranks = world2
    replicated = [k for k in ranks[0] if k.startswith(("param/", "grad/", "flat", "zrow", "counts"))]
    assert len(replicated) > 10
    for key in replicated + ["loss"]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)


def test_data_parallel_step_matches_jax_single_device(world2):
    jmodel, jstate, _, image, label, ranks = world2
    got = ranks[0]

    def loss_fn(params):
        logits = jmodel.apply(params, jnp.asarray(image), return_encoder_features=False)
        return j_dice_ce(logits, jnp.asarray(label), softmax=True, to_onehot_y=True)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    np.testing.assert_allclose(float(got["loss"]), float(j_loss), rtol=1e-4)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.array, j_grads))
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, w in want.items():
        g, w = got[f"grad/{name}"], w.numpy()
        if NORM_CANCELLED.search(name):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale, err_msg=name)
        else:
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-4, name

    j_step = j_make_step(jmodel, task="ct", donate=False)
    jstate, _ = j_step(jstate, {"image": jnp.asarray(image), "label": jnp.asarray(label)})
    want = state_dict_from_flax(jax.tree_util.tree_map(np.array, jstate.params))
    for name, w in want.items():
        np.testing.assert_allclose(got[f"param/{name}"], w.numpy(), rtol=0, atol=2 * LR,
                                   err_msg=name)


@pytest.mark.parametrize("form,layout", [("flat", "ndchw"), ("flatk", "flatk")])
def test_sharded_flat_walk_matches_jax(world2, form, layout):
    _, _, inputs, _, _, ranks = world2
    spec = JSpec(roi=(8, 8, 8), overlap=0.5, sw_batch=2, mode="gaussian")
    apply = {
        "ndchw": lambda p, w: jnp.einsum("bdhwc,ck->bdkhw", w, p),
        "flatk": lambda p, w: jnp.einsum("bdhwc,ck->bdhwk", w, p),
    }[layout]
    want = j_swi_sharded(jnp.asarray(inputs["w"]), jnp.asarray(inputs["vol"]), apply, 5, spec,
                         j_make_mesh(), out_layout=layout)
    np.testing.assert_allclose(ranks[0][form], np.asarray(want), rtol=1e-4, atol=1e-4)


def _apply_pp(k: int, k16: int):
    """``tests/test_swi_zrow.py``'s parity-plane form of the voxelwise
    predictor."""
    def apply_pp(params, windows, wgt):
        lg = jnp.einsum("bdhwc,ck->bdhwk", windows, params) * wgt
        lg = jnp.pad(lg, [(0, 0)] * 4 + [(0, k16 - k)])
        b, rd, rh, rw, _ = lg.shape
        g = lg.reshape(b, rd, rh // 2, 2, rw // 2, 2, k16)
        return g.transpose(0, 1, 3, 5, 2, 4, 6).reshape(b, rd, 4, rh // 2, (rw // 2) * k16)
    return apply_pp


@pytest.mark.parametrize("grid", range(len(ZROW_GRIDS)))
def test_sharded_zrow_walk_matches_jax(world2, grid):
    _, _, inputs, _, _, ranks = world2
    spec = JSpec(roi=(8, 8, 8), overlap=ZROW_GRIDS[grid][1], mode="gaussian")
    want = j_zrow_sharded(jnp.asarray(inputs[f"zrow_w{grid}"]),
                          jnp.asarray(inputs[f"zrow_vol{grid}"]), _apply_pp(5, 8), 5, spec,
                          j_make_mesh(), acc_dtype="fp32")
    np.testing.assert_allclose(ranks[0][f"zrow{grid}"], np.asarray(want), rtol=1e-5, atol=1e-5)


def test_psum_metric_counts_match_jax(world2):
    _, _, inputs, _, _, ranks = world2
    want = j_psum_counts(j_make_mesh(), jnp.asarray(inputs["pred"]), jnp.asarray(inputs["target"]))
    np.testing.assert_array_equal(ranks[0]["counts"], np.asarray(want, np.float32))


def test_augmentation_rows_equal_the_single_process_global_batch(world2):
    _, _, inputs, _, _, ranks = world2
    image, label = augment_batch(
        torch.Generator().manual_seed(int(inputs["aug_seed"])),
        torch.from_numpy(inputs["aug_image"]), torch.from_numpy(inputs["aug_label"]),
        flip_prob=0.5, rot_prob=0.5)
    got_image = np.concatenate([r["aug_image"] for r in ranks])
    got_label = np.concatenate([r["aug_label"] for r in ranks])
    np.testing.assert_array_equal(got_image, image.numpy())
    np.testing.assert_array_equal(got_label, label.numpy())
    assert not np.array_equal(got_image, inputs["aug_image"])  # some sample was augmented


def test_dryrun_multichip_two_cpu_ranks():
    """The dry-run tool at two tiny ranks: the data-parallel gradient within
    1e-5 of the single-process one, the sharded walk's argmax agreement at
    least 0.9999, both ranks' logits the same bits, the counts exact."""
    reports, bad = dryrun_multichip.launch(2, "cpu", "tiny", steps=1, timeout=TIMEOUT,
                                           env=RANK_ENV)
    assert bad == [], bad
    assert [r["backend"] for r in reports] == ["gloo", "gloo"]
    assert reports[0]["walk_max_abs_diff"] <= 1e-5 * reports[0]["walk_largest_logit"]


def test_segmentation_cli_at_two_ranks(tmp_path):
    """``medseg_torch.cli.segmentation`` on two processes (gloo,
    ``--data-parallel``): both ranks report the same final metrics, rank 0
    alone saves checkpoints, each rank writes its own log."""
    data_dir = make_smoke_dataset(tmp_path, n=4)  # a fold of 2 train volumes: 1 per rank
    out_root = str(tmp_path / "results")
    argv = [data_dir, "SmokeCT", out_root, "2", "", "train", "1e6", "1e-3", "--folds", "2",
            "--max-folds", "1", "--max-iterations", "2", "--eval-num", "2", "--data-parallel",
            "--device", "cpu", "--no-progress"] + TINY_CLI
    reports, bad = dryrun_multichip.launch(2, "cpu", cli_argv=argv, timeout=TIMEOUT, env=RANK_ENV)
    assert bad == [], bad
    assert reports[0]["saves"] and not reports[1]["saves"]
    assert len(reports[0]["step_seconds"]) == len(reports[1]["step_seconds"]) == 2
    fold = os.path.join(out_root, "SmokeCT_0")
    for rank in range(2):
        log = open(os.path.join(fold, f"lr_0.001_train_size_1000000_host{rank}_logger.txt")).read()
        assert f"rank {rank}/2" in log and "data-parallel over 2 processes" in log
        events = [json.loads(line) for line in
                  open(os.path.join(fold, f"lr_0.001_train_size_1000000_host{rank}_events.jsonl"))]
        assert [e["dice"] for e in events if e["kind"] == "final_metrics"] == \
            [reports[0]["final"][0]["dice"]]
    assert os.path.exists(os.path.join(fold, "checkpoints", "best", "model.pt"))
