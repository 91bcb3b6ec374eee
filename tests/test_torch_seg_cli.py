"""The port's segmentation CLI (``medseg_torch.cli.segmentation``) end to end
on the CPU, its recovery rules (after ``tests/test_recovery.py``), and its
final metrics against the JAX package's CLI (``medseg.cli.segmentation``).

- A tiny-model ``train`` then ``eval`` run with ``tests/test_cli.py``'s
  ``TINY`` flags and ``--device-augment`` on 32^3 volumes (one window per
  walk, so that the overlays' walk at overlap 0.8 stays cheap on a loaded
  CPU; the walks themselves are held to JAX in
  ``tests/test_torch_sliding_window.py``): checkpoints, series, curves,
  final series and overlays on disk; ``eval`` reproduces the final metrics
  to 1e-5.
- ``TrainLoop`` with the real ``CheckpointManager``: a crash mid-interval
  resumes from the scheduled "latest" save with its step and AdamW moments;
  a newer "best" wins over an older "latest"; the CLI resumes from the
  fresher checkpoint and a resumed run does not demote the best.
- A BraTS-layout run (four channels, sigmoid DiceCE) of one step.
- ``--data-parallel`` with one device runs single-device; each of the
  multi-process variables alone is an incomplete configuration and raises;
  ``MEDSEG_NUM_PROCESSES=1`` runs one process; a rank without
  ``--data-parallel`` keeps no mesh (the two-process runs are in
  ``tests/test_torch_parallel.py``).
- A port checkpoint directory as PRETRAINED: the output directory takes the
  pretrained name's suffix, the weights load and the CLI's learning rate
  stays.
- Parity: both CLIs in ``eval`` mode with the same ``.pth`` (written from
  flax parameters by ``state_dict_from_flax``) on the same fold. The JAX
  CLI on the CPU runs its flax forward through the flat walk; the port its
  fused forward (plain versions) with an fp32 accumulator. Their masks must
  agree on at least 99.9% of the voxels (all agreed when this was written);
  then the final Dice, precision, recall and Hausdorff agree to 1e-5.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli import TINY, make_dataset
from test_mri_path import make_mri_dataset
from test_recovery import TINY_CLI, make_smoke_dataset

from medseg.cli.segmentation import main as jax_seg
from medseg.engine.evaluate import Validator as JaxValidator
from medseg.models.unetr import UNETR as JaxUNETR
from medseg.ops.sliding_window import SlidingWindowSpec as JaxSpec
from medseg_torch.cli import segmentation as seg
from medseg_torch.cli.common import fold_datalists, resolve_datalist
from medseg_torch.config import preset
from medseg_torch.data.pipelines import val_transforms
from medseg_torch.engine.checkpoint import CheckpointManager, state_dict_from_flax
from medseg_torch.engine.evaluate import Validator
from medseg_torch.engine.state import create_train_state
from medseg_torch.engine.train import TrainLoop, make_train_step
from medseg_torch.models.unetr import UNETR
from medseg_torch.ops.sliding_window import SlidingWindowSpec

METRICS = ("dice", "precision", "recall", "hausdorff")
FOLD = ["--folds", "2", "--max-folds", "1"]
CPU = ["--device", "cpu", "--no-progress"]
SMOKE_MODEL = dict(in_channels=1, out_channels=2, img_size=(16, 16, 16), feature_size=2,
                   hidden_size=16, mlp_dim=32, num_heads=2, num_layers=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the CLI runs its loader threads beside
    torch's pool, and under a parallel test run (several workers on the
    same cores) an 8-thread pool per worker oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same_metrics(got, want, tol=1e-5):
    for name in METRICS:
        if np.isnan(want[name]):
            assert np.isnan(got[name]), name
        else:
            assert got[name] == pytest.approx(want[name], abs=tol), name
    np.testing.assert_allclose(got["dice_per_class"], want["dice_per_class"], atol=tol)


def test_train_then_eval(tmp_path):
    data_dir = make_dataset(tmp_path, shape=(32, 32, 32))  # one window per walk at crop 32
    out_root = str(tmp_path / "results")
    argv = [data_dir, "TinyCT", out_root, "2", "", "train", "1e6", "1e-3", *FOLD,
            "--max-iterations", "2", "--eval-num", "1", "--device-augment", *CPU] + TINY
    results = seg.main(argv)
    assert len(results) == 1
    r = results[0]
    assert np.isfinite(r["dice"]) and len(r["dice_per_class"]) == 2
    assert np.isfinite(r["precision"]) and np.isfinite(r["recall"])
    assert np.isfinite(r["hausdorff"]) or np.isnan(r["hausdorff"])
    fold0 = os.path.join(out_root, "TinyCT_0")
    for name in ("model.pt", "train.pt"):
        assert os.path.exists(os.path.join(fold0, "checkpoints", "best", name))
    assert os.path.exists(os.path.join(fold0, "checkpoints", "meta.json"))
    assert np.load(os.path.join(fold0, "lr_0.001_loss.npy")).shape == (2,)
    assert np.load(os.path.join(fold0, "lr_0.001_dice.npy")).shape == (2,)
    for name in ("dice", "precision", "recall", "hausdorff"):
        assert np.load(os.path.join(fold0, f"final_{name}_per_class.npy")).shape == (2,)
    for name in ("curves.png", "overlays.pdf"):
        assert os.path.getsize(os.path.join(fold0, name)) > 0
    log = open(glob.glob(os.path.join(fold0, "*_logger.txt"))[0]).read()
    assert "Model Was Saved ! Best Dice" in log and "fold 0 final" in log

    # eval mode restores the best checkpoint and reproduces the metrics
    argv[5] = "eval"
    _assert_same_metrics(seg.main(argv)[0], r)


def _tiny_state(seed=0):
    return create_train_state(UNETR(**SMOKE_MODEL), generator=torch.Generator().manual_seed(seed),
                              learning_rate=1e-3, weight_decay=1e-5, device="cpu")


def _batches(rng, n):
    for _ in range(n):
        image = rng.normal(size=(1, 1, 16, 16, 16)).astype(np.float32)
        yield {"image": torch.from_numpy(image),
               "label": torch.from_numpy(rng.integers(0, 2, size=(1, 1, 16, 16, 16)))}


def test_crash_resume_from_latest(tmp_path):
    """A crash mid-interval: the restart resumes from the scheduled "latest"
    save with its step and optimizer moments, not from the older best."""
    state = _tiny_state()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    step_fn = make_train_step(state.model, task="ct")

    def crashing_step(s, b):
        if s.step + 1 == 5:
            raise RuntimeError("simulated mid-interval crash")
        return step_fn(s, b)

    loop = TrainLoop(crashing_step, max_iterations=10, eval_num=2, checkpointer=ckpt,
                     validator=lambda s: 0.1,  # constant metric: best saved once, at step 2
                     save_latest_every=2, log_fn=lambda m: None)
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="simulated"):
        loop.run(state, _batches(rng, 10))
    assert ckpt.exists("best") and ckpt.exists("latest")
    assert ckpt.metadata() == {"step": 2, "dice": pytest.approx(0.1)}

    state2 = ckpt.restore_freshest(_tiny_state(seed=1))
    assert state2.step == 4
    moments = [s["exp_avg"] for s in state2.optimizer.state.values()]
    assert moments and any(m.abs().max() > 0 for m in moments)
    for name, value in state2.model.state_dict().items():
        assert torch.equal(value, state.model.state_dict()[name]), name  # step 4's weights
    loop2 = TrainLoop(make_train_step(state2.model, task="ct"), max_iterations=6, eval_num=100,
                      log_fn=lambda m: None)
    assert loop2.run(state2, _batches(rng, 10)).step == 6


def test_restore_freshest_prefers_newer_best(tmp_path):
    state = _tiny_state()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    step_fn = make_train_step(state.model, task="ct")
    batches = _batches(np.random.default_rng(0), 3)
    for _ in range(2):
        state, _ = step_fn(state, next(batches))
    ckpt.save(state, name="latest")  # step 2
    state, _ = step_fn(state, next(batches))
    ckpt.save(state, metrics={"dice": 0.5})  # best at step 3
    assert ckpt.restore_freshest(_tiny_state(seed=2)).step == 3


def _smoke_argv(data_dir, out_root, iterations, extra=()):
    return [data_dir, "SmokeCT", out_root, "2", "", "train", "1e6", "1e-3", *FOLD,
            "--eval-num", "2", "--max-iterations", str(iterations), *CPU, *extra] + TINY_CLI


def test_cli_resumes_from_the_fresher_checkpoint(tmp_path, monkeypatch):
    """The CLI crashes at step 4 after "latest" at step 3 and "best" at step
    2; the rerun resumes at step 3 and trains on to the end."""
    data_dir = make_smoke_dataset(tmp_path)
    out_root = str(tmp_path / "results")
    make = seg.make_train_step

    def crashing(model, **kw):
        step = make(model, **kw)

        def run(state, batch):
            if state.step + 1 == 4:
                raise RuntimeError("simulated crash")
            return step(state, batch)
        return run

    monkeypatch.setattr(seg, "make_train_step", crashing)
    with pytest.raises(RuntimeError, match="simulated"):
        seg.main(_smoke_argv(data_dir, out_root, 6, ["--save-latest-every", "1"]))
    monkeypatch.setattr(seg, "make_train_step", make)
    ckdir = os.path.join(out_root, "SmokeCT_0", "checkpoints")
    assert json.load(open(os.path.join(ckdir, "meta.json")))["step"] == 2
    results = seg.main(_smoke_argv(data_dir, out_root, 6, ["--save-latest-every", "1"]))
    assert np.isfinite(results[0]["dice"])
    log = open(glob.glob(os.path.join(out_root, "SmokeCT_0", "*_logger.txt"))[0]).read()
    assert "resuming from checkpoint at step 3" in log
    assert torch.load(os.path.join(ckdir, "latest", "train.pt"))["step"] == 6
    # the resumed run validated at steps 4 and 6 only: its Dice series
    assert np.load(os.path.join(out_root, "SmokeCT_0", "lr_0.001_dice.npy")).shape == (2,)


def test_resume_does_not_demote_best(tmp_path):
    """A resumed run seeds the best so far from ``meta.json``: a worse
    validation after the resume does not overwrite "best"."""
    data_dir = make_smoke_dataset(tmp_path)
    out_root = str(tmp_path / "results")
    extra = ["--save-latest-every", "1"]
    seg.main(_smoke_argv(data_dir, out_root, 2, extra))
    meta_path = os.path.join(out_root, "SmokeCT_0", "checkpoints", "meta.json")
    meta = json.load(open(meta_path))
    meta["dice"] = 2.0  # an unbeatable best
    json.dump(meta, open(meta_path, "w"))
    seg.main(_smoke_argv(data_dir, out_root, 4, extra))  # resumes from step 2
    meta2 = json.load(open(meta_path))
    assert meta2 == {"step": 2, "dice": 2.0}
    log = open(glob.glob(os.path.join(out_root, "SmokeCT_0", "*_logger.txt"))[0]).read()
    assert "historical best Dice 2.00000 at step 2" in log
    assert "Model Not Saved ! Best Dice: 2.00000" in log


def test_brats_layout_one_step(tmp_path):
    data_dir = make_mri_dataset(tmp_path, n=4, shape=(20, 20, 20))
    out_root = str(tmp_path / "results")
    results = seg.main([data_dir, "Task01_Tiny", out_root, "4", "", "train", "1e6", "1e-3",
                        *FOLD, "--max-iterations", "1", "--eval-num", "1", *CPU] + TINY_CLI)
    r = results[0]
    assert len(r["dice_per_class"]) == 4 and np.isfinite(r["dice"])
    fold0 = os.path.join(out_root, "Task01_Tiny_0")
    assert os.path.exists(os.path.join(fold0, "checkpoints", "best", "model.pt"))
    assert os.path.exists(os.path.join(fold0, "overlays.pdf"))
    assert np.load(os.path.join(fold0, "final_hausdorff_per_class.npy")).shape == (4,)


def test_data_parallel_on_one_device_runs_single_device(tmp_path):
    data_dir = make_smoke_dataset(tmp_path)
    out_root = str(tmp_path / "results")
    results = seg.main(_smoke_argv(data_dir, out_root, 1, ["--data-parallel"]))
    assert np.isfinite(results[0]["dice"])
    log = open(glob.glob(os.path.join(out_root, "SmokeCT_0", "*_logger.txt"))[0]).read()
    assert "running single-device" in log


@pytest.mark.parametrize("name,value", [
    ("MEDSEG_COORDINATOR", "localhost:1234"), ("MEDSEG_DISTRIBUTED", "1"),
    ("MEDSEG_NUM_PROCESSES", "2"), ("MEDSEG_PROCESS_ID", "1"),
])
def test_incomplete_multi_process_configuration_raises(tmp_path, monkeypatch, name, value):
    """Each of the JAX package's multi-process variables alone is a
    configuration the CLI cannot join: it names what is missing before it
    touches the network or the data (the two-process runs are in
    ``tests/test_torch_parallel.py``)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match="multi-process configuration incomplete"):
        seg.main(_smoke_argv(str(tmp_path / "none"), str(tmp_path / "none"), 1))
    assert not torch.distributed.is_initialized()


def test_single_process_configuration_runs_one_process(tmp_path, monkeypatch):
    """``MEDSEG_NUM_PROCESSES=1`` (with a coordinator) is one process: no
    process group, one log without a rank suffix."""
    data_dir = make_smoke_dataset(tmp_path)
    out_root = str(tmp_path / "results")
    monkeypatch.setenv("MEDSEG_NUM_PROCESSES", "1")
    monkeypatch.setenv("MEDSEG_COORDINATOR", "localhost:1234")
    results = seg.main(_smoke_argv(data_dir, out_root, 1))
    assert np.isfinite(results[0]["dice"]) and not torch.distributed.is_initialized()
    logs = glob.glob(os.path.join(out_root, "SmokeCT_0", "*_logger.txt"))
    assert len(logs) == 1 and "_host" not in logs[0]


def test_multi_process_without_data_parallel_trains_each_slice(tmp_path, monkeypatch):
    """A rank of a multi-process run without ``--data-parallel`` keeps no
    mesh and says so (as the JAX CLI, each rank trains on its slice)."""
    monkeypatch.setattr(seg, "process_info", lambda: (1, 2))
    logger = seg.RunLogger(str(tmp_path), "log")
    args = seg.build_parser().parse_args(_smoke_argv("d", "o", 1))
    assert seg.data_parallel_mesh(args, torch.device("cpu"), logger) is None
    assert "trains on its slice" in open(logger.text_path).read()


def test_pretrained_checkpoint_directory(tmp_path):
    """A port checkpoint directory as PRETRAINED: its weights load, the
    output root takes the "_pretrained_ranking" suffix, and the optimizer
    runs at the CLI's learning rate, not the saved one."""
    data_dir = make_smoke_dataset(tmp_path)
    pre = create_train_state(UNETR(**SMOKE_MODEL), generator=torch.Generator().manual_seed(9),
                             learning_rate=5e-4, weight_decay=1e-5, device="cpu")
    pre_dir = str(tmp_path / "ranking_ckpt")
    CheckpointManager(pre_dir).save(pre, metrics={"loss": 1.0})
    out_root = str(tmp_path / "results")
    argv = _smoke_argv(data_dir, out_root, 1)
    argv[4] = pre_dir
    seg.main(argv)
    fold0 = os.path.join(out_root + "_pretrained_ranking", "SmokeCT_0")
    train = torch.load(os.path.join(fold0, "checkpoints", "best", "train.pt"))
    assert train["step"] == 1
    assert [g["lr"] for g in train["optimizer"]["param_groups"]] == [1e-3]
    assert "loading pretrained weights" in open(glob.glob(os.path.join(fold0, "*_logger.txt"))[0]).read()


def test_final_metrics_match_the_jax_cli(tmp_path):
    data_dir = make_smoke_dataset(tmp_path, n=4, shape=(24, 22, 20))
    jmodel = JaxUNETR(**{k: v for k, v in SMOKE_MODEL.items()})
    params = jmodel.init(jax.random.key(3), jnp.zeros((1, 16, 16, 16, 1)))
    pth = str(tmp_path / "weights.pth")
    torch.save(state_dict_from_flax(params), pth)

    argv = [data_dir, "SmokeCT", None, "2", pth, "eval", "1e6", "1e-3", *FOLD] + TINY_CLI
    want = jax_seg([a if a is not None else str(tmp_path / "jax") for a in argv])[0]
    got = seg.main([a if a is not None else str(tmp_path / "port") for a in argv] + CPU)[0]

    # the two packages' masks on the fold's validation volumes
    cfg = preset("SmokeCT", 2)
    _, val_list = fold_datalists(resolve_datalist(data_dir, "SmokeCT"), "SmokeCT", 2,
                                 cfg.data.cv_seed)[0]
    model = UNETR(**SMOKE_MODEL)
    model.load_state_dict(state_dict_from_flax(params))
    spec_kw = dict(roi=(16,) * 3, overlap=0.25, sw_batch=4, mode="constant", bucket_multiple=32)
    port_v = Validator(model, 2, "ct", SlidingWindowSpec(**spec_kw), device="cpu")
    jax_v = JaxValidator(jmodel, 2, "ct", JaxSpec(**spec_kw))
    chain = val_transforms(cfg.data)
    for entry in val_list:
        image = chain(dict(entry))["image"]
        agree = (port_v.predict_mask(image).numpy()
                 == np.asarray(jax_v.predict_mask(params, jnp.asarray(image)))).all(-1).mean()
        assert agree >= 0.999, agree
    _assert_same_metrics(got, want)
    assert got.keys() == want.keys()
