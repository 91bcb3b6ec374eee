"""The port's pretraining CLI (``medseg_torch.cli.pretraining``) end to end
on the CPU, its resume rules (as ``tests/test_recovery.py`` holds the JAX
CLI's), and the train-state ``CheckpointManager``.

The CLI runs on ``tests/test_cli.py``'s tiny dataset with its ``TINY`` model
flags and ``--device cpu``: both stages write their checkpoints and
loss-vs-time figures; a completed stage is skipped on a later run without
touching the loader; a stage cut short resumes with the epochs it had
consumed, so it never runs more than ``--max-iterations`` epochs in all.
"""

import json
import os

import numpy as np
import pytest
import torch
from test_cli import TINY, make_dataset

from medseg_torch.cli import pretraining
from medseg_torch.config import preset
from medseg_torch.engine.checkpoint import CheckpointManager, load_torch_checkpoint
from medseg_torch.engine.state import create_train_state
from medseg_torch.models.unetr import UNETR
from medseg_torch.utils.artifacts import RunLogger

TINY_MODEL = dict(in_channels=1, out_channels=2, img_size=(16, 16, 16), feature_size=2,
                  hidden_size=16, mlp_dim=32, num_heads=2, num_layers=2)
STAGE_ARGS = ["1e-3", "0.1", "ranking", "--crop-size", "16", "--feature-size", "2",
              "--hidden-size", "16", "--mlp-dim", "32", "--num-heads", "2", "--num-layers", "2",
              "--no-progress", "--device", "cpu"]


def _state(seed=0, lr=1e-3):
    return create_train_state(UNETR(**TINY_MODEL), generator=torch.Generator().manual_seed(seed),
                              learning_rate=lr, weight_decay=1e-5, device="cpu")


def _step(state, seed=0):
    """One AdamW step on a random gradient, so that the moments are set."""
    g = torch.Generator().manual_seed(seed)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    state.optimizer.step()
    state.step += 1
    torch.randn(3, generator=state.generator)  # the generator moves too
    return state


def test_pretraining_cli_end_to_end(tmp_path):
    data_dir = make_dataset(tmp_path, n=4)
    out_root = str(tmp_path / "results_ranking")
    out_dirs = pretraining.main([
        data_dir, "TinyCT", out_root, "2", "1e-3", "0.1", "ranking", "--folds", "2",
        "--max-folds", "1", "--max-iterations", "1", "--eval-num", "2", "--device", "cpu",
        "--no-progress",
    ] + TINY)
    assert out_dirs == [os.path.join(out_root, "TinyCT_0")]
    steps = {}
    for arc in ("feat", "recon"):
        stage = os.path.join(out_dirs[0], f"{arc}_lr_0.001_temp_0.1")
        for name in ("model.pt", "train.pt"):
            assert os.path.exists(os.path.join(stage, "best", name))
        assert os.path.exists(stage + "_loss_vs_time.png")
        with open(os.path.join(stage, "meta.json")) as f:
            meta = json.load(f)
        assert meta["completed"] == 1 and meta["epoch"] == 1
        steps[arc] = meta["step"]
    # 2 training volumes, batches of 2: one step per axis and epoch; the
    # recon stage continues the feat stage's state
    assert steps == {"feat": 3, "recon": 6}
    log = open(os.path.join(out_dirs[0], "pretrain_logger.txt")).read()
    assert "Model Was Saved At Global Step 2 for feat!" in log
    assert "Model Was Saved At Global Step 6 for recon!" in log
    # the recon stage's best model serves through the infer CLI's loader
    model = UNETR(**{**TINY_MODEL, "img_size": (32, 32, 32), "num_layers": 4})
    load_torch_checkpoint(os.path.join(out_dirs[0], "recon_lr_0.001_temp_0.1"), model)
    saved = torch.load(os.path.join(out_dirs[0], "recon_lr_0.001_temp_0.1", "best", "model.pt"))
    for name, value in model.state_dict().items():
        assert torch.equal(value, saved[name]), name


def _stage_setup(tmp_path, max_iterations: int, arc: str):
    args = pretraining.build_parser().parse_args(
        [str(tmp_path / "data"), "TinyCT", str(tmp_path / "out"), "2"] + STAGE_ARGS
        + ["--max-iterations", str(max_iterations)])
    cfg = preset("TinyCT", 2)
    cfg = cfg.replace(model=type(cfg.model)(**{**cfg.model.__dict__, "crop_size": 16}))
    out_dir = str(tmp_path / "out" / "TinyCT_0")
    os.makedirs(out_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(out_dir, pretraining.stage_prefix(args, arc)))
    return args, cfg, out_dir, ckpt


def test_completed_stage_is_skipped(tmp_path):
    """A stage that converged in an earlier run (completed=1, possibly after
    fewer than max_iterations epochs) is restored and skipped: the loader
    (None here) is never touched."""
    args, cfg, out_dir, ckpt = _stage_setup(tmp_path, 3, "feat")
    done = _step(_state(seed=0))
    ckpt.save(done, metrics={"epoch": 2, "completed": 1}, block=True)
    state = _state(seed=3)
    out = pretraining.run_stage(args, cfg, state.model, state, None, "feat", out_dir,
                                RunLogger(out_dir, "pretrain_test"))
    assert out.step == 1
    for a, b in zip(out.model.parameters(), done.model.parameters()):
        assert torch.equal(a, b)
    assert "stage already completed (2 epochs)" in open(
        os.path.join(out_dir, "pretrain_test_logger.txt")).read()


def test_interrupted_stage_resumes_with_its_consumed_epochs(tmp_path):
    args, cfg, out_dir, ckpt = _stage_setup(tmp_path, 3, "recon")
    state = _state(seed=0)
    ckpt.save(_step(state), metrics={"loss": 1.0, "epoch": 2})  # cut short after 2 of 3 epochs
    images = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 1, 16, 16, 16))
                              .astype(np.float32))
    state = _state(seed=5)
    out = pretraining.run_stage(args, cfg, state.model, state, [{"image": images}], "recon",
                                out_dir, RunLogger(out_dir, "pretrain_test"))
    assert out.step == 1 + 3  # exactly one more epoch: one step per axis
    meta = ckpt.metadata()
    assert meta["epoch"] == 3 and meta["completed"] == 1 and meta["step"] == 4


def test_checkpoint_manager_round_trip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert not ckpt.exists() and ckpt.metadata() == {}
    state = _step(_step(_state(seed=0)), seed=1)
    ckpt.save(state, metrics={"dice": 0.75})
    ckpt.wait()
    assert ckpt.exists() and not ckpt.exists("latest")
    assert ckpt.metadata() == {"step": 2, "dice": 0.75}
    other = _state(seed=1)
    restored = ckpt.restore(other)
    assert restored is other and restored.step == 2
    for a, b in zip(restored.model.state_dict().values(), state.model.state_dict().values()):
        assert torch.equal(a, b)
    want, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for k, slot in want["state"].items():
        for name, value in slot.items():
            assert torch.equal(got["state"][k][name], value), (k, name)
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    # one more step from both gives the same parameters
    for s in (state, restored):
        _step(s, seed=7)
    for a, b in zip(restored.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)


def test_restore_freshest_and_metadata(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.restore_freshest(_state()).step == 0  # nothing saved: unchanged
    state = _step(_step(_state()))
    ckpt.save(state, name="latest")  # step 2
    assert ckpt.restore_freshest(_state(seed=2)).step == 2
    ckpt.save(_step(state), metrics={"dice": 0.5})  # best at step 3
    assert ckpt.metadata() == {"step": 3, "dice": 0.5}  # "latest" saves leave the sidecar alone
    assert ckpt.restore_freshest(_state(seed=2)).step == 3
    ckpt.save(_step(_step(state)), name="latest")  # a later latest (step 5) wins
    assert ckpt.restore_freshest(_state(seed=2)).step == 5
    ckpt.save(state, metrics={"dice": 0.6})  # a tie goes to "latest"
    fresh = ckpt.restore_freshest(_state(seed=2))
    assert fresh.step == 5
    assert not [p for p in os.listdir(ckpt.directory) if ".tmp-" in p or ".old-" in p]


def test_orbax_directory_still_raises(tmp_path):
    os.makedirs(tmp_path / "orbax" / "best")
    with pytest.raises(NotImplementedError, match="outside the port's scope"):
        load_torch_checkpoint(str(tmp_path / "orbax"), UNETR(**TINY_MODEL))
