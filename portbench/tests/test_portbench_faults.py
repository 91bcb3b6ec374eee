"""A run with the timed path broken underneath comes out not correct.

The harness runs on the CPU here (the chip check skipped, the kernels' plain
versions under the program), at a tiny size, with each real cell's limits.
Each fault is planted in the program where its answer is produced, once for
each fault the cell can have: a serve cell's batch with half its windows
left out, a serve cell's answer altered; a train step that leaves its state
unchanged, a train step whose loss is the mean over half its batch. (One
chip: no exchange between chips to leave out.) A sound run of the same seed
reads lower on the number that fails.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import manifest
from portbench.run import run_cell
from portbench.tests.tiny import make_root

SEED = 2147483711


def half_windows(monkeypatch):
    import medseg_torch.kernels.unetr_of as fused  # the Validator's GraphedForward runs it

    real = fused.fast_apply_v3

    def fault(model, x, weights, *, out_scale=None, starts=None, acc=None):
        h = x.shape[0] // 2
        if acc is not None:
            return real(model, x[:h], weights, out_scale=out_scale[:h], starts=starts[:h], acc=acc)
        out = real(model, x[:h], weights, out_scale=None if out_scale is None else out_scale[:h])
        return torch.cat([out, torch.zeros((x.shape[0] - h,) + out.shape[1:], dtype=out.dtype)])

    monkeypatch.setattr(fused, "fast_apply_v3", fault)


def altered_answer(monkeypatch):
    import medseg_torch.engine.evaluate as ev

    argmax, threshold = ev.argmax_onehot, ev.sigmoid_threshold

    def ct(logits, n):
        out = argmax(logits, n)
        out[:8, :8, :8] = out[:8, :8, :8].roll(1, dims=-1)
        return out

    def mri(logits, *args):
        out = threshold(logits, *args)
        out[:8, :8, :8, 1:] = 1.0 - out[:8, :8, :8, 1:]
        return out

    monkeypatch.setattr(ev, "argmax_onehot", ct)
    monkeypatch.setattr(ev, "sigmoid_threshold", mri)


def unchanged_state(monkeypatch):
    import medseg_torch.engine.train as tr

    monkeypatch.setattr(tr, "apply_gradients", lambda state: state)


def half_batch(monkeypatch):
    import medseg_torch.engine.train as tr

    real = tr.make_loss_fn

    def make(task):
        loss_fn = real(task)
        return lambda model, image, label: loss_fn(model, image[: len(image) // 2],
                                                   label[: len(label) // 2])

    monkeypatch.setattr(tr, "make_loss_fn", make)


FAULTS = {"serve": [half_windows, altered_answer], "train": [unchanged_state, half_batch]}
CASES = [(cell, fault) for cell, kind in (("tiny-ct-serve", "serve"), ("tiny-mri-serve", "serve"),
                                           ("tiny-ct-train", "train"), ("tiny-mri-train", "train"))
         for fault in FAULTS[kind]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench"))


@pytest.fixture(scope="module")
def sound(root):
    torch.set_num_threads(4)
    return {}


def run(root, cell):
    c = manifest.load(root, cell)
    return run_cell(c, SEED, 0.05, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_fault_comes_out_not_correct(root, sound, cell, fault, monkeypatch):
    if cell not in sound:
        sound[cell] = run(root, cell)
    fault(monkeypatch)
    broken = run(root, cell)
    assert broken["correct"] is False
    failing = [name for name, c in broken["checks"].items() if not c["value"] <= c["limit"]]
    assert failing
    for name in failing:
        assert broken["checks"][name]["value"] > sound[cell]["checks"][name]["value"]
