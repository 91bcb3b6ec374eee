"""The host spans of ``utils.profiling.span`` inside the window walks and the
training step: inactive without a profiler, and under ``torch.profiler``
one upload and one walk per volume with one forward per model batch inside
the walk, and one upload, forward, backward and optimizer span per step, in
that order.

A small UNETR (feature size 8, hidden 24, 2 layers, 32^3 windows) on the
CPU. The z-row volume (40, 36, 44) walks 2 d-starts x one batch of 2 rows
x 2 windows; the flat volume (30, 36, 44) has an odd pad, so it takes the
flat walk: 4 windows in batches of 3, the last padded.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from medseg_torch.engine import train as ttrain
from medseg_torch.engine.evaluate import Validator
from medseg_torch.engine.state import create_train_state
from medseg_torch.models import unetr as tunetr
from medseg_torch.ops.sliding_window import SlidingWindowSpec
from medseg_torch.utils import profiling

ROI = 32
SPEC = SlidingWindowSpec(roi=(ROI,) * 3, overlap=0.5, sw_batch=3, mode="gaussian")
VOLUMES = {"zrow": ((40, 36, 44), 2), "flat": ((30, 36, 44), 2)}  # shape, model batches
TASKS = {"ct": 2, "mri": 3}  # task -> classes
TRAIN_SPANS = ["medseg.train.upload", "medseg.train.forward", "medseg.train.backward",
               "medseg.train.optimizer"]


def _model(out_channels: int) -> tunetr.UNETR:
    return tunetr.init_weights(
        tunetr.UNETR(in_channels=1, out_channels=out_channels, img_size=(ROI,) * 3,
                     feature_size=8, hidden_size=24, mlp_dim=48, num_heads=4, num_layers=2),
        torch.Generator().manual_seed(3),
    )


def _volume(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape + (1,)).astype(np.float32)


def _batch(task: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(2, 1, ROI, ROI, ROI)).astype(np.float32)
    if task == "ct":
        label = rng.integers(0, TASKS["ct"], size=(2, ROI, ROI, ROI))
    else:
        label = (rng.random(size=(2, TASKS["mri"], ROI, ROI, ROI)) > 0.5).astype(np.float32)
    return {"image": torch.from_numpy(image), "label": torch.from_numpy(label)}


def _train(task: str):
    model = _model(TASKS[task])
    state = create_train_state(model, generator=torch.Generator().manual_seed(0),
                               learning_rate=1e-3, weight_decay=1e-5, device="cpu")
    return state, ttrain.make_train_step(model, task=task)


def _spans(prof, prefixes=("medseg.serve.", "medseg.train.")) -> list[tuple[str, float, float]]:
    """The profiler's walk and step ranges (``prefixes``) as (name, start,
    end), by start; the models' own spans (``medseg.norm``) nest inside."""
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(prefixes)]
    return sorted(spans, key=lambda s: s[1])


def _named(spans, name: str):
    return [s for s in spans if s[0] == name]


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    walk, step = profiling.span("medseg.serve.walk"), profiling.span("medseg.train.forward")
    assert walk is step and isinstance(walk, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("medseg.serve.walk") is not walk


@pytest.mark.parametrize("path", ["serve", "train"])
def test_paths_do_not_reach_the_recorder_without_a_profiler(monkeypatch, path):
    def refuse(name):
        raise AssertionError(f"span {name!r} recorded without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    if path == "serve":
        mask = Validator(_model(3), 3, "ct", SPEC, device="cpu").predict_mask(
            _volume(VOLUMES["zrow"][0], 1))
        assert mask.shape == VOLUMES["zrow"][0] + (3,)
    else:
        state, step = _train("ct")
        state, loss = step(state, _batch("ct", 2))
        assert state.step == 1 and torch.isfinite(loss)


@pytest.mark.parametrize("route", sorted(VOLUMES))
def test_serving_spans_per_volume_and_model_batch(route):
    shape, batches = VOLUMES[route]
    validator = Validator(_model(3), 3, "ct", SPEC, device="cpu")
    calls = []
    name = "_apply_acc" if route == "zrow" else "_apply_fn"
    apply = getattr(validator, name)

    def counted(*args):
        calls.append(len(args[0]))
        return apply(*args)

    setattr(validator, name, counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in (1, 2):
            validator.predict_mask(_volume(shape, seed))
    spans = _spans(prof)
    uploads, walks = _named(spans, "medseg.serve.upload"), _named(spans, "medseg.serve.walk")
    forwards = _named(spans, "medseg.serve.forward")
    assert len(uploads) == len(walks) == 2
    assert len(calls) == len(forwards) == 2 * batches
    for (_, _, up_end), (_, walk_start, walk_end) in zip(uploads, walks):
        assert up_end <= walk_start
        inside = [f for f in forwards if walk_start <= f[1] and f[2] <= walk_end]
        assert len(inside) == batches
    outer = [s[0] for s in spans if s[0] != "medseg.serve.forward"]
    assert outer == ["medseg.serve.upload", "medseg.serve.walk"] * 2


@pytest.mark.parametrize("task", sorted(TASKS))
def test_train_step_spans_in_order_and_disjoint(task):
    state, step = _train(task)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, loss = step(state, _batch(task, 4))
    assert torch.isfinite(loss)
    spans = _spans(prof)
    assert [s[0] for s in spans] == TRAIN_SPANS
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start
