"""The "train" traffic kind: the supervised fine-tuning step back to back.

Set-up builds one training state (the model holding the run's weights and
its AdamW) and one step (``make_train_step``), and drives them through the
first ``checked_steps`` steps on distinct pool batches, reading what the
judge compares: each step's loss, the first gradient from the optimizer's
first moment after one step, and each weight's change after the checked
steps. The window hands the same state and step the next pool batches, on
the host, and reads each loss back (the CLI's ``sync_every=1``) until
``seconds`` have passed; with tracing, ``traced_requests`` more steps run
under the profiler. Once the program is freed, the reference repeats the
checked steps in float32 from the same weights.
"""

from __future__ import annotations

import gc
import logging
import math
import time

import numpy as np
import torch

from portbench import devices, inputs, judge, program, readings, tracing
from portbench.params import make_weights, stream_seed

log = logging.getLogger("portbench")
STATE_STREAM = 3


def program_readings(state, weights0: dict, step, batches: list[dict]) -> dict:
    """The program's checked steps: losses, first-gradient norms (AdamW's
    first moment after one step over ``1 - beta1``) and change norms."""
    params = dict(state.model.named_parameters())
    losses, grad_norms = [], None
    for i, batch in enumerate(batches):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if i == 0:
            opt = state.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            grad_norms = judge.leaf_norms(  # a weight the step did not move has no moment
                {k: opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                 for k, p in params.items()})
    with torch.no_grad():
        change = judge.leaf_norms({k: p - weights0[k] for k, p in params.items()})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        min_requests: int = 0) -> dict:
    config, traffic, arch = cell.config, cell.traffic, cell.architecture
    checked = traffic["checked_steps"]
    weights = make_weights(arch, config["model"], seed, device)
    model = program.build_model(arch, config, weights, device,
                                remat=config["train"]["remat"]).train()
    state = program.train_state(config, model, stream_seed(seed, STATE_STREAM))
    step = program.train_step(config, model)
    pool = inputs.train_pool(config, traffic, seed, device)
    if len(pool) <= checked:
        raise ValueError("the pool must hold more batches than the checked steps")
    got = program_readings(state, weights, step, pool[:checked])
    del weights
    devices.sync(device)
    devices.reset_peak(device)
    setup_s = time.perf_counter() - t0

    times, attempted, failed = [], 0, 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds or attempted < min_requests:
        batch = pool[(checked + attempted) % len(pool)]
        attempted += 1
        t = time.perf_counter()
        try:
            state, loss = step(state, batch)
            value = float(loss)
        except Exception:  # a step that raises is a failed step; the loop steps on
            log.exception("step %d failed", attempted)
            value = math.nan
        times.append(time.perf_counter() - t)
        if not math.isfinite(value):
            failed += 1
    window_s = time.perf_counter() - start
    peak = devices.peak_bytes(device)

    crops = traffic["crops_per_step"]
    metrics = {}
    if times:
        metrics = {"train_samples_per_s": crops * (attempted - failed) / window_s,
                   "train_step_p95_ms": 1e3 * float(np.percentile(times, 95))}
    out = {"attempted": attempted, "failed": failed, "setup_s": setup_s, "peak_bytes": peak,
           "request_s": times, "window_s": window_s, "metrics": metrics}
    if trace:
        n = traffic["traced_requests"]

        def traced(span):
            nonlocal state
            for j in range(n):
                with span():
                    state, loss = step(state, pool[j % len(pool)])
                    float(loss)

        tr = tracing.record(traced, n)
        out["context"] = readings.Context(
            kind="train", task=config["task"], model=config["model"], trace=tr, traced=n,
            completed=attempted - failed, window_s=window_s, items=crops, families={},
            peak_bytes=peak, architecture=arch)

    del state, step, model
    gc.collect()
    devices.free(device)
    judged = time.perf_counter()
    out["numbers"] = judge_steps(arch, config, seed, device, got, pool[:checked])
    out["judge_s"] = time.perf_counter() - judged
    return out


def judge_steps(arch, config: dict, seed: int, device, got: dict, batches: list[dict]) -> dict:
    judge.reference_precision()
    weights0 = make_weights(arch, config["model"], seed, device)
    ref = judge.reference_steps(arch, weights0, config, batches, device)
    return judge.train_numbers(got, ref)
