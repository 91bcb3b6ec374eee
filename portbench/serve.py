"""The "serve" traffic kind: one client segments whole volumes back to back.

A request is ``Validator.predict_mask`` on a host volume, then the label map
(argmax for CT, the BraTS channels for MRI) as int16 on the host, as the
serving CLI does. Set-up builds the model from the run's weights, the
validator and the host pool, and serves ``warm_requests`` volumes. The
window then serves pool volumes in turn until ``seconds`` have passed; with
tracing, ``traced_requests`` more are served under the profiler. Once the
program is freed, every served label map is judged against the reference's
float32 logits of its volume.
"""

from __future__ import annotations

import gc
import logging
import math
import time

import torch

from portbench import devices, inputs, judge, program, readings, tracing
from portbench.params import make_weights
from portbench.reference import swi

log = logging.getLogger("portbench")


def windows_per_volume(config: dict) -> int:
    s = config["serve"]
    padded = [lo + hi + d for d, (lo, hi) in zip(s["volume"], swi.pads(s["volume"], s["roi"],
                                                                       s["bucket_multiple"]))]
    return len(swi.window_starts(padded, s["roi"], s["overlap"]))


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        min_requests: int = 0) -> dict:
    config, traffic, arch = cell.config, cell.traffic, cell.architecture
    weights = make_weights(arch, config["model"], seed, device)
    model = program.build_model(arch, config, weights, device, remat=False).eval()
    del weights
    validator = program.validator(config, model, device)
    to_labels = program.label_map_fn(config)
    pool = inputs.serve_pool(config, traffic, seed, device)

    def serve(i: int):
        mask = validator.predict_mask(pool[i % len(pool)])
        return to_labels(mask).to(torch.int16).cpu().numpy()

    for i in range(traffic["warm_requests"]):
        serve(i)
    devices.sync(device)
    devices.reset_peak(device)
    setup_s = time.perf_counter() - t0

    served, times, attempted, failed = [], [], 0, 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds or attempted < min_requests:
        attempted += 1
        t = time.perf_counter()
        try:
            served.append((attempted - 1, serve(attempted - 1)))
        except Exception:  # a request that raises is a failed request; the loop serves on
            log.exception("request %d failed", attempted - 1)
            failed += 1
        times.append(time.perf_counter() - t)
    window_s = time.perf_counter() - start
    peak = devices.peak_bytes(device)

    out = {"attempted": attempted, "failed": failed, "setup_s": setup_s, "peak_bytes": peak,
           "request_s": times, "window_s": window_s,
           "metrics": {"volumes_per_s": (len(served) / window_s) if served else 0.0}}
    if trace:
        n = traffic["traced_requests"]

        def traced(span):
            for j in range(n):
                with span():
                    served.append((j, serve(j)))

        tr = tracing.record(traced, n)
        out["context"] = readings.Context(
            kind="serve", task=config["task"], model=config["model"], trace=tr, traced=n,
            completed=attempted - failed, window_s=window_s, items=windows_per_volume(config),
            families={}, peak_bytes=peak, architecture=arch)

    del validator, model
    gc.collect()
    devices.free(device)
    judged = time.perf_counter()
    out["numbers"] = {"gap_max": judge_served(arch, config, seed, device, served, pool)}
    out["judge_s"] = time.perf_counter() - judged
    return out


def judge_served(arch, config: dict, seed: int, device, served: list, pool: list) -> float:
    """The widest gap over every served label map (``served``: (request
    index, label map) of volume ``pool[index % len(pool)]``), the
    reference's logits made once per pool volume."""
    if not served:
        return math.inf
    judge.reference_precision()
    weights = make_weights(arch, config["model"], seed, device)
    pool_size = len(pool)
    worst = 0.0
    for k in sorted({i % pool_size for i, _ in served}):
        ref = judge.reference_logits(arch, weights, config, pool[k], device)
        for i, answer in served:
            if i % pool_size == k:
                worst = max(worst, judge.serve_gap(ref, answer, config["task"]))
        del ref
    return worst
