"""Where the training step's time goes, on one NVIDIA GPU.

    python -m medseg_torch.tools.profile_train    # from the repository root

Runs BASELINE config 5 as ``chip_smoke.py`` does (UNETR-B/16, 1 -> 14
classes, bf16, remat, AdamW lr 1e-4 and weight decay 1e-5, random weights
from seed 0, one batch of four 96^3 crops: image N(0, 1), labels uniform in
0..13) and measures, after ``WARM`` steps:

1. ``make_train_step``, through the kernels (K1 forward and data gradient,
   K6, K7, K8): ms/step on the host clock over ``STEPS`` steps ending in a
   synchronize, patches/s and peak memory; then ``torch.profiler`` over
   ``PROFILED`` steps: device time and launches per kernel class, busy time
   and the idle share of the traced span (``profile_serving.profile``);
2. the same step with no kernel, as a yardstick: every conv through cuDNN
   and the CT loss through ``ops.losses.dice_ce_loss`` under autograd, same
   dtype, remat, weights and batch: ms/step and peak memory.

Prints one line per measurement and writes all of it as JSON to
``chiprun_out/profile_train.json`` under the repository root.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from medseg_torch.tools.profile_serving import OUT_DIR, _print_breakdown, profile

WARM = 2
STEPS = 5
PROFILED = 3
BATCH = 4


def _time_steps(step, state, batch, n: int) -> tuple[float, float]:
    """Mean seconds per step over ``n`` steps and the peak memory in GiB."""
    for _ in range(WARM):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, torch.cuda.max_memory_allocated() / 2**30


def main() -> None:
    from medseg_torch.engine.state import create_train_state
    from medseg_torch.engine.train import make_train_step
    from medseg_torch.kernels import conv3d
    from medseg_torch.models.unetr import unetr_b16
    from medseg_torch.ops.losses import dice_ce_loss

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    device = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    model = unetr_b16(1, 14, 96, dtype=torch.bfloat16, remat=True)
    state = create_train_state(model, generator=g, learning_rate=1e-4, weight_decay=1e-5,
                               device=device)
    batch = {
        "image": torch.randn((BATCH, 1, 96, 96, 96), generator=g).to(device),
        "label": torch.randint(0, 14, (BATCH, 96, 96, 96), generator=g,
                               dtype=torch.int32).to(device),
    }
    result = {"card": card, "batch": BATCH}

    step = make_train_step(model, task="ct")
    seconds, peak = _time_steps(step, state, batch, STEPS)
    result["kernels"] = {"ms_per_step": 1e3 * seconds, "patches_per_s": BATCH / seconds,
                         "peak_gib": peak}
    print(f"[kernels] {1e3 * seconds:.2f} ms/step, {BATCH / seconds:.2f} patches/s, "
          f"peak {peak:.2f} GiB [{card}]", flush=True)
    prof = profile(lambda: step(state, batch), PROFILED, OUT_DIR / "trace_train.json")
    prof["busy_over_unprofiled_wall"] = prof["busy_ms"] / 1e3 / seconds
    result["kernels"].update(prof)
    _print_breakdown("kernels", prof)
    print(f"[kernels] busy / unprofiled wall: {prof['busy_over_unprofiled_wall']:.4f}",
          flush=True)

    def plain_step(st, b):
        loss = dice_ce_loss(model(b["image"], return_encoder_features=False), b["label"],
                            softmax=True, to_onehot_y=True)
        st.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        st.optimizer.step()
        return st, loss.detach()

    route_min_hw = conv3d.OF_MIN_HW
    conv3d.OF_MIN_HW = float("inf")  # no conv routed to the kernels
    try:
        seconds, peak = _time_steps(plain_step, state, batch, STEPS)
    finally:
        conv3d.OF_MIN_HW = route_min_hw
    result["no_kernels"] = {"ms_per_step": 1e3 * seconds, "peak_gib": peak}
    print(f"[no kernels] cuDNN convs, autograd loss: {1e3 * seconds:.2f} ms/step, "
          f"peak {peak:.2f} GiB [{card}]", flush=True)
    with open(OUT_DIR / "profile_train.json", "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
