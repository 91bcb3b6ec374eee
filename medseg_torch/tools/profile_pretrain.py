"""Where the pretraining step's time goes, on one NVIDIA GPU.

    python -m medseg_torch.tools.profile_pretrain    # from the repository root

Runs the ranking pretraining step as ``chip_smoke.py`` does (UNETR-B/16
widths, 1 -> 14 channels, bf16, remat, AdamW lr 1e-4 and weight decay 1e-5,
random weights from a seed; a batch of two noise volumes x two overlapping
96^3 crops; 4 partitions, temperature 0.1) for three cells:

- ``feat``: the encoder stage at feature size 16 (ViT blocks up to enc4's
  tap, encoder4);
- ``recon``: the decoder stage at feature size 16 (frozen encoder; K1, K6);
- ``recon_flat``: the decoder stage at feature size 32 with the flat
  per-conv route on (decoder3.conv1 through K9).

For each, after ``WARM`` steps: ms/step on the host clock over ``STEPS``
steps, each read back with ``float(loss)`` as the CLI does, and peak memory;
then ``torch.profiler`` over ``PROFILED`` steps: device time and launches per
kernel class, busy time and the idle share of the traced span
(``profile_serving.profile``). Prints one line per measurement and writes all
of it as JSON to ``chiprun_out/profile_pretrain.json``.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from medseg_torch.tools.profile_serving import OUT_DIR, _print_breakdown, profile

WARM = 2
STEPS = 5
PROFILED = 3
CROP, SOURCE = 96, 128
CELLS = (("feat", "feat", 16, False), ("recon", "recon", 16, False),
         ("recon_flat", "recon", 32, True))


def batch(g: torch.Generator, device) -> torch.Tensor:
    """Two noise volumes, two overlapping CROP^3 crops of each, in the
    loader's order [vol1_crop1, vol1_crop2, vol2_crop1, vol2_crop2]."""
    vols = torch.randn((2, 1) + (SOURCE,) * 3, generator=g)
    off = SOURCE - CROP
    origins = ((0, 0, 0), (off, off // 2, off // 4))
    return torch.stack([vols[v, :, a:a + CROP, b:b + CROP, c:c + CROP]
                        for v in range(2) for a, b, c in origins]).to(device)


def main() -> None:
    from medseg_torch.engine.pretrain import feature_dim_for_axis, make_pretrain_step
    from medseg_torch.engine.state import create_train_state
    from medseg_torch.kernels import conv3d
    from medseg_torch.models.unetr import UNETR
    from medseg_torch.ops.ranking import sample_partition_indices

    if not torch.cuda.is_available():
        raise SystemExit("profile_pretrain: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    device = torch.device("cuda", 0)
    result = {"card": card}
    route = conv3d.PALLAS_PER_CONV
    for label, arc, feature_size, flat in CELLS:
        g = torch.Generator().manual_seed(0)
        model = UNETR(in_channels=1, out_channels=14, img_size=(CROP,) * 3,
                      feature_size=feature_size, dtype=torch.bfloat16, remat=True)
        state = create_train_state(model, generator=g, learning_rate=1e-4, weight_decay=1e-5,
                                   device=device)
        images = batch(g, device)
        step = make_pretrain_step(model, update_arc=arc, loss_type="ranking", num_partitions=4,
                                  temperature=0.1)
        rng = np.random.default_rng(0)
        dim = feature_dim_for_axis(CROP, arc, 0)

        def run():
            _, loss = step(state, images, sample_partition_indices(rng, dim, 4), axis=0)
            return float(loss)

        conv3d.PALLAS_PER_CONV = flat
        try:
            for _ in range(WARM):
                run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                run()
            torch.cuda.synchronize()
            seconds = (time.perf_counter() - t0) / STEPS
            peak = torch.cuda.max_memory_allocated() / 2**30
            prof = profile(run, PROFILED, OUT_DIR / f"trace_pretrain_{label}.json")
        finally:
            conv3d.PALLAS_PER_CONV = route
        prof.update(ms_per_step=1e3 * seconds, peak_gib=peak,
                    busy_over_unprofiled_wall=prof["busy_ms"] / 1e3 / seconds)
        result[label] = prof
        print(f"[{label}] feature size {feature_size}, flat route {'on' if flat else 'off'}: "
              f"{1e3 * seconds:.2f} ms/step, peak {peak:.2f} GiB [{card}]", flush=True)
        _print_breakdown(label, prof)
        print(f"[{label}] busy / unprofiled wall: {prof['busy_over_unprofiled_wall']:.4f}",
              flush=True)
        del model, state, images, step
        torch.cuda.empty_cache()
    with open(OUT_DIR / "profile_pretrain.json", "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
