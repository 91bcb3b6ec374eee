"""A data-parallel dry run over N ranks (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``):

    python -m medseg_torch.tools.dryrun_multichip [--world 2] [--device cpu|cuda]
        [--size tiny|full] [--timeout 600]
    python -m medseg_torch.tools.dryrun_multichip --world 2 [--device ...] --cli -- ARGV...

starts ``--world`` ranks of itself on this host (``parallel.launch``: a
``file://`` rendezvous, one time limit for all) and reports rank 0's JSON on
its last line, exiting 1 if a check fails. The ranks use gloo on the CPU and
where they share one card, NCCL where each has a card of its own
(``runtime.initialize_distributed``).

The default run, on a UNETR (``tiny``: 32^3 crops, fp32; ``full``:
UNETR-B/16 at 96^3, bf16, remat, 14 classes) with seeded weights broadcast
from rank 0, and a global batch of 2 crops per rank (``full``: 4 in all):

- one data-parallel step's gradients (each rank its rows, then
  ``all_reduce_gradients``) against rank 0's single-process gradient on
  the whole batch (relative L2 of all leaves together,
  ``GRAD_REL_L2_BOUND``), and against rank 0's mean of every rank's rows'
  gradients computed in one process (the collective's own error,
  ``HALVES_REL_L2_BOUND``); then the step itself
  (``make_train_step(mesh=...)``), 1 warm and ``--steps`` timed;
- the sharded window walk (``Validator(mesh=...)``: the z-row walk) on one
  volume against rank 0's unsharded walk: largest difference, argmax
  agreement, every rank's logits the same bits, seconds per volume of both;
- the confusion counts of each rank's rows, all-reduced
  (``psum_metric_counts``), against rank 0's counts of the whole batch.

``--cli``: ARGV goes to ``medseg_torch.cli.segmentation`` on every rank
(the caller's flags, e.g. ``--data-parallel --device cpu``); each rank
reports its final metrics, its checkpoint saves and its steps' seconds, and
the run fails unless every rank's metrics are the same and rank 0 alone
saved.

Each rank's report carries its kernel launches (``launches``: those the
host issued on the data-parallel path, not on rank 0's single-process
references; on a CUDA device the sharded walk's replayed CUDA graphs add
none) and the collectives its mesh issued.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

RESULT = "result.rank{}.json"
# the data-parallel gradient against one process on the whole batch: the
# tiny run is fp32 on both sides, only the order of the sums differs; the
# full run is bf16, where a batch of 2 rounds here and there otherwise than
# a batch of 4 (cuBLAS's GEMM shapes, the conv statistics' tile groups) and
# bf16 flips of one unit in the last place carry through the backward: held
# below the bf16 kernels' own distance from fp32 (9.4e-3, chip_smoke.py's
# training phase). Against one process adding the same two halves'
# gradients (the collective's own error) both runs must agree to 1e-6.
GRAD_REL_L2_BOUND = {"tiny": 1e-5, "full": 1e-2}
HALVES_REL_L2_BOUND = 1e-6
ARGMAX_AGREEMENT_BOUND = 0.9999


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model(size: str):
    from medseg_torch.models.unetr import UNETR, unetr_b16

    if size == "full":
        return unetr_b16(1, 14, 96, dtype=torch.bfloat16, remat=True), 96, 14
    model = UNETR(in_channels=1, out_channels=4, img_size=(32, 32, 32), feature_size=4,
                  hidden_size=24, mlp_dim=48, num_heads=4, num_layers=4, patch_size=16)
    return model, 32, 4


def launch_counts() -> dict:
    """Each kernel wrapper's launches in this process, ``<name>[tc]`` those
    that took the tensor cores and ``<name>[narrow]`` those that took the
    narrow-input kernel."""
    from medseg_torch.kernels import conv_flat, conv_of, loss_of, norm_of

    counts = {}
    for fn in conv_of.KERNELS + loss_of.KERNELS + conv_flat.KERNELS + norm_of.KERNELS:
        counts[fn.__name__] = fn.launches
        for route in ("tc", "narrow"):
            if hasattr(fn, f"{route}_launches"):
                counts[f"{fn.__name__}[{route}]"] = getattr(fn, f"{route}_launches")
    return counts


class Launches:
    """Adds the kernel launches made inside each ``with`` block to
    ``counts``."""

    def __init__(self) -> None:
        self.counts: dict = {}

    def __enter__(self):
        self._before = launch_counts()
        return self

    def __exit__(self, *exc) -> None:
        for name, n in launch_counts().items():
            self.counts[name] = self.counts.get(name, 0) + n - self._before[name]


def _flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1).float() for p in model.parameters()])


def check(size: str, device: str, steps: int) -> dict:
    """One rank of the default run; returns its report."""
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.engine.state import create_train_state, fill_missing_gradients
    from medseg_torch.engine.train import make_loss_fn, make_train_step
    from medseg_torch.ops.post import argmax_onehot
    from medseg_torch.ops.sliding_window import SlidingWindowSpec
    from medseg_torch.parallel import make_mesh, psum_metric_counts, replicate, shard_batch
    from medseg_torch.parallel.mesh import all_reduce_gradients, global_batch_rows
    from medseg_torch.parallel.runtime import barrier, initialize_distributed

    initialize_distributed(device=device)
    mesh = make_mesh(device)
    dev = mesh.device
    model, crop, classes = _model(size)
    state = create_train_state(model, generator=torch.Generator().manual_seed(0),
                               learning_rate=1e-4, weight_decay=1e-5, device=dev)
    replicate(mesh, model)
    report = {"world": mesh.data, "rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
              "size": size}
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(dev)
    global_batch = 4 if size == "full" else 2 * mesh.data
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn((global_batch, 1, crop, crop, crop), generator=g),
             "label": torch.randint(0, classes, (global_batch, crop, crop, crop), generator=g,
                                    dtype=torch.int32)}
    local = shard_batch(mesh, batch)
    loss_fn = make_loss_fn("ct")

    # the data-parallel gradient against the single-process one; the
    # launches of the data-parallel path alone are counted (not the
    # single-process references')
    path = Launches()
    with path:
        loss = loss_fn(model, local["image"], local["label"])
        loss.backward()
        fill_missing_gradients(model)
        all_reduce_gradients(mesh, model)
    dp = _flat_grads(model)
    model.zero_grad(set_to_none=True)
    if mesh.rank == 0:
        ref_loss = loss_fn(model, batch["image"].to(dev), batch["label"].to(dev))
        ref_loss.backward()
        fill_missing_gradients(model)
        ref = _flat_grads(model)
        model.zero_grad(set_to_none=True)
        report["grad_rel_l2"] = ((dp - ref).norm() / ref.norm()).item()
        report["loss_single_process"] = ref_loss.item()
        halves = torch.zeros_like(ref)
        del ref
        per = global_batch // mesh.data
        for r in range(mesh.data):  # every rank's rows in this one process
            rows = slice(r * per, (r + 1) * per)
            loss_fn(model, batch["image"][rows].to(dev), batch["label"][rows].to(dev)).backward()
            fill_missing_gradients(model)
            halves += _flat_grads(model)
            model.zero_grad(set_to_none=True)
        halves *= 1.0 / mesh.data
        report["grad_halves_rel_l2"] = ((dp - halves).norm() / halves.norm()).item()
        del halves
    del dp
    barrier("gradients_compared")

    # the step itself, timed
    step = make_train_step(model, task="ct", mesh=mesh)
    with path:
        state, first = step(state, local)
        _sync(dev)
        t0 = time.perf_counter()
        losses = [first]
        for _ in range(steps):
            state, loss = step(state, local)
            losses.append(loss)
        _sync(dev)
    report["step_ms"] = 1e3 * (time.perf_counter() - t0) / steps
    report["losses"] = [v.item() for v in losses]
    del state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the sharded walk against the unsharded one
    model.eval()
    spec = SlidingWindowSpec(roi=(crop,) * 3, overlap=0.25, sw_batch=4, bucket_multiple=32)
    shape = (192, 192, 191) if size == "full" else (48, 48, 40)
    volume = np.random.default_rng(3).standard_normal(shape + (1,), dtype=np.float32)
    sharded = Validator(model, classes, "ct", spec, device=dev, mesh=mesh)
    with path:
        sharded.infer_volume(volume)  # warm
        _sync(dev)
        t0 = time.perf_counter()
        logits = sharded.infer_volume(volume)
        _sync(dev)
    report["walk_seconds"] = time.perf_counter() - t0
    first = logits.clone()
    mesh.broadcast_(first)
    same = torch.tensor([int(torch.equal(first, logits))], device=dev)
    mesh.all_reduce_(same)
    report["ranks_identical"] = int(same.item()) == mesh.data
    if mesh.rank == 0:
        single = Validator(model, classes, "ct", spec, device=dev)
        single.infer_volume(volume)
        _sync(dev)
        t0 = time.perf_counter()
        ref = single.infer_volume(volume)
        _sync(dev)
        report["walk_seconds_single_process"] = time.perf_counter() - t0
        report["walk_max_abs_diff"] = (logits - ref).abs().max().item()
        report["walk_largest_logit"] = ref.abs().max().item()
        report["argmax_agreement"] = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        report["walk_bitwise"] = torch.equal(logits, ref)
        del ref
    barrier("walk_compared")

    # the all-reduced confusion counts of each rank's rows
    g = torch.Generator().manual_seed(4)
    labels = torch.randint(0, classes, (2 * mesh.data, 16, 16, 16), generator=g)
    guesses = torch.randint(0, classes, (2 * mesh.data, 16, 16, 16), generator=g)
    pred = argmax_onehot(torch.nn.functional.one_hot(guesses, classes).float(), classes)
    target = torch.nn.functional.one_hot(labels, classes)
    rows = global_batch_rows(mesh, 2)
    counts = psum_metric_counts(mesh, pred[rows].to(dev), target[rows].to(dev))
    if mesh.rank == 0:
        from medseg_torch.ops.metrics import confusion_counts

        whole = confusion_counts(pred, target).sum(0).float()
        report["counts_equal"] = torch.equal(counts.cpu(), whole)
    report["collectives"] = mesh.collectives
    report["launches"] = path.counts
    return report


def run_cli(argv: list[str]) -> dict:
    """One rank of ``--cli``: the segmentation CLI, with its checkpoint
    saves counted and its steps timed."""
    from medseg_torch.cli import segmentation
    from medseg_torch.engine.checkpoint import CheckpointManager
    from medseg_torch.parallel.runtime import process_info

    saves, steps = [], []
    save = CheckpointManager.save
    make_step = segmentation.make_train_step

    def counted_save(self, *args, **kw):
        saves.append(kw.get("name", "best"))
        return save(self, *args, **kw)

    def timed_make_train_step(model, **kw):
        step = make_step(model, **kw)
        device = next(model.parameters()).device

        def timed(state, batch):
            _sync(device)
            t0 = time.perf_counter()
            out = step(state, batch)
            _sync(device)
            steps.append(time.perf_counter() - t0)
            return out
        return timed

    CheckpointManager.save = counted_save
    segmentation.make_train_step = timed_make_train_step
    try:
        t0 = time.perf_counter()
        results = segmentation.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        CheckpointManager.save = save
        segmentation.make_train_step = make_step
    rank, world = process_info()
    return {"rank": rank, "world": world, "final": results, "saves": saves,
            "step_seconds": steps, "cli_seconds": seconds, "launches": launch_counts()}


def _worker(ns, rest) -> None:
    report = run_cli(rest) if ns.cli else check(ns.size, ns.device, ns.steps)
    with open(os.path.join(ns.out, RESULT.format(report["rank"])), "w") as f:
        json.dump(report, f)


def failures(reports: list[dict], size: str, cli: bool) -> list[str]:
    """What the ranks' reports break of the run's checks."""
    bad = []
    if cli:
        finals = [r["final"] for r in reports]
        if any(f != finals[0] for f in finals):
            bad.append(f"final metrics differ between ranks: {finals}")
        if not reports[0]["saves"] or any(r["saves"] for r in reports[1:]):
            bad.append(f"checkpoint saves by rank: {[r['saves'] for r in reports]}")
        return bad
    first = reports[0]
    if not first["grad_rel_l2"] <= GRAD_REL_L2_BOUND[size]:
        bad.append(f"gradient rel L2 {first['grad_rel_l2']} > {GRAD_REL_L2_BOUND[size]}")
    if not first["grad_halves_rel_l2"] <= HALVES_REL_L2_BOUND:
        bad.append(f"gradient rel L2 against the same halves in one process "
                   f"{first['grad_halves_rel_l2']} > {HALVES_REL_L2_BOUND}")
    if not first["argmax_agreement"] >= ARGMAX_AGREEMENT_BOUND:
        bad.append(f"argmax agreement {first['argmax_agreement']} < {ARGMAX_AGREEMENT_BOUND}")
    if not all(r["ranks_identical"] for r in reports):
        bad.append("the ranks' walks differ")
    if not first["counts_equal"]:
        bad.append("all-reduced confusion counts differ from the whole batch's")
    if not all(np.isfinite(r["losses"]).all() for r in reports):
        bad.append(f"non-finite losses {[r['losses'] for r in reports]}")
    return bad


def launch(world: int, device: str, size: str = "tiny", steps: int = 3, cli_argv=None,
           timeout: float = 600.0, env: dict | None = None) -> tuple[list[dict], list[str]]:
    """Runs the ranks; returns their reports (rank order) and the failed
    checks. Raises if a rank fails or the ranks outlast ``timeout``."""
    from medseg_torch.parallel.launch import run_ranks

    env = dict(env or {})
    if device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the ranks share the cores: one pool each of all of them spins
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as out:
        args = ["-m", "medseg_torch.tools.dryrun_multichip", "--rank-worker", "--out", out,
                "--device", device, "--size", size, "--steps", str(steps)]
        if cli_argv is not None:
            args += ["--cli", "--", *cli_argv]
        run_ranks(args, world, timeout=timeout, env=env, workdir=out)
        reports = []
        for rank in range(world):
            with open(os.path.join(out, RESULT.format(rank))) as f:
                reports.append(json.load(f))
    return reports, failures(reports, size, cli_argv is not None)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rest = []
    if "--" in argv:
        i = argv.index("--")
        argv, rest = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", choices=("tiny", "full"), default="tiny")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--cli", action="store_true")
    p.add_argument("--rank-worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    ns = p.parse_args(argv)
    if ns.rank_worker:
        _worker(ns, rest)
        return 0
    if ns.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: no CUDA device (pass --device cpu)")
    reports, bad = launch(ns.world, ns.device, ns.size, ns.steps, rest if ns.cli else None,
                          ns.timeout)
    for r in reports:
        print(json.dumps(r), flush=True)
    print("FAILED: " + "; ".join(bad) if bad else "ok", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
