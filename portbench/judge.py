"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``portbench/reference``, reached through the
configuration's architecture file) on the same weights and inputs, each
number beside the limit in ``limits/<workload>.json``.

Serving: the reference's blended float32 logits of every served volume. CT
answers are class labels; a voxel's gap is how far the reference's logit of
the served class lies below the reference's best. MRI answers are the
BraTS label map (1 WT, 2 TC, 3 ET; ET over TC over WT); each label implies
channel decisions (3: ET on; 2: TC on, ET off; 1: WT on, TC and ET off; 0:
all three off), and a decision's gap is how far the reference's logit lies
on the other side of 0. ``gap_max`` is the widest gap over every voxel of
every served volume.

Training: the program's first three steps against the reference's three
steps from the same weights on the same batches. ``loss_gap``: the largest
relative gap of a step's loss. ``grad_gap``: over the counted weights, the
largest gap between the norms of the program's first gradient (from its
AdamW first moment after one step) and of the reference's, over the larger
of the reference's norm of that weight and the median weight's.
``grad_gap_median``: the median weight's gap of the same kind.
``change_gap``: the worst weight's gap for the norm of each weight's change
over the three steps. Counted weights: those whose reference gradient norm is at
least a thousandth of the median weight's (the conv biases ahead of an
instance norm have a gradient of zero up to rounding, and Adam moves them by
round-off alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import swi
from portbench.reference.adamw import AdamW
from portbench.reference.loss import dice_ce

COUNTED_SHARE = 1e-3


def reference_precision() -> None:
    """Float32 means float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reference_logits(arch, weights: dict, config: dict, volume: torch.Tensor, device,
                     precision: str = "fp32") -> torch.Tensor:
    """The reference's (D, H, W, K) float32 logits of a host volume, by the
    forward of architecture ``arch``."""
    m = config["model"]
    serve = config["serve"]
    vol = torch.as_tensor(volume).to(device)
    with torch.no_grad():
        return swi.infer(vol, lambda x: arch.forward(weights, m, x, precision),
                         m["out_channels"], serve, serve["sw_batch"])


def label_map(logits: torch.Tensor, task: str) -> torch.Tensor:
    """The answer the reference itself would serve (the control's path)."""
    if task == "ct":
        return logits.argmax(dim=-1).to(torch.int16)
    on = logits >= 0
    out = torch.zeros(logits.shape[:-1], dtype=torch.int16, device=logits.device)
    out[on[..., 2]] = 1
    out[on[..., 1]] = 2
    out[on[..., 3]] = 3
    return out


def serve_gap(ref: torch.Tensor, answer, task: str) -> float:
    """The widest gap of one served label map against the reference's logits."""
    lab = torch.as_tensor(np.asarray(answer)).to(ref.device).long()
    if tuple(lab.shape) != tuple(ref.shape[:-1]):
        return math.inf
    if task == "ct":
        if lab.min() < 0 or lab.max() >= ref.shape[-1]:
            return math.inf
        got = ref.gather(-1, lab.unsqueeze(-1)).squeeze(-1)
        return float((ref.max(dim=-1).values - got).max())
    if lab.min() < 0 or lab.max() > 3:
        return math.inf
    tc, wt, et = ref[..., 1], ref[..., 2], ref[..., 3]
    zero = torch.zeros_like(tc)

    def on(z):  # the reference says off where z < 0
        return torch.clamp(-z, min=0.0)

    def off(z):  # the reference says on where z >= 0
        return torch.where(z >= 0, z, zero)

    gap = torch.where(lab == 3, on(et), zero)
    gap = torch.maximum(gap, torch.where(lab == 2, torch.maximum(on(tc), off(et)), zero))
    gap = torch.maximum(gap, torch.where(
        lab == 1, torch.maximum(on(wt), torch.maximum(off(tc), off(et))), zero))
    gap = torch.maximum(gap, torch.where(
        lab == 0, torch.maximum(off(wt), torch.maximum(off(tc), off(et))), zero))
    return float(gap.max())


def reference_steps(arch, weights0: dict, config: dict, batches: list[dict], device,
                    precision: str = "fp32", rows: int | None = None) -> dict:
    """The reference's training steps (the forward of architecture ``arch``)
    from ``weights0`` on ``batches``:
    each step's loss, every weight's first-gradient norm and the norm of its
    change over the steps. ``rows`` keeps the first rows of each batch only
    (the half-batch fault)."""
    m, task = config["model"], config["task"]
    w = {k: v.detach().clone().requires_grad_(True) for k, v in weights0.items()}
    opt = AdamW(w, config["train"])
    losses, grad_norms = [], None
    names = list(w)
    for i, batch in enumerate(batches):
        image = torch.as_tensor(batch["image"]).to(device)[:rows]
        label = torch.as_tensor(batch["label"]).to(device)[:rows]
        loss = dice_ce(arch.forward(w, m, image, precision), label, task)
        grads = torch.autograd.grad(loss, [w[k] for k in names], allow_unused=True)
        g = {k: torch.zeros_like(w[k]) if gr is None else gr for k, gr in zip(names, grads)}
        if i == 0:
            grad_norms = leaf_norms(g)
        opt.step(g)
        losses.append(float(loss.detach()))
        del loss, grads, g
    with torch.no_grad():
        change = leaf_norms({k: w[k] - weights0[k] for k in names})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def leaf_norms(tensors: dict) -> dict[str, float]:
    norms = torch.stack([t.detach().float().norm() for t in tensors.values()]).tolist()
    return dict(zip(tensors, norms))


def _leaf_gaps(got: dict, ref: dict, counted: list[str]) -> list[float]:
    median = float(np.median([ref[k] for k in counted]))
    return [abs(got[k] - ref[k]) / max(ref[k], median) for k in counted]


def train_numbers(got: dict, ref: dict) -> dict[str, float]:
    """loss_gap, grad_gap and change_gap of readings ``got`` against the
    reference's ``ref`` (both as ``reference_steps`` returns them)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    if len(got["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    median = float(np.median(list(ref["grad_norms"].values())))
    counted = [k for k, v in ref["grad_norms"].items() if v >= COUNTED_SHARE * median]
    grads = _leaf_gaps(got["grad_norms"], ref["grad_norms"], counted)
    return {
        "loss_gap": max(losses),
        "grad_gap": max(grads),
        "grad_gap_median": float(np.median(grads)),
        "change_gap": max(_leaf_gaps(got["change_norms"], ref["change_norms"], counted)),
    }


def checks(numbers: dict[str, float], limits: dict, failed: int) -> tuple[bool, dict]:
    """Each number beside its limit; ``failed`` requests are held to 0."""
    out = {name: {"value": numbers.get(name, math.nan), "limit": spec["limit"]}
           for name, spec in limits["numbers"].items()}
    out["failed"] = {"value": failed, "limit": 0}
    ok = all(c["value"] <= c["limit"] for c in out.values())  # a NaN fails
    return ok, out
