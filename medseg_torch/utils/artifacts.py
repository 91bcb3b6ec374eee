"""Run artifacts (a copy of ``medseg/utils/artifacts.py``): an append-mode
text log with JSONL events, ``.npy`` dumps of metric series, the loss and
mean-Dice curves, the pretraining loss-vs-time figure, and slice-overlay
PDFs of label and prediction (up to 15 slices whose label AND prediction
contain every class, the input in gray under the masks in magma).
matplotlib is imported inside each function that draws, as in the JAX
package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Sequence

import numpy as np


class RunLogger:
    """Append-mode text log + JSONL structured events."""

    def __init__(self, directory: str, name: str = "train") -> None:
        os.makedirs(directory, exist_ok=True)
        self.text_path = os.path.join(directory, f"{name}_logger.txt")
        self.jsonl_path = os.path.join(directory, f"{name}_events.jsonl")

    def write(self, message: str) -> None:
        with open(self.text_path, "a") as f:
            f.write(message.rstrip("\n") + "\n")

    def event(self, kind: str, **fields) -> None:
        record = {"time": time.time(), "kind": kind, **fields}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")


def save_metric_series(directory: str, prefix: str, series: dict[str, Sequence[float]]) -> None:
    """``np.save`` one file per metric series."""
    os.makedirs(directory, exist_ok=True)
    for name, values in series.items():
        np.save(os.path.join(directory, f"{prefix}_{name}.npy"), np.asarray(values))


def plot_training_curves(
    path: str,
    loss: Sequence[float],
    metric: Sequence[float],
    eval_num: int,
) -> None:
    """Two-panel loss / mean-Dice figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
    ax1.plot(np.arange(1, len(loss) + 1), loss)
    ax1.set_title("Iteration Average Loss")
    ax1.set_xlabel("Iteration")
    ax2.plot(eval_num * np.arange(1, len(metric) + 1), metric)
    ax2.set_title("Val Mean Dice")
    ax2.set_xlabel("Iteration")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_loss_vs_time(path: str, losses: Sequence[float], times: Sequence[float]) -> None:
    """Pretraining loss vs cumulative wall time."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.cumsum(np.asarray(times)), losses)
    ax.set_xlabel("Cumulative loss time (s)")
    ax.set_ylabel("Epoch ranking loss")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def select_overlay_slices(
    label_map: np.ndarray, pred_map: np.ndarray, n_classes: int, max_slices: int = 15
) -> list[int]:
    """Slices (axis 2) where label AND prediction contain all classes."""
    out = []
    for z in range(label_map.shape[2]):
        lab, pred = label_map[:, :, z], pred_map[:, :, z]
        if len(np.unique(lab)) >= n_classes and len(np.unique(pred)) >= n_classes:
            out.append(z)
        if len(out) >= max_slices:
            break
    return out


def overlay_slices(
    label_map: np.ndarray, pred_map: np.ndarray, n_classes: int, max_slices: int = 15
) -> list[int]:
    """The slices an overlay shows: ``select_overlay_slices``, or where no
    slice has every class, the slices with the most labelled voxels."""
    slices = select_overlay_slices(label_map, pred_map, n_classes, max_slices)
    if not slices:
        counts = [(int((label_map[:, :, z] > 0).sum()), z) for z in range(label_map.shape[2])]
        slices = [z for n, z in sorted(counts, reverse=True)[:max_slices] if n > 0]
    return slices


def save_slice_overlays(
    path: str,
    image: np.ndarray,  # (X, Y, Z) grayscale
    label_map: np.ndarray,  # (X, Y, Z) int class map
    pred_map: np.ndarray,  # (X, Y, Z) int class map
    n_classes: int,
    max_slices: int = 15,
) -> int:
    """Render label-vs-prediction overlay pages into one PDF; returns the
    number of slices rendered."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    slices = overlay_slices(label_map, pred_map, n_classes, max_slices)
    with PdfPages(path) as pdf:
        for z in slices:
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 5))
            for ax, overlay, title in (
                (ax1, label_map[:, :, z], "label"),
                (ax2, pred_map[:, :, z], "prediction"),
            ):
                ax.imshow(image[:, :, z], cmap="gray", interpolation="none")
                masked = np.ma.masked_where(overlay == 0, overlay)
                ax.imshow(
                    masked,
                    cmap="magma",
                    interpolation="none",
                    alpha=0.5,
                    vmin=0,
                    vmax=max(n_classes - 1, 1),
                )
                ax.set_title(f"{title} z={z}")
                ax.axis("off")
            pdf.savefig(fig)
            plt.close(fig)
    return len(slices)
