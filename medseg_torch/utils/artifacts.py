"""Run artifacts (a copy of the part of ``medseg/utils/artifacts.py`` that
the pretraining CLI uses): an append-mode text log with JSONL events, ``.npy``
dumps of metric series, and the loss-vs-time figure. matplotlib is imported
inside the function that draws, as in the JAX package.
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
