"""A checkout root with tiny cells, for driving the harness on the CPU.

``make_root(tmp)`` copies ``BENCHMARK.json`` and ``portbench/`` into
``tmp`` and adds, for each configuration of ``TINY_CELLS``, its tiny form
as the configuration's architecture file cuts it (``tiny(config)``; for
UNETR the published structure at hidden 32, 4 layers, 32^3 windows), with a
serve and a train cell each, under the real traffic mixes and with the real
cells' limits. ``add_cells`` adds further cells the same way, as new files
and entries only.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import manifest

REPO = Path(__file__).resolve().parents[2]
TINY_CELLS = {  # tiny cell -> (real cell, real config)
    "tiny-ct-serve": ("btcv-serve-ct512", "unetr_b16_btcv"),
    "tiny-ct-train": ("btcv-train-4x96", "unetr_b16_btcv"),
    "tiny-mri-serve": ("brats-serve-240", "unetr_b16_brats"),
    "tiny-mri-train": ("brats-train-4x128", "unetr_b16_brats"),
}


def tiny_config(config: dict) -> dict:
    """``config`` cut to the CPU tests' size by its architecture's file."""
    arch = manifest.architecture(REPO / "portbench", config["model"]["architecture"])
    return arch.tiny(config)


def _dump(path: Path, data: dict) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    add_cells(root, {cell: (real, tiny_config(_read_config(name)))
                     for cell, (real, name) in TINY_CELLS.items()})
    return root


def _read_config(name: str) -> dict:
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def add_cells(root: Path, cells: dict[str, tuple[str, dict]]) -> None:
    """Adds to ``root`` each cell of ``cells`` (cell -> (real cell, its
    configuration)) as new files and entries only: the configuration as
    ``configs/tiny_<real config>.json``, the real cell's traffic, limits and
    metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    for cell, (real, config) in cells.items():
        tiny = f"tiny_{config['name']}"
        if tiny not in {c["name"] for c in bench["configs"]}:
            _dump(root / "portbench" / "configs" / f"{tiny}.json", dict(config, name=tiny))
            bench["configs"].append({"name": tiny, "source": "tests",
                                     "file": f"portbench/configs/{tiny}.json", "reduced": [],
                                     "why": "a CPU test size"})
        bench["workloads"].append(dict(by_name[real], name=cell, config=tiny))
        shutil.copy(REPO / "portbench" / "limits" / f"{real}.json",
                    root / "portbench" / "limits" / f"{cell}.json")
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if real in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    _dump(root / "BENCHMARK.json", bench)
