"""A checkout root with tiny cells, for driving the harness on the CPU.

``make_root(tmp)`` copies ``BENCHMARK.json`` and ``portbench/`` into
``tmp`` and adds a tiny configuration of each task (the published
structure at hidden 32, 4 layers, 32^3 windows) with a serve and a train
cell each, under the real traffic mixes and with the real cells' limits.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_MODEL = {"img_size": 32, "hidden_size": 32, "mlp_dim": 64, "num_heads": 2, "num_layers": 4}
TINY_VOLUME = {"unetr_b16_btcv": [64, 64, 40], "unetr_b16_brats": [48, 48, 39]}
TINY_CELLS = {  # tiny cell -> (real cell, real config)
    "tiny-ct-serve": ("btcv-serve-ct512", "unetr_b16_btcv"),
    "tiny-ct-train": ("btcv-train-4x96", "unetr_b16_btcv"),
    "tiny-mri-serve": ("brats-serve-240", "unetr_b16_brats"),
    "tiny-mri-train": ("brats-train-4x128", "unetr_b16_brats"),
}


def _dump(path: Path, data: dict) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in manifest["workloads"]}
    for cell, (real, config_name) in TINY_CELLS.items():
        config = json.loads((REPO / "portbench" / "configs" / f"{config_name}.json").read_text())
        tiny = f"tiny_{config_name}"
        config["name"] = tiny
        config["model"].update(TINY_MODEL)
        config["serve"]["roi"] = config["train"]["crop"] = TINY_MODEL["img_size"]
        config["serve"]["volume"] = TINY_VOLUME[config_name]
        _dump(root / "portbench" / "configs" / f"{tiny}.json", config)
        if tiny not in {c["name"] for c in manifest["configs"]}:
            manifest["configs"].append({"name": tiny, "source": "tests",
                                        "file": f"portbench/configs/{tiny}.json", "reduced": [],
                                        "why": "a CPU test size"})
        manifest["workloads"].append(dict(by_name[real], name=cell, config=tiny))
        shutil.copy(REPO / "portbench" / "limits" / f"{real}.json",
                    root / "portbench" / "limits" / f"{cell}.json")
        for metric in manifest["end_to_end"] + manifest["per_layer"]:
            if real in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    _dump(root / "BENCHMARK.json", manifest)
    return root
