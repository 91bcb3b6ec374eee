"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[]``) names a configuration and a traffic mix. The
configuration is ``configs/<config>.json`` (its ``file`` in the manifest),
whose ``model`` group names its architecture (``"architecture": "unetr"``):
the file ``architectures/<architecture>.py`` builds the program's model and
gives the reference's weights and logits, the layers' operations and the
work of each kernel family (the plain equations sit beside it in
``reference/``). The mix is ``traffic/<traffic>.json``, the cell's
correctness limits ``limits/<workload>.json``, each per-layer metric a
reader ``metrics/<metric>.py`` and each kernel family of the roofline
``kernels/<family>.json``. A later cell, mix, metric, kernel family or
architecture is a new file plus an entry: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]  # the manifest's end-to-end metrics this cell reports
    per_layer: list[dict]  # the per-layer metrics this cell reports
    root: Path
    architecture: ModuleType  # architectures/<name>.py of the configuration

    @property
    def folder(self) -> Path:
        return self.root / "portbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config_file = root / configs[w["config"]]["file"]
    config = load_json(config_file)
    folder = root / "portbench"
    if "architecture" not in config["model"]:
        raise KeyError(f"{config_file}: the model group names no architecture")
    traffic = load_json(folder / "traffic" / f"{w['traffic']}.json")
    limits = load_json(folder / "limits" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)],
        root=root, architecture=architecture(folder, config["model"]["architecture"]),
    )


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(folder: Path, name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return _load_module(folder / "metrics" / f"{name}.py",
                        f"portbench_metric_{name.replace('.', '_')}").read


def architecture(folder: Path, name: str) -> ModuleType:
    """``architectures/<name>.py``: ``parameter_table(m)``, ``build(m, dtype,
    remat)``, ``forward(weights, m, x, precision)``, ``layers(m)``,
    ``kernel_work(family, path, task)`` and ``tiny(config)``, each of the
    configuration's model group ``m`` or of the whole configuration."""
    path = Path(folder) / "architectures" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no architecture {name!r}: {path} is not a file")
    return _load_module(path, f"portbench_architecture_{name.replace('.', '_')}")


def kernel_families(folder: Path) -> dict[str, dict]:
    """Every ``kernels/<family>.json``, by family name."""
    return {p.stem: load_json(p) for p in sorted((folder / "kernels").glob("*.json"))}
