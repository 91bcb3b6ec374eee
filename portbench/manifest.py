"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[]``) names a configuration and a traffic mix. The
configuration is ``configs/<config>.json`` (its ``file`` in the manifest),
the mix ``traffic/<traffic>.json``, the cell's correctness limits
``limits/<workload>.json``, each per-layer metric a reader
``metrics/<metric>.py`` and each kernel family of the roofline
``kernels/<family>.json``. A later cell, mix, metric or family is a new file
plus an entry: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


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
    config = load_json(root / configs[w["config"]]["file"])
    folder = root / "portbench"
    traffic = load_json(folder / "traffic" / f"{w['traffic']}.json")
    limits = load_json(folder / "limits" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)],
        root=root,
    )


def metric_reader(folder: Path, name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = folder / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_families(folder: Path) -> dict[str, dict]:
    """Every ``kernels/<family>.json``, by family name."""
    return {p.stem: load_json(p) for p in sorted((folder / "kernels").glob("*.json"))}
