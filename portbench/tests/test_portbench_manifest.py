"""BENCHMARK.json against its format's names, keys and limits, and the
harness finding each cell's files by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import manifest
from portbench.tests.tiny import REPO, TINY_CELLS, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group if group in ("configs", "workloads") else "metric", entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                    assert "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    assert len(names) == len(set(names))


def test_entries_have_just_the_format_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        reported = {n for n, m in e2e.items() if cell in m.get("workloads", [cell])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
        assert layer
        for m in layer:  # each moves an end-to-end metric its cells report
            assert m["moves"] in reported


def test_rooflines_and_mfu_are_named_by_the_format():
    names = [m["name"] for m in BENCH["per_layer"]]
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
    for kind in ("serve", "train"):
        assert f"model.mfu.{kind}" in names and f"hand_kernels_roofline.{kind}" in names


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = manifest.load(REPO, cell)
    assert c.traffic["kind"] in ("serve", "train")
    assert set(c.limits["numbers"]) and all("limit" in v for v in c.limits["numbers"].values())
    for m in c.per_layer:
        assert callable(manifest.metric_reader(c.folder, m["name"]))
    assert manifest.kernel_families(c.folder)


def test_a_new_workload_is_found_without_editing_a_file(tmp_path):
    root = make_root(tmp_path)
    for path in (REPO / "portbench").rglob("*"):
        if path.is_file() and "tests" not in path.parts and "__pycache__" not in path.parts:
            copy = root / path.relative_to(REPO)
            assert copy.read_bytes() == path.read_bytes(), path  # nothing edited, only added
    for cell in TINY_CELLS:
        c = manifest.load(root, cell)
        assert c.name == cell and c.config["model"]["hidden_size"] == 32
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
