"""BENCHMARK.json against its format's names, keys and limits, and the
harness finding each cell's files by name: a new cell, and a new
architecture, as new files and entries only."""

from __future__ import annotations

import contextlib
import json
import re
import time

import pytest
import torch

from portbench import manifest, tracing
from portbench.run import run_cell
from portbench.tests.tiny import REPO, TINY_CELLS, add_cells, make_root, tiny_config

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


def _keys(data) -> set[str]:
    """Every key of a JSON object, at any depth."""
    if isinstance(data, dict):
        return set(data).union(*(_keys(v) for v in data.values()))
    if isinstance(data, list):
        return set().union(*(_keys(v) for v in data))
    return set()


def test_entries_have_just_the_format_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        keys = _keys(json.loads((REPO / c["file"]).read_text()))
        for key in c["reduced"]:  # each names a key of its configuration file
            assert isinstance(key, str) and NAME.match(key) and key in keys, (c["name"], key)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
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


STUB = '''"""UNETR under another name, recording which of its functions the harness calls."""

from pathlib import Path

from portbench import manifest

_unetr = manifest.architecture(Path(__file__).resolve().parents[1], "unetr")
CALLED = set()


def _recorded(name):
    def call(*args, **kwargs):
        CALLED.add(name)
        return getattr(_unetr, name)(*args, **kwargs)

    return call


parameter_table = _recorded("parameter_table")
build = _recorded("build")
forward = _recorded("forward")
layers = _recorded("layers")
kernel_work = _recorded("kernel_work")
tiny = _recorded("tiny")
'''
STUB_CELLS = {"tiny-stub-serve": "btcv-serve-ct512", "tiny-stub-train": "btcv-train-4x96"}
K1 = "void medseg::(anonymous namespace)::conv_tc_kernel<1, false, 16, 0>(X)"


def made_up_record(run, requests: int) -> tracing.Trace:
    """Serves the traced requests unprofiled and hands back a trace with one
    K1 kernel in each (the CPU has no device to trace)."""
    run(contextlib.nullcontext)
    spans = [(100.0 * i, 100.0 * i + 90.0) for i in range(requests)]
    kernels = [(K1, s + 10.0, s + 50.0) for s, _ in spans]
    return tracing.Trace(kernels=kernels, device_ops=kernels, host_ops=[], requests=spans)


def test_a_new_architecture_is_found_without_editing_a_file(tmp_path, monkeypatch):
    """A second architecture enters as new files and entries only, and both
    of its cells run on the CPU to ``correct`` through its own functions."""
    root = make_root(tmp_path)
    folder = root / "portbench"
    before = {p: p.read_bytes() for p in folder.rglob("*") if p.is_file()}
    (folder / "architectures" / "unetr_stub.py").write_text(STUB)
    config = tiny_config(json.loads((folder / "configs" / "unetr_b16_btcv.json").read_text()))
    config["name"] = "unetr_stub_btcv"
    config["model"]["architecture"] = "unetr_stub"
    add_cells(root, {cell: (real, config) for cell, real in STUB_CELLS.items()})
    for path, data in before.items():
        assert path.read_bytes() == data, path  # nothing edited, only added
    monkeypatch.setattr(tracing, "record", made_up_record)
    torch.set_num_threads(4)
    for cell in STUB_CELLS:
        c = manifest.load(root, cell)
        assert c.config["model"]["architecture"] == "unetr_stub"
        for trace in (False, True):
            result = run_cell(c, 2147483713, 0.05, trace, torch.device("cpu"),
                              time.perf_counter())
            assert result["correct"] is True, result["checks"]
        kind = c.traffic["kind"]
        assert {f"model.mfu.{kind}", f"hand_kernels_roofline.{kind}"} <= set(result["metrics"])
        assert c.architecture.CALLED >= {"parameter_table", "build", "forward", "layers",
                                         "kernel_work"}, (cell, c.architecture.CALLED)


def test_a_configuration_that_names_no_architecture_is_an_error(tmp_path):
    root = make_root(tmp_path)
    path = root / "portbench" / "configs" / "tiny_unetr_b16_btcv.json"
    config = json.loads(path.read_text())
    del config["model"]["architecture"]
    path.write_text(json.dumps(config))
    with pytest.raises(KeyError, match="names no architecture"):
        manifest.load(root, "tiny-ct-serve")
    config["model"]["architecture"] = "no_such_architecture"
    path.write_text(json.dumps(config))
    with pytest.raises(KeyError, match="no architecture 'no_such_architecture'"):
        manifest.load(root, "tiny-ct-serve")
