"""What a run imports: no JAX, no flax, nothing of the JAX package
(``medseg`` and ``medseg.*``; ``medseg_torch`` is another top-level name),
and nothing of the program in the reference, nor in an architecture's file
until a run builds its model. Each check runs in a fresh interpreter and
compares the top-level part of every name in ``sys.modules`` whole."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "medseg"}
HARNESS = ["portbench.run", "portbench.serve", "portbench.train", "portbench.calibrate",
           "portbench.manifest", "portbench.readings", "portbench.tracing", "portbench.inputs"]
# the entry points a run calls, imported as the run imports them
PROGRAM = ["medseg_torch.models.unetr", "medseg_torch.engine.evaluate", "medseg_torch.engine.train",
           "medseg_torch.engine.state", "medseg_torch.ops.post", "medseg_torch.ops.sliding_window"]
REFERENCE = ["portbench.reference.unetr", "portbench.reference.swi", "portbench.reference.loss",
             "portbench.reference.adamw", "portbench.reference.precision", "portbench.judge",
             "portbench.params"]


def top_level_after(modules: list[str], readers: bool = False,
                    architectures: bool = False) -> set[str]:
    code = (
        "import importlib, json, sys\n"
        "from pathlib import Path\n"
        "folder = Path('portbench')\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
    )
    if readers:
        code += (
            "from portbench import manifest\n"
            "for p in sorted((folder / 'metrics').glob('*.py')):\n"
            "    manifest.metric_reader(folder, p.stem)\n"
        )
    if architectures:
        code += (
            "from portbench import manifest\n"
            "for p in sorted((folder / 'architectures').glob('*.py')):\n"
            "    manifest.architecture(folder, p.stem)\n"
        )
    code += "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("modules,readers", [(HARNESS, True), (HARNESS + PROGRAM, True)],
                         ids=["harness", "harness-and-program"])
def test_a_run_loads_no_jax_and_no_jax_package(modules, readers):
    loaded = top_level_after(modules, readers)
    assert "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    if modules == HARNESS + PROGRAM:
        assert "medseg_torch" in loaded  # a different top-level name from medseg


def test_architecture_files_load_nothing_of_the_program_at_import():
    """Each ``architectures/*.py`` imports the program only inside ``build``,
    when a run starts."""
    assert sorted((REPO / "portbench" / "architectures").glob("*.py"))
    loaded = top_level_after([], architectures=True)
    assert "portbench" in loaded
    assert not loaded & (FORBIDDEN | {"medseg_torch"}), loaded & (FORBIDDEN | {"medseg_torch"})


def test_the_reference_loads_nothing_of_the_program():
    loaded = top_level_after(REFERENCE)
    assert not loaded & (FORBIDDEN | {"medseg_torch"}), loaded & (FORBIDDEN | {"medseg_torch"})


def test_the_harness_reads_nothing_of_the_jax_benchmarks():
    for path in (REPO / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import jax" not in text, path
