"""The control comes out not correct, at each cell's own size, on the card.

The control is the plain reference put in the program's place and computed
in fp8, the precision below the configurations' bf16 (``calibrate.py``).
Each cell's control must fail at least one of the cell's limits. Run on the
card: ``python -m pytest portbench/tests/test_portbench_control_cuda.py -q``
(about a minute a cell); it skips where there is no CUDA device.
"""

from __future__ import annotations

import json

import pytest
import torch

from portbench import calibrate, manifest
from portbench.tests.tiny import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2147483899


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = manifest.load(REPO, cell)
    reading = calibrate.control_reading(c, SEED, torch.device("cuda", 0))
    limits = {name: spec["limit"] for name, spec in c.limits["numbers"].items()}
    assert any(not reading[name] <= limit for name, limit in limits.items()), (reading, limits)
