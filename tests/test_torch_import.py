"""The PyTorch port imports no JAX, flax, triton or JAX package module.

The port runs where JAX is not installed, and triton is imported only inside
a function that launches a kernel. It keeps its own copy of whatever it
needs from ``medseg``, even of modules there that do not import JAX.
``tests/conftest.py`` has already imported jax into this process, so the
check runs in a fresh interpreter.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import medseg_torch
names = sorted(m.name for m in pkgutil.walk_packages(medseg_torch.__path__, "medseg_torch."))
for name in names:
    importlib.import_module(name)
print(",".join(names))
print(",".join(sorted(m for m in ("jax", "flax", "triton") if m in sys.modules)))
print(",".join(sorted(m for m in sys.modules if m == "medseg" or m.startswith("medseg."))))
"""


def test_port_imports_no_jax_flax_or_triton():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    modules, heavy, reference = proc.stdout.split("\n")[:3]
    for name in (
        "medseg_torch.models.blocks", "medseg_torch.models.vit", "medseg_torch.models.unetr",
        "medseg_torch.engine.checkpoint", "medseg_torch.engine.evaluate",
        "medseg_torch.engine.state", "medseg_torch.engine.train",
        "medseg_torch.kernels._build", "medseg_torch.kernels.conv_of",
        "medseg_torch.kernels.conv3d", "medseg_torch.kernels.loss_of",
        "medseg_torch.kernels.kernel_check", "medseg_torch.kernels.unetr_of",
        "medseg_torch.ops.sliding_window", "medseg_torch.ops.post", "medseg_torch.ops.metrics",
        "medseg_torch.ops.losses", "medseg_torch.ops.swi_zrow", "medseg_torch.ops.resample",
        "medseg_torch.tools.profile_serving", "medseg_torch.tools.profile_train",
        "medseg_torch.config", "medseg_torch.data.nifti", "medseg_torch.data.dataset",
        "medseg_torch.data.transforms", "medseg_torch.data.pipelines",
        "medseg_torch.utils.profiling", "medseg_torch.cli.common", "medseg_torch.cli.infer",
        "medseg_torch.ops.ranking", "medseg_torch.kernels.conv_flat", "medseg_torch.engine.pretrain",
        "medseg_torch.data.sampling", "medseg_torch.data.loader", "medseg_torch.utils.artifacts",
        "medseg_torch.cli.pretraining", "medseg_torch.tools.profile_pretrain",
        "medseg_torch.ops.augment", "medseg_torch.cli.segmentation",
        "medseg_torch.parallel", "medseg_torch.parallel.mesh", "medseg_torch.parallel.runtime",
        "medseg_torch.parallel.launch", "medseg_torch.utils.debug",
        "medseg_torch.tools.dryrun_multichip", "medseg_torch.tools.probe_determinism",
    ):
        assert name in modules.split(","), name
    assert heavy == "", f"imported: {heavy}"
    assert reference == "", f"imported from the JAX package: {reference}"


def test_import_builds_nothing():
    """Importing the kernels module compiles nothing: the library is built
    at the first launch on a CUDA tensor."""
    probe = (
        "import medseg_torch.kernels.conv_of, medseg_torch.kernels._build as b; "
        "print(b._lib is None and b.build_seconds is None)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True"


def test_chip_smoke_imports_no_jax_or_reference():
    """``chip_smoke.py`` imports nothing of JAX, flax or the JAX package, at
    the top or inside its phases (every import statement of the file)."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {name.split(".")[0] for name in names}
    assert "medseg_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "medseg"}, sorted(roots)


def test_every_kernel_entry_point_is_bound():
    """Each ``extern "C"`` kernel entry point of ``csrc/*.cu`` (the
    tensor-core routes' among them) has its ctypes signature, and every
    source and header is part of the build's digest."""
    import re

    from medseg_torch.kernels import _build

    defined = set()
    for src in _build.CSRC.glob("*.cu"):
        defined.update(re.findall(r"^int (medseg_\w+)\(", src.read_text(), re.M))
    assert {"medseg_conv_tc", "medseg_wgrad_tc", "medseg_conv3x3x3", "medseg_wgrad"} <= defined
    assert defined == set(_build._SIGNATURES)
    names = {p.name for p in _build._sources()}
    assert {"conv_tc.cu", "wgrad_tc.cu", "tc_common.cuh", "common.cuh"} <= names
