"""The port's serving CLI (``medseg_torch.cli.infer``) against the JAX
package's (``medseg.cli.infer``), end to end on the CPU.

Both read the same synthetic Decathlon directory (``tests/test_cli.py``'s
``make_dataset``) and the same ``.pth``, written from a seeded port model
with ``torch.save(model.state_dict())``. The JAX CLI on the CPU runs its
flax forward through the flat walk with an fp32 accumulator; the port runs
the fused forward (plain versions of its kernels) through the z-row walk
(the bucketed 64^3 grid of a 36^3 volume is even). Written label maps agree
on at least 99.9% of the voxels at ``--acc fp32`` (only near-ties of the
logits, which agree to ~2e-3 at worst, can flip; all agreed when this was
written) and 99% at the default bf16 accumulator, which rounds every blend
step (99.97-99.99% when this was written); shape and affine are kept.
"""

import json
import os

import numpy as np
import pytest
import torch
from test_cli import TINY, make_dataset

from medseg.cli.infer import main as jax_infer
from medseg.data.nifti import read_nifti
from medseg_torch.cli.infer import main as port_infer
from medseg_torch.engine.checkpoint import load_torch_checkpoint
from medseg_torch.models.unetr import UNETR, init_weights

TINY_MODEL = dict(in_channels=1, out_channels=2, img_size=(32, 32, 32), feature_size=2,
                  hidden_size=16, mlp_dim=32, num_heads=2, num_layers=4)


def _checkpoint(path, seed=0):
    model = init_weights(UNETR(**TINY_MODEL), torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), path)
    return model


def _label_maps(paths):
    return [read_nifti(p) for p in paths]


def test_infer_cli_matches_jax(tmp_path):
    data_dir = make_dataset(tmp_path, n=2)
    ckpt = str(tmp_path / "model.pth")
    _checkpoint(ckpt)
    want = _label_maps(jax_infer([data_dir, "TinyCT", ckpt, str(tmp_path / "jax"), "2"] + TINY))
    runs = {
        "fp32": ["--acc", "fp32", "--stats-json", str(tmp_path / "stats.json")],
        "bf16": ["--host-preprocess", "--no-prefetch"],
    }
    for acc, extra in runs.items():
        out_dir = str(tmp_path / f"port_{acc}")
        written = port_infer([data_dir, "TinyCT", ckpt, out_dir, "2", "--device", "cpu"]
                             + extra + TINY)
        assert [os.path.basename(p) for p in written] == ["i0_pred.nii.gz", "i1_pred.nii.gz"]
        got = _label_maps(written)
        agree = [float((g.data == w.data).mean()) for g, w in zip(got, want)]
        for g, w in zip(got, want):
            assert g.data.shape == w.data.shape == (36, 36, 36) and g.data.dtype == np.int16
            np.testing.assert_allclose(g.affine, w.affine, atol=1e-6)
            assert set(np.unique(g.data)) <= {0, 1}
        assert min(agree) >= (0.999 if acc == "fp32" else 0.99), (acc, agree)
    with open(tmp_path / "stats.json") as f:
        stats = json.load(f)
    assert stats["volumes"] == 2 and stats["e2e_volumes_per_sec"] > 0


def test_load_torch_checkpoint_rules(tmp_path):
    """The JAX loader's rules: unknown keys raise, missing keys keep the
    model's values, shapes must match; a checkpoint directory is refused."""
    src = _checkpoint(str(tmp_path / "full.pth"), seed=1)
    model = init_weights(UNETR(**TINY_MODEL), torch.Generator().manual_seed(2))
    load_torch_checkpoint(str(tmp_path / "full.pth"), model)
    for (name, a), b in zip(src.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), name

    partial = {k: v for k, v in src.state_dict().items() if not k.startswith("out.")}
    torch.save(partial, tmp_path / "partial.pth")
    model = init_weights(UNETR(**TINY_MODEL), torch.Generator().manual_seed(2))
    before = model.out.conv.conv.weight.clone()
    load_torch_checkpoint(str(tmp_path / "partial.pth"), model)
    assert torch.equal(model.out.conv.conv.weight, before)
    assert torch.equal(model.vit.norm.weight, src.vit.norm.weight)

    torch.save({**partial, "decoder9.conv.weight": torch.zeros(1)}, tmp_path / "extra.pth")
    with pytest.raises(KeyError, match="decoder9"):
        load_torch_checkpoint(str(tmp_path / "extra.pth"), model)
    torch.save({"out.conv.conv.bias": torch.zeros(5)}, tmp_path / "shape.pth")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_torch_checkpoint(str(tmp_path / "shape.pth"), model)
    os.makedirs(tmp_path / "orbax")
    with pytest.raises(NotImplementedError, match="outside the port's scope"):
        load_torch_checkpoint(str(tmp_path / "orbax"), model)
    with pytest.raises(NotImplementedError, match="outside the port's scope"):
        port_infer([make_dataset(tmp_path), "TinyCT", str(tmp_path / "orbax"),
                    str(tmp_path / "out"), "2", "--device", "cpu"] + TINY)
