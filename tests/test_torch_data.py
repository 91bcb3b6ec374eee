"""The port's data path against the JAX package's: NIfTI I/O, the host
validation chains and the device chains (run on the CPU here).

NIfTI files written by either package read back identically in the other.
The host chains are the same code: outputs equal to 1e-5 against the JAX
chain with the same resampler on both sides, each package's C++ library
(``medseg_torch/native``, ``medseg/native``: the same source and flags),
or, where the JAX package's library is not built, both chains' numpy
samplers (the library rounds nearest-neighbour ties otherwise than numpy on
oblique grids).
The device chains are held to the port's host chain (on its numpy samplers
for labels on the oblique grid, whose coordinates the device computes as
numpy does) and to the JAX device chains at 3e-4, the bound ``tests/test_resample_device.py`` uses for the
JAX device chain against its host chain (fp32 contractions against fp64
host coordinates), on an anisotropic and an oblique affine.
"""

import numpy as np
import pytest
import torch

from medseg.config import DataConfig as JaxDataConfig
from medseg.data import nifti as jnifti
from medseg.data import pipelines as jpipe
from medseg.data import transforms as jtransforms
from medseg.data.dataset import load_decathlon_datalist as jax_datalist
from medseg.ops.post import multichannel_to_label_map as jax_label_map
from medseg_torch.config import DataConfig, preset
from medseg_torch.data import nifti as tnifti
from medseg_torch.data import pipelines as tpipe
from medseg_torch.data import transforms as ttransforms
from medseg_torch.data.dataset import load_decathlon_datalist
from medseg_torch.ops import post as tpost


def _oblique(theta=0.3):
    aff = np.eye(4)
    aff[0, 0] = np.cos(theta) * 1.3
    aff[0, 1] = -np.sin(theta)
    aff[1, 0] = np.sin(theta)
    aff[1, 1] = np.cos(theta) * 0.9
    aff[2, 2] = 1.7
    aff[:3, 3] = [2.0, -1.0, 3.0]
    return aff


def _anisotropic():
    aff = np.diag([1.5, 0.8, 2.0, 1.0])
    aff[:3, 3] = [3.0, -1.0, 2.0]
    return aff


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_nifti_round_trips_across_packages(tmp_path, suffix, dtype):
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(7, 6, 5, 2)) * 100).astype(dtype)
    aff = _oblique()
    for write, read, name in ((tnifti.write_nifti, jnifti.read_nifti, "port_to_jax"),
                              (jnifti.write_nifti, tnifti.read_nifti, "jax_to_port")):
        path = str(tmp_path / f"{name}{suffix}")
        write(path, data, aff)
        img = read(path)
        assert img.data.dtype == data.dtype
        np.testing.assert_array_equal(img.data, data)
        np.testing.assert_allclose(img.affine, aff, atol=1e-6)  # sform in float32
    # and byte for byte the same file
    tnifti.write_nifti(str(tmp_path / "a.nii"), data, aff)
    jnifti.write_nifti(str(tmp_path / "b.nii"), data, aff)
    assert (tmp_path / "a.nii").read_bytes() == (tmp_path / "b.nii").read_bytes()


def test_datalist_and_presets_match_jax(tmp_path):
    (tmp_path / "dataset.json").write_text(
        '{"training": [{"image": "imagesTr/a.nii.gz", "label": "labelsTr/a.nii.gz"}],'
        ' "test": ["imagesTs/b.nii.gz"]}'
    )
    for key in ("training", "test"):
        path = str(tmp_path / "dataset.json")
        assert load_decathlon_datalist(path, True, key) == jax_datalist(path, True, key)
    from medseg.config import preset as jax_preset

    for name, k in (("Task01_BrainTumour", 4), ("Task09_Spleen", 2), ("abdomenCT", 14)):
        assert str(preset(name, k)) == str(jax_preset(name, k))


def _ct_volume(tmp_path, rng, affine):
    data = (rng.normal(size=(14, 12, 10)) * 150).astype(np.float32)
    data[4:9, 3:8, 2:7] += 400.0  # foreground blob for CropForeground
    data[:, :, :2] = -1000.0  # air outside the body: cropped away
    path = str(tmp_path / "ct.nii.gz")
    jnifti.write_nifti(path, data, affine)
    return path


def _mri_volume(tmp_path, rng, affine):
    data = rng.normal(size=(14, 12, 10, 4)).astype(np.float32)
    data[data < -0.5] = 0.0  # exercises the nonzero mask of the z-score
    lab = rng.integers(0, 4, size=(14, 12, 10)).astype(np.float32)
    img_path, lab_path = str(tmp_path / "mri.nii.gz"), str(tmp_path / "lab.nii.gz")
    jnifti.write_nifti(img_path, data, affine)
    jnifti.write_nifti(lab_path, lab, affine)
    return {"image": img_path, "label": lab_path}


@pytest.fixture
def same_resampler(monkeypatch):
    """Both chains on the C++ library, or where the JAX package's is not
    built, both on their numpy samplers."""
    from medseg import native as jnative

    if jnative.load() is None:
        monkeypatch.setattr(jtransforms, "_native_resample", lambda *a, **k: None)
        monkeypatch.setattr(ttransforms, "_native_resample", ttransforms.plain_resample)


def _close(a, b, tol):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert a.shape == np.shape(b)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("affine", [_anisotropic(), _oblique()], ids=["anisotropic", "oblique"])
def test_ct_chains_match_jax(tmp_path, affine, same_resampler):
    path = _ct_volume(tmp_path, np.random.default_rng(1), affine)
    host = tpipe.val_transforms(DataConfig())({"image": path})
    jhost = jpipe.val_transforms(JaxDataConfig())({"image": path})
    _close(host["image"], jhost["image"], 1e-5)
    np.testing.assert_allclose(host["image_affine"], jhost["image_affine"], atol=1e-9)
    np.testing.assert_array_equal(host["foreground_start"], jhost["foreground_start"])
    dev = tpipe.val_transforms_device(DataConfig(), "cpu")({"image": path})
    jdev = jpipe.val_transforms_device(JaxDataConfig())({"image": path})
    assert isinstance(dev["image"], torch.Tensor) and dev["image"].dtype == torch.float32
    _close(dev["image"], host["image"], 3e-4)
    _close(dev["image"], jdev["image"], 3e-4)
    np.testing.assert_allclose(dev["image_affine"], jdev["image_affine"], atol=1e-9)
    np.testing.assert_array_equal(dev["foreground_start"], jdev["foreground_start"])


@pytest.mark.parametrize("affine", [np.diag([1.3, 0.9, 1.1, 1.0]), _oblique()],
                         ids=["anisotropic", "oblique"])
def test_mri_chains_match_jax(tmp_path, affine, same_resampler):
    sample = _mri_volume(tmp_path, np.random.default_rng(2), affine)
    cfg, jcfg = preset("Task01_BrainTumour", 4).data, JaxDataConfig(task="mri", crop_foreground=False)
    assert cfg.task == "mri" and not cfg.crop_foreground
    host = tpipe.val_transforms(cfg)(dict(sample))
    jhost = jpipe.val_transforms(jcfg)(dict(sample))
    for key in ("image", "label"):
        _close(host[key], jhost[key], 1e-5)
    # the device chain computes its coordinates as numpy does, so its
    # nearest-neighbour ties on the oblique grid are held to the host chain
    # on the numpy samplers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttransforms, "_native_resample", ttransforms.plain_resample)
        host_plain = tpipe.val_transforms(cfg)(dict(sample))
    _close(host_plain["image"], host["image"], 1e-5)
    dev = tpipe.val_transforms_device(cfg, "cpu")(dict(sample))
    jdev = jpipe.val_transforms_device(jcfg)(dict(sample))
    for key in ("image", "label"):
        _close(dev[key], host_plain[key], 3e-4)
        _close(dev[key], jdev[key], 3e-4)
    # an image to segment has no label: the port's chain runs (the JAX one
    # raises KeyError in its label converter)
    out = tpipe.val_transforms_device(cfg, "cpu")({"image": sample["image"]})
    _close(out["image"], dev["image"], 0)


def test_multichannel_label_map_matches_jax():
    mask = np.random.default_rng(3).integers(0, 2, size=(5, 6, 7, 4)).astype(np.float32)
    got = tpost.multichannel_to_label_map(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_label_map(mask)))
