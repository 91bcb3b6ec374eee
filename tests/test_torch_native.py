"""The port's native host library (``medseg_torch.native``) against its plain
numpy versions, against the JAX package's library ``medseg.native``, and in
the port's data chain.

- Each of the six entry points against its plain version, at the limits of
  ``tests/test_native.py``: gunzip byte-exact, trilinear 1e-5, nearest
  values drawn from the source and equal to ``_nearest_sample`` where the
  coordinates fall on .5 (ties to even on both sides), scale 1e-5/1e-6,
  z-score 1e-4/1e-5, the foreground box exact.
- Against ``medseg.native`` on the same inputs: the resamplers, the scale and
  the box bitwise (the same source, flags and compiler on one machine);
  skipped where the JAX package's library is not built.
- End to end: the port's ``respace`` and ``read_nifti`` against the JAX
  package's on a seeded volume with a non-diagonal affine and a ``.nii.gz``
  file (image 1e-5, label exact), both going through their libraries; a
  counting wrapper shows ``respace`` and ``_read_bytes`` call the library.
- The build: six processes that start it at once into an empty directory
  all load a whole library and leave no temporary file; a source that does
  not compile, or includes a header the compiler lacks (as a missing
  ``zlib.h`` would), raises with g++'s stderr; a driver that cannot read
  ``libgomp.spec`` at link time gets the library linked with the OpenMP
  runtime by its soname, equal to the usual one.

The module runs the library's OpenMP loops on two threads (small volumes; a
parallel test run shares the cores).
"""

import ctypes
import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from medseg_torch import native
from medseg_torch.data import nifti as tnifti
from medseg_torch.data import transforms as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMP_THREADS = 2
ENTRY_POINTS = ("msn_inflate_gzip", "msn_trilinear_resample", "msn_nearest_resample",
                "msn_scale_intensity", "msn_znorm_nonzero", "msn_foreground_bbox")


@pytest.fixture(autouse=True, scope="module")
def few_omp_threads():
    native.load()
    gomp = ctypes.CDLL("libgomp.so.1")
    threads = gomp.omp_get_max_threads()
    gomp.omp_set_num_threads(OMP_THREADS)
    yield
    gomp.omp_set_num_threads(threads)


@pytest.fixture(scope="module")
def jnative():
    from medseg import native as jax_native

    if jax_native.load() is None:
        pytest.skip("the JAX package's native library is not built (no g++ or zlib)")
    return jax_native


def _grid_coords(matrix, out_shape):
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in out_shape], indexing="ij"), axis=-1)
    return grid.astype(np.float64) @ matrix[:, :3].T + matrix[:, 3]


def _rotation_matrix(theta=0.35, offset=(0.4, -0.6, 0.2), zooms=(0.8, 1.3, 0.6)):
    """A 3x4 dst voxel -> src voxel map with a rotation in x-y."""
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return np.concatenate([rot @ np.diag(zooms), np.array(offset)[:, None]], axis=1)


MATRICES = {
    "scale": np.array([[0.8, 0.0, 0.0, 0.3], [0.0, 1.3, 0.0, -0.2], [0.0, 0.0, 0.6, 0.1]]),
    "rotation": _rotation_matrix(),
}


def test_library_carries_every_entry_point():
    lib = native.load()
    assert all(hasattr(lib, name) for name in ENTRY_POINTS)
    assert native.library_path().parent == native.BUILD_DIR


@pytest.mark.parametrize("size", [1, 100_000, 3_000_000])
def test_inflate_gzip_round_trip(size):
    raw = np.random.default_rng(size).integers(0, 255, size=size, dtype=np.uint8).tobytes()
    blob = gzip.compress(raw, compresslevel=1)
    assert native.inflate_gzip(blob, len(raw)) == raw == gzip.decompress(blob)


def test_inflate_gzip_too_small_a_buffer_is_none():
    raw = bytes(range(256)) * 64
    assert native.inflate_gzip(gzip.compress(raw), len(raw) - 1) is None


@pytest.mark.parametrize("matrix", MATRICES.values(), ids=MATRICES.keys())
def test_trilinear_matches_plain(matrix):
    src = np.random.default_rng(1).normal(size=(9, 11, 7, 2)).astype(np.float32)
    out_shape = (10, 8, 12)
    got = native.trilinear_resample(src, matrix, out_shape)
    want = T._trilinear_sample(src, _grid_coords(matrix, out_shape))
    assert got.shape == out_shape + (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src_shape,out_shape", [((9, 11, 7), (4, 4, 4)),
                                                 ((9, 11, 7, 1), (4, 4))])
def test_resamplers_reject_shapes_they_would_misread(src_shape, out_shape):
    src = np.zeros(src_shape, np.float32)
    for fn in (native.trilinear_resample, native.nearest_resample):
        with pytest.raises(ValueError, match="resample"):
            fn(src, MATRICES["scale"], out_shape)


@pytest.mark.parametrize("matrix", MATRICES.values(), ids=MATRICES.keys())
def test_nearest_draws_source_values(matrix):
    src = np.random.default_rng(2).integers(0, 5, size=(9, 11, 7, 1)).astype(np.float32)
    got = native.nearest_resample(src, matrix, (11, 8, 10))
    assert set(np.unique(got)) <= set(np.unique(src))


def test_nearest_ties_round_to_even_as_numpy():
    """Coordinates k/2 (+ 1/4 on y): every x and z coordinate of an odd k is
    a tie, which both sides send to the even voxel; the products are exact
    in binary, so both sides see the same ties."""
    src = np.random.default_rng(3).normal(size=(8, 9, 10, 3)).astype(np.float32)
    matrix = np.array([[0.5, 0.0, 0.0, 0.5], [0.0, 0.5, 0.0, 0.25], [0.0, 0.0, 0.5, 0.0]])
    out_shape = (14, 17, 19)
    coords = _grid_coords(matrix, out_shape)
    assert (coords[..., 0] % 1 == 0.5).mean() == 0.5
    got = native.nearest_resample(src, matrix, out_shape)
    np.testing.assert_array_equal(got, T._nearest_sample(src, coords))
    np.testing.assert_array_equal(got, T.plain_resample(src, matrix, out_shape, "nearest"))


def test_scale_intensity_matches_plain():
    data = np.random.default_rng(4).normal(0, 300, size=(10, 12, 9)).astype(np.float32)
    want = T.scale_intensity_range({"image": data})["image"]  # -175..250 -> 0..1, clipped
    buf = data.copy()
    assert native.scale_intensity(buf, -175.0, 250.0, 0.0, 1.0, True)
    np.testing.assert_allclose(buf, want, rtol=1e-5, atol=1e-6)
    strided = data[:, ::2]
    assert not native.scale_intensity(strided, -175.0, 250.0, 0.0, 1.0)  # not C-contiguous
    assert not native.scale_intensity(data.astype(np.float64), -175.0, 250.0, 0.0, 1.0)


def test_znorm_matches_plain():
    data = np.zeros((10, 10, 10), np.float32)
    data[1:8, 2:9, 3:7] = np.random.default_rng(5).normal(5, 2, size=(7, 7, 4))
    want = T._znorm(data.copy(), nonzero=True)
    buf = data.copy()
    assert native.znorm_nonzero(buf)
    np.testing.assert_allclose(buf, want, rtol=1e-4, atol=1e-5)
    empty = np.zeros(5, np.float32)
    assert native.znorm_nonzero(empty) and not empty.any()


def _plain_bbox(data, threshold=0.0):
    fg = data > threshold
    if fg.ndim == 4:
        fg = fg.any(axis=-1)
    if not fg.any():
        return None
    idx = np.nonzero(fg)
    return np.array([v for i in idx for v in (i.min(), i.max() + 1)], dtype=np.int64)


@pytest.mark.parametrize("channels", [0, 4])
def test_foreground_bbox_matches_plain(channels):
    rng = np.random.default_rng(6)
    shape = (20, 22, 24) + ((channels,) if channels else ())
    data = np.zeros(shape, np.float32)
    data[3:9, 5:10, 7:15] = rng.uniform(0.1, 1.0, size=(6, 5, 8) + shape[3:])
    data[12, 20, 2] = 0.5  # one far voxel widens the box
    got = native.foreground_bbox(data)
    np.testing.assert_array_equal(got, _plain_bbox(data))
    np.testing.assert_array_equal(got, [3, 13, 5, 21, 2, 15])
    assert native.foreground_bbox(data, threshold=2.0) is None
    assert native.foreground_bbox(np.zeros((4, 4, 4), np.float32)) is None


@pytest.mark.parametrize("matrix", MATRICES.values(), ids=MATRICES.keys())
def test_resamplers_bitwise_equal_to_jax_library(jnative, matrix):
    rng = np.random.default_rng(7)
    src = rng.normal(size=(13, 11, 9, 2)).astype(np.float32)
    out_shape = (15, 12, 14)
    np.testing.assert_array_equal(native.trilinear_resample(src, matrix, out_shape),
                                  jnative.trilinear_resample(src, matrix, out_shape))
    np.testing.assert_array_equal(native.nearest_resample(src, matrix, out_shape),
                                  jnative.nearest_resample(src, matrix, out_shape))


def test_scale_znorm_bbox_and_gunzip_equal_to_jax_library(jnative):
    rng = np.random.default_rng(8)
    data = rng.normal(0, 300, size=(12, 10, 8)).astype(np.float32)
    ours, theirs = data.copy(), data.copy()
    native.scale_intensity(ours, -175.0, 250.0, 0.0, 1.0, True)
    jnative.scale_intensity(theirs, -175.0, 250.0, 0.0, 1.0, True)
    np.testing.assert_array_equal(ours, theirs)
    ours, theirs = data.copy(), data.copy()
    ours[ours < 0] = theirs[theirs < 0] = 0.0
    native.znorm_nonzero(ours)
    jnative.znorm_nonzero(theirs)  # an OpenMP reduction: its order follows the team
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(native.foreground_bbox(data, 400.0),
                                  jnative.foreground_bbox(data, 400.0))
    raw = data.tobytes()
    assert native.inflate_gzip(gzip.compress(raw), len(raw)) == jnative.inflate_gzip(
        gzip.compress(raw), len(raw))


def _oblique_affine():
    aff = np.eye(4)
    aff[:3, :3] = _rotation_matrix(0.3, zooms=(1.3, 0.9, 1.7))[:, :3]
    aff[:3, 3] = [2.0, -1.0, 3.0]
    return aff


def test_respace_matches_jax(jnative):
    from medseg.data import transforms as jtransforms

    rng = np.random.default_rng(9)
    image = rng.normal(size=(17, 13, 11)).astype(np.float32)
    label = rng.integers(0, 4, size=(17, 13, 11)).astype(np.float32)
    sample = {"image": image, "image_affine": _oblique_affine(),
              "label": label, "label_affine": _oblique_affine()}
    got = T.respace(dict(sample), pixdim=(1.5, 1.5, 2.0))
    want = jtransforms.respace(dict(sample), pixdim=(1.5, 1.5, 2.0))
    assert got["image"].shape == want["image"].shape != image.shape
    np.testing.assert_allclose(got["image"], want["image"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["image_affine"], want["image_affine"], atol=1e-12)


def test_respace_image_matches_the_plain_resampler():
    rng = np.random.default_rng(10)
    sample = {"image": rng.normal(size=(12, 10, 9, 2)).astype(np.float32),
              "image_affine": _oblique_affine()}
    got = T.respace(dict(sample), keys=("image",), modes=("trilinear",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "_native_resample", T.plain_resample)
        want = T.respace(dict(sample), keys=("image",), modes=("trilinear",))
    np.testing.assert_allclose(got["image"], want["image"], rtol=1e-5, atol=1e-5)


def test_read_nifti_gz_matches_jax(tmp_path):
    from medseg.data import nifti as jnifti

    rng = np.random.default_rng(11)
    data = (rng.normal(size=(21, 17, 13)) * 300).astype(np.int16)
    path = str(tmp_path / "ct.nii.gz")
    tnifti.write_nifti(path, data, _oblique_affine())
    got = tnifti.read_nifti(path, dtype=np.float32)
    want = jnifti.read_nifti(path, dtype=np.float32)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.data, data.astype(np.float32))
    np.testing.assert_allclose(got.affine, want.affine, atol=1e-12)


def test_the_chain_goes_through_the_library(tmp_path, monkeypatch):
    calls = {"trilinear_resample": 0, "nearest_resample": 0, "inflate_gzip": 0}

    def counted(name):
        fn = getattr(native, name)

        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name in calls:
        monkeypatch.setattr(native, name, counted(name))
    rng = np.random.default_rng(12)
    image = rng.normal(size=(10, 9, 8)).astype(np.float32)
    path = str(tmp_path / "image.nii.gz")
    tnifti.write_nifti(path, image, np.diag([1.5, 1.5, 2.0, 1.0]))
    sample = T.load({"image": path, "label": path})
    assert calls["inflate_gzip"] == 2
    np.testing.assert_array_equal(sample["image"], image)
    out = T.respace(sample, pixdim=(1.0, 1.0, 1.0))
    assert calls["trilinear_resample"] == 1 and calls["nearest_resample"] == 1
    assert out["image"].shape == (14, 13, 15)
    assert tnifti._read_bytes(path)[:4] == struct.pack("<i", tnifti.HEADER_SIZE)
    assert calls["inflate_gzip"] == 3


_BUILD_PROBE = """
import sys
from pathlib import Path
from medseg_torch import native
native.BUILD_DIR = Path(sys.argv[1])
lib = native.load()
print(native.library_path().name, int(native.build_seconds is not None),
      sum(hasattr(lib, name) for name in sys.argv[2:]))
"""


def test_six_processes_build_at_once(tmp_path):
    build_dir = tmp_path / "build"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    probe = [sys.executable, "-c", _BUILD_PROBE, str(build_dir), *ENTRY_POINTS]
    procs = [subprocess.Popen(probe, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(6)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        outs.append(out.split())
    assert len({name for name, _, _ in outs}) == 1
    assert all(n == "6" for _, _, n in outs)
    assert sorted(os.listdir(build_dir)) == [outs[0][0]]  # no temporary file left
    # a later process finds the library and builds nothing
    out = subprocess.run(probe, cwd=REPO, capture_output=True, text=True, env=env, timeout=120)
    assert out.stdout.split()[1] == "0"


@pytest.mark.parametrize("source,message", [
    ('extern "C" int msn_broken() { return undeclared_name; }\n', "undeclared_name"),
    # as the build on a machine without zlib.h
    ("#include <medseg_absent_header.h>\n", "medseg_absent_header.h"),
], ids=["undeclared", "missing-header"])
def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch, source, message):
    broken = tmp_path / "broken.cc"
    broken.write_text(source)
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=message) as info:
        native.library_path()
    assert "g++ failed" in str(info.value)
    assert not list((tmp_path / "build").iterdir())


_NO_GOMP_SPEC_DRIVER = """#!/bin/sh
# g++ as a wrapped driver that finds no libgomp.spec when it links with
# -fopenmp, and no libgomp.so for -lgomp
case " $* " in
  *" -lgomp "*) echo "ld: cannot find -lgomp: No such file or directory" >&2
    exit 1;;
  *" -fopenmp "*) case " $* " in *" -c "*|*" -E "*) ;; *)
    echo "g++-real: fatal error: cannot read spec file 'libgomp.spec': No such file" >&2
    exit 1;; esac;;
esac
exec g++ "$@"
"""


def test_driver_without_libgomp_spec_links_the_gomp_runtime(tmp_path, monkeypatch):
    driver = tmp_path / "g++"
    driver.write_text(_NO_GOMP_SPEC_DRIVER)
    driver.chmod(0o755)
    monkeypatch.setattr(native, "_cxx", lambda: str(driver))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "build_seconds", native.build_seconds)  # restored after
    path = native.library_path()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [path.name]
    lib = native._typed(ctypes.CDLL(str(path)))
    src = np.random.default_rng(14).normal(size=(7, 6, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        native._resample(lib.msn_trilinear_resample, src, MATRICES["rotation"], (8, 7, 6)),
        native.trilinear_resample(src, MATRICES["rotation"], (8, 7, 6)))
