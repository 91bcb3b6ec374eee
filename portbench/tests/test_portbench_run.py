"""``run.py`` without a card, and the trace arithmetic on a made-up trace."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from portbench import manifest, readings, tracing
from portbench.tests.tiny import REPO

CELL = manifest.load(REPO, "btcv-serve-ct512")
BTCV = CELL.config["model"]


def test_run_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "btcv-serve-ct512", "--seed",
         "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_run_fails_outside_a_checkout_of_the_program(tmp_path):
    """A folder with only BENCHMARK.json and portbench/ has no program."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "btcv-train-4x96", "--seed", "3",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


def made_up_trace() -> tracing.Trace:
    k1 = "void medseg::(anonymous namespace)::conv_tc_kernel<1, false, 16, 0>(Args)"
    k2 = "void medseg::(anonymous namespace)::conv_tc_kernel<3, true, 16, 1>(Args)"
    ew = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
    kernels = [(k1, 10.0, 30.0), (ew, 30.0, 40.0), (k2, 60.0, 100.0), (ew, 150.0, 160.0)]
    copies = [("Memcpy HtoD (Pageable -> Device)", 0.0, 10.0)]
    host = [("aten::copy_", 40.0, 60.0),
            ("cudaLaunchKernel", 44.0, 48.0), ("aten::argmax", 100.0, 150.0)]
    return tracing.Trace(kernels=kernels, device_ops=kernels + copies, host_ops=host,
                         requests=[(0.0, 100.0), (100.0, 200.0)])


def test_trace_reductions():
    tr = made_up_trace()
    assert tr.window_s == 200e-6
    assert tr.busy_s == pytest.approx(90e-6)  # 0-40, 60-100, 150-160
    assert tr.kernel_count() == 4
    gaps = tr.idle_gaps()
    assert gaps[0] == ["aten::argmax", pytest.approx(50e-6)]
    assert gaps[1] == ["host (outside any traced op)", pytest.approx(40e-6)]  # 160-200
    assert gaps[2] == ["aten::copy_", pytest.approx(20e-6)]  # 40-60: innermost at 50
    top = tr.top_device_ops()
    assert top[0][1] == pytest.approx(40e-6) and "<3, true" in top[0][0]


def test_readers_on_a_made_up_trace():
    families = manifest.kernel_families(REPO / "portbench")
    ctx = readings.Context(kind="serve", task="ct", model=BTCV, trace=made_up_trace(), traced=2,
                           completed=3, window_s=2.0, items=300, families=families,
                           peak_bytes=2**30, architecture=CELL.architecture)
    folder = REPO / "portbench"
    read = {name: manifest.metric_reader(folder, name)(ctx)
            for name in ("host.launches.serve", "device.idle_share.serve",
                         "models.elementwise_ms.serve", "model.mfu.serve",
                         "host.launches.train", "device.peak_gib.train")}
    assert read["host.launches.serve"] == 2
    assert read["device.idle_share.serve"] == pytest.approx(55.0)
    assert read["models.elementwise_ms.serve"] == pytest.approx(10e-3)
    assert read["model.mfu.serve"] == pytest.approx(
        100 * 3 * 300 * 126.5738711e9 / 2.0 / 989e12, rel=1e-6)
    assert read["host.launches.train"] is None and read["device.peak_gib.train"] is None


KERNEL_NAMES = {  # names seen in the H100 traces -> the one family that carries them
    "void medseg::(anonymous namespace)::conv_tc_kernel<1, false, 16, 0>(X)": "K1_conv3x3x3_of",
    "void medseg::(anonymous namespace)::conv_tc_kernel<0, false, 16, 0>(X)": "K1_conv3x3x3_of",
    "void medseg::(anonymous namespace)::conv_narrow_kernel<16, true>(X)": "K1_conv3x3x3_of",
    "void medseg::(anonymous namespace)::conv_tc_kernel<3, true, 16, 1>(X)": "K2_conv3x3x3_of_combine",
    "void medseg::(anonymous namespace)::conv_tc_kernel<3, true, 16, 8>(X)": "K2_conv3x3x3_of_combine",
    "void medseg::(anonymous namespace)::conv_tc_async_kernel<2, 32>(X)": "K5_conv3x3x3_of_cat2",
    "void medseg::(anonymous namespace)::stats_finish_kernel(X)": "conv_statistics_finish",
    "void medseg::(anonymous namespace)::outhead_row_tc_kernel<16, 16, false>(X)": "K4_outhead_row_of",
    "void medseg::(anonymous namespace)::outhead_tc_kernel<16, 8>(X)": "K3_outhead_of",
    "void medseg::(anonymous namespace)::wgrad_tc_kernel<16, 16>(X)": "K6_conv3x3x3_wgrad_of",
    "void medseg::(anonymous namespace)::wgrad_tc_reduce_kernel(X)": "K6_conv3x3x3_wgrad_of",
    "void medseg::(anonymous namespace)::wgrad_narrow_kernel<16>(X)": "K6_conv3x3x3_wgrad_of",
    "void medseg::(anonymous namespace)::dice_ce_sums_kernel<14, true>(X)": "K7_dice_ce_sums",
    "void medseg::(anonymous namespace)::dice_ce_sums_finish_kernel(X)": "K7_dice_ce_sums",
    "void medseg::(anonymous namespace)::dice_ce_bwd_kernel<14, true>(X)": "K8_dice_ce_bwd",
    "void medseg::(anonymous namespace)::conv_tc_async_kernel<4, 32>(X)": None,  # K9
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>": None,
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": None,
}


@pytest.mark.parametrize("name,family", sorted(KERNEL_NAMES.items()))
def test_each_kernel_belongs_to_one_family_at_most(name, family):
    families = manifest.kernel_families(REPO / "portbench")
    hits = [f for f, spec in families.items() if readings.family_pattern(spec).search(name)]
    assert hits == ([family] if family else [])
