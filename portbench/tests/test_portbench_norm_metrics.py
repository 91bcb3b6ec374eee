"""The instance-norm readers (``models.instance_norm_ms.*``,
``models.norm_kernel_share.train``) on made-up traces: the norm kernels'
device ms by name, outside every kernel class of ``tracing.py``; one forward
kernel per ``medseg.norm`` span; None where the trace holds no such kernel or
span, as a program without the hand norm gives."""

from __future__ import annotations

import pytest

from portbench import manifest, readings, tracing
from portbench.tests.tiny import REPO

# names as the profiler prints them, templates and argument types included
FWD = ("void medseg::(anonymous namespace)::instnorm_fwd_plane_kernel<__nv_bfloat16, true, "
       "true>(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float const*, "
       "__nv_bfloat16*, float*, float*, int, int, float, int)")
STATS = ("void medseg::(anonymous namespace)::instnorm_stats_kernel<__nv_bfloat16>("
         "__nv_bfloat16 const*, float2*, long long, int, int)")
APPLY = ("void medseg::(anonymous namespace)::instnorm_fwd_apply_kernel<float, true, false>("
         "float const*, float const*, float2 const*, float const*, float const*, float*, float*, "
         "float*, int, long long, int, float, int)")
BWD = ("void medseg::(anonymous namespace)::instnorm_bwd_dx_kernel<__nv_bfloat16, true, true>("
       "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
       "float const*, float const*, float const*, float2 const*, __nv_bfloat16*, "
       "__nv_bfloat16*, float*, float*, int, int, long long, int, int)")
SUMS = "void medseg::(anonymous namespace)::instnorm_bwd_sums_kernel<float, false, false>()"
GLUE = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>()"


def read(name: str, ctx):
    return manifest.metric_reader(REPO / "portbench", name)(ctx)


def context(kind: str, trace: tracing.Trace) -> readings.Context:
    return readings.Context(kind=kind, task="ct", model={}, trace=trace, traced=2, completed=2,
                            window_s=1.0, items=1, families=manifest.kernel_families(
                                REPO / "portbench"), peak_bytes=0)


def norm_trace(norm_spans: int = 4) -> tracing.Trace:
    """Two requests over 0-200 us: three forward applications (one-pass,
    then statistics and apply), one backward, elementwise glue, and
    ``norm_spans`` ``medseg.norm`` spans."""
    kernels = [(FWD, 10.0, 14.0), (STATS, 20.0, 22.0), (APPLY, 22.0, 25.0), (FWD, 110.0, 112.0),
               (BWD, 130.0, 140.0), (SUMS, 150.0, 151.0), (GLUE, 60.0, 70.0)]
    host = [("medseg.norm", 8.0 + 30 * i, 16.0 + 30 * i) for i in range(norm_spans)]
    return tracing.Trace(kernels=kernels, device_ops=kernels, host_ops=host,
                         requests=[(0.0, 100.0), (100.0, 200.0)])


@pytest.mark.parametrize("name", [FWD, STATS, APPLY, BWD, SUMS])
def test_the_norm_kernels_fall_in_no_kernel_class_or_family(name):
    assert tracing.kernel_class(name) == "other"
    families = manifest.kernel_families(REPO / "portbench")
    assert not any(readings.family_pattern(f).search(name) for f in families.values())


def test_instance_norm_ms_reads_the_norm_kernels_per_request():
    tr = norm_trace()
    # 4 + 2 + 3 + 2 + 10 + 1 = 22 us over 2 requests
    assert read("models.instance_norm_ms.train", context("train", tr)) == pytest.approx(0.011)
    assert read("models.instance_norm_ms.serve", context("serve", tr)) == pytest.approx(0.011)
    assert read("models.instance_norm_ms.serve", context("train", tr)) is None
    assert read("models.elementwise_ms.train", context("train", tr)) == pytest.approx(0.005)


def test_norm_kernel_share_is_forward_kernels_over_norm_spans():
    assert read("models.norm_kernel_share.train", context("train", norm_trace(3))) == 100.0
    assert read("models.norm_kernel_share.train", context("train", norm_trace(4))) == 75.0
    assert read("models.norm_kernel_share.train", context("serve", norm_trace(3))) is None


def test_a_program_without_the_hand_norm_reads_none():
    tr = tracing.Trace(kernels=[(GLUE, 10.0, 20.0)], device_ops=[(GLUE, 10.0, 20.0)],
                       host_ops=[], requests=[(0.0, 100.0)])
    for name, kind in (("models.instance_norm_ms.train", "train"),
                       ("models.instance_norm_ms.serve", "serve"),
                       ("models.norm_kernel_share.train", "train")):
        assert read(name, context(kind, tr)) is None
