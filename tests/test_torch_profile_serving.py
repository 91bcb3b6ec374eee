"""The profilers' bookkeeping (``profile_serving``, shared by
``profile_train`` and ``profile_pretrain``): kernel classes by name (both
stagings of the tensor-core conv and both routes of K3 and K4 among them)
and busy time as the union of kernel intervals (the profiling itself needs
the card)."""

import pytest

from medseg_torch.tools import profile_serving as ps


@pytest.mark.parametrize("name,cls", [
    ("void medseg::(anonymous namespace)::conv3_kernel<float, 0, false, 16>(medseg::ConvArgs)",
     "K1 conv3x3x3_of"),
    ("void medseg::(anonymous namespace)::conv3_kernel<__nv_bfloat16, (medseg::Mode)1, false, 32>"
     "(medseg::ConvArgs)", "K1 conv3x3x3_of"),
    ("void medseg::(anonymous namespace)::conv3_kernel<__nv_bfloat16, 2, true, 32>(medseg::ConvArgs)",
     "K5 conv3x3x3_of_cat2"),
    ("void medseg::(anonymous namespace)::conv3_kernel<__nv_bfloat16, 3, true, 16>(medseg::ConvArgs)",
     "K2 conv3x3x3_of_combine"),
    ("void medseg::(anonymous namespace)::conv_tc_kernel<1, false, 16>"
     "(medseg::(anonymous namespace)::TcConvArgs)", "K1 conv3x3x3_of, tensor cores"),
    ("void medseg::(anonymous namespace)::conv_tc_kernel<0, true, 64>"
     "(medseg::(anonymous namespace)::TcConvArgs)", "K1 conv3x3x3_of, tensor cores"),
    ("void medseg::(anonymous namespace)::conv_tc_kernel<2, true, 32, 0>"
     "(medseg::(anonymous namespace)::TcConvArgs)", "K5 conv3x3x3_of_cat2, tensor cores"),
    ("void medseg::(anonymous namespace)::conv_tc_kernel<3, true, 16, 1>"
     "(medseg::(anonymous namespace)::TcConvArgs)", "K2 conv3x3x3_of_combine, tensor cores"),
    ("void medseg::(anonymous namespace)::conv_tc_kernel<(medseg::Mode)3, true, 32, 8>"
     "(medseg::(anonymous namespace)::TcConvArgs)", "K2 conv3x3x3_of_combine, tensor cores"),
    ("void medseg::(anonymous namespace)::conv_tc_kernel<4, false, 64, 0>"
     "(medseg::(anonymous namespace)::TcConvArgs)", "K9 conv3x3x3_flat, tensor cores"),
    ("void medseg::(anonymous namespace)::conv_tc_async_kernel<2, 32>(CUtensorMap, CUtensorMap, "
     "medseg::(anonymous namespace)::TcConvArgs)", "K5 conv3x3x3_of_cat2, tensor cores, async"),
    ("void medseg::(anonymous namespace)::conv_tc_async_kernel<(medseg::(anonymous namespace)::"
     "Mode)4, 64>(CUtensorMap, CUtensorMap, medseg::(anonymous namespace)::TcConvArgs)",
     "K9 conv3x3x3_flat, tensor cores, async"),
    ("void medseg::(anonymous namespace)::wgrad_tc_kernel<32>"
     "(medseg::(anonymous namespace)::WgradTcArgs)", "K6 conv3x3x3_wgrad_of, tensor cores"),
    ("medseg::(anonymous namespace)::wgrad_tc_reduce_kernel(float const*, float*, int, int)",
     "K6 conv3x3x3_wgrad_of, tensor cores"),
    ("void medseg::outhead_kernel<__nv_bfloat16>(...)", "K3 outhead_of"),
    ("void medseg::(anonymous namespace)::outhead_tc_kernel<1, 2>"
     "(medseg::(anonymous namespace)::HeadTcArgs)", "K3 outhead_of, tensor cores"),
    ("void medseg::(anonymous namespace)::outhead_row_tc_kernel<1, 2, __nv_bfloat16>"
     "(medseg::(anonymous namespace)::RowTcArgs)", "K4 outhead_row_of, tensor cores"),
    ("void medseg::(anonymous namespace)::outhead_row_tc_kernel<2, 1, float>"
     "(medseg::(anonymous namespace)::RowTcArgs)", "K4 outhead_row_of, tensor cores"),
    ("void medseg::(anonymous namespace)::outhead_row_kernel<__nv_bfloat16, float, 16, 16>"
     "(medseg::(anonymous namespace)::RowArgs)", "K4 outhead_row_of"),
    ("void medseg::(anonymous namespace)::wgrad_kernel<__nv_bfloat16, 16>"
     "(medseg::(anonymous namespace)::WgradArgs)", "K6 conv3x3x3_wgrad_of"),
    ("medseg::(anonymous namespace)::wgrad_reduce_kernel(float const*, float*, int, int)",
     "K6 conv3x3x3_wgrad_of"),
    ("void medseg::(anonymous namespace)::dice_ce_sums_kernel<__nv_bfloat16>(...)",
     "K7 dice_ce_sums"),
    ("void medseg::(anonymous namespace)::dice_ce_bwd_kernel<float>(...)", "K8 dice_ce_bwd"),
    ("void medseg::(anonymous namespace)::dice_ce_sums_kernel<__nv_bfloat16, 14>"
     "(__nv_bfloat16 const*, int const*, float*, int, long long, int)", "K7 dice_ce_sums"),
    ("medseg::(anonymous namespace)::dice_ce_sums_finish_kernel(float const*, float*, int, int, "
     "int)", "K7 dice_ce_sums"),
    ("void medseg::(anonymous namespace)::dice_ce_bwd_kernel<float, 0>(...)", "K8 dice_ce_bwd"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduction"),
    ("pytorch_flash::flash_fwd_kernel<...>", "SDPA attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "cuBLAS/cuDNN"),
    ("nvjet_tst_64x80_64x11_2x1_v_bz_bias_TNT", "cuBLAS/cuDNN"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false>",
     "layer norm"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_class(name, cls):
    assert ps.kernel_class(name) == cls


def test_busy_time_is_the_union_of_intervals():
    assert ps._busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert ps._busy_us([(3, 4)]) == 1
