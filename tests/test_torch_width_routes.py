"""The routes that send work to the CUDA kernels accept exactly the widths
the kernels are built for (``conv_of``'s width table), so that a model of
another width takes the library path on the card instead of raising, as the
JAX package routes such widths to XLA or flax.

- ``conv3d.train_route`` on a CUDA device, for every 3x3x3 conv of a UNETR
  at feature sizes 8-64 and 1 or 4 input channels (at a 96^3 crop), against
  the kernels' instantiated widths written out here: K1 forward (C_in ->
  C_out), K1's data gradient (C_out -> C_in, where the input needs it) and
  K6 all need their output width in {16, 32, 64} (64: one tensor-core launch
  or two CUDA-core launches). On the CPU the wrappers run their plain
  versions at every width, and the route keeps the JAX terms alone.
- ``unetr_of.fast_path_supported`` (the Validator's predicate) over the same
  table: on a CUDA device only feature sizes 16 and 32 have every kernel of
  the chain (K5 at 64 needs 128 output channels; K4 holds 32 channels);
  also the cubic roi >= 48, the classes K4 holds and the compute dtype.
- The ``Validator`` with the card's answer: the module forward at feature
  sizes 8, 24, 48 and 64, the fused forward at 16 and 32; one volume served
  at feature size 8 takes the module forward and matches the plain walk.
- ``flat_route`` selects the convs it selected before this table existed.
- The tensor-core table widened for K5 and K9 (CAT2 and FLAT up to C = 128):
  feature size 32's dec3.conv1 takes the tensor cores in bf16 on both
  routes, fp32 stays on the CUDA cores, K1, K2 and K6 still stop at 64, and
  every width that had a kernel before the widening still has one.
- The narrow-input route of K1 and K6 (``narrow_tc_route``,
  ``wgrad_narrow_tc_route``: C_in <= 8) inside the width table, which it
  leaves as it was: of a UNETR's convs only encoder1.conv1 at feature sizes
  16 and 32 takes it, in bf16 without a prologue, where the table already
  had a kernel and ``train_route`` already routed the conv.
- K3 and K4's tensor-core route (``outhead_tc_route``) inside their width
  table, which it leaves as it was (K3: C <= 64, any K_pad; K4: C <= 32,
  K_pad <= 32): the chain's out head at feature sizes 16 and 32 and 4 or 14
  classes takes it in bf16 only.
"""

import pytest
import torch

from medseg_torch.engine import evaluate as tevaluate
from medseg_torch.kernels import conv3d, conv_flat, conv_of
from medseg_torch.kernels import unetr_of as tuo
from medseg_torch.models.unetr import UNETR
from medseg_torch.ops.sliding_window import SlidingWindowSpec, sliding_window_inference

FEATURE_SIZES = [8, 16, 24, 32, 48, 64]
KERNEL_C_OUT = {16, 32, 64}  # the conv and wgrad kernels' output widths, each route
BF = torch.bfloat16


def unetr_convs(fs: int, c_in: int, crop: int = 96):
    """(name, input shape, C_out, input needs a gradient) of each 3x3x3 conv
    of a UNETR's full-resolution and 1/2-resolution stages (the ones at
    H*W >= 48^2 for a 96^3 crop), batch 2."""
    full, half = (2, None, crop, crop, crop), (2, None, crop // 2, crop // 2, crop // 2)

    def shape(base, c):
        return (base[0], c, *base[2:])

    return [
        ("encoder1.conv1", shape(full, c_in), fs, False),  # the image needs no gradient
        ("encoder1.conv2", shape(full, fs), fs, True),
        ("decoder2.conv1", shape(full, 2 * fs), fs, True),
        ("decoder2.conv2", shape(full, fs), fs, True),
        ("decoder3.conv1", shape(half, 4 * fs), 2 * fs, True),
        ("decoder3.conv2", shape(half, 2 * fs), 2 * fs, True),
    ]


def _model(fs, c_in=1, out_channels=14, dtype=BF, roi=96, **kw):
    return UNETR(in_channels=c_in, out_channels=out_channels, img_size=(roi,) * 3,
                 feature_size=fs, hidden_size=24, mlp_dim=48, num_heads=4, num_layers=4,
                 dtype=dtype, **kw)


@pytest.mark.parametrize("c_in", [1, 4])
@pytest.mark.parametrize("fs", FEATURE_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
def test_train_route_takes_only_the_kernels_widths(fs, c_in, dtype):
    for name, shape, c_out, input_grad in unetr_convs(fs, c_in):
        c = shape[1]
        jax_terms = c <= 64 and c_out <= 64  # H*W >= 48^2 at both stages
        widths = c_out in KERNEL_C_OUT and (not input_grad or c in KERNEL_C_OUT)
        on_card = conv3d.train_route(shape, c_out, dtype, input_grad=input_grad, device="cuda")
        assert on_card == (jax_terms and widths), (name, shape, c_out)
        # the CPU's plain versions take every width: the JAX terms alone
        assert conv3d.train_route(shape, c_out, dtype, input_grad=input_grad) == jax_terms


def test_train_route_on_the_card_reads_dtype_and_input_gradient():
    assert conv3d.train_route((2, 1, 96, 96, 96), 16, BF, input_grad=False, device="cuda")
    # the data gradient would be a 16 -> 1 conv: no kernel
    assert not conv3d.train_route((2, 1, 96, 96, 96), 16, BF, input_grad=True, device="cuda")
    assert not conv3d.train_route((2, 16, 96, 96, 96), 16, torch.float16, device="cuda")
    assert conv3d.train_route((2, 16, 96, 96, 96), 16, torch.float16)  # CPU: plain versions


@pytest.mark.parametrize("c_in", [1, 4])
@pytest.mark.parametrize("fs", FEATURE_SIZES)
def test_serving_predicate_takes_only_the_kernels_widths(fs, c_in):
    model = _model(fs, c_in)
    window = (2, c_in, 96, 96, 96)
    assert tuo.fast_path_supported(model, window, "cuda") == (fs in (16, 32))
    assert tuo.chain_has_kernels(model, c_in) == (fs in (16, 32))
    assert tuo.fast_path_supported(model, window, "cpu")  # plain versions: every width


@pytest.mark.parametrize("window,kw,on_card", [
    ((2, 1, 96, 96, 96), {}, True),
    ((2, 1, 48, 48, 48), {}, True),
    ((2, 1, 32, 32, 32), {}, False),  # below the 48^3 the JAX predicate asks
    ((2, 1, 96, 96, 64), {}, False),  # not a cube
    ((2, 1, 96, 96, 96), {"out_channels": 40}, False),  # 40 classes: K4 holds 32
    ((2, 1, 96, 96, 96), {"dtype": torch.float16}, False),
    ((2, 1, 96, 96, 96), {"dtype": None}, True),  # fp32
    ((2, 16, 96, 96, 96), {"c_in": 16}, False),  # C_in == feature size: no conv3
    ((2, 1, 96, 96, 96), {"res_block": False}, False),
])
def test_serving_predicate_terms(window, kw, on_card):
    model = _model(16, **kw)
    assert tuo.fast_path_supported(model, window, "cuda") == on_card
    chain_correct = kw.get("c_in") != 16 and kw.get("res_block", True)
    assert tuo.fast_path_supported(model, window, "cpu") == chain_correct


@pytest.mark.parametrize("fs", FEATURE_SIZES)
def test_validator_routes_by_the_card_predicate(monkeypatch, fs):
    """Given the card's answer, the Validator takes the module forward at
    feature sizes 8, 24, 48 and 64 and the fused forward at 16 and 32."""
    monkeypatch.setattr(tevaluate, "fast_path_supported",
                        lambda model, shape, device: tuo.fast_path_supported(model, shape, "cuda"))
    spec = SlidingWindowSpec(roi=(96, 96, 96), overlap=0.5, sw_batch=2, mode="gaussian")
    validator = tevaluate.Validator(_model(fs), 14, "ct", spec, device="cpu")
    assert validator.use_fast_path == (fs in (16, 32))


def test_validator_serves_a_width_without_kernels_through_the_module(monkeypatch):
    monkeypatch.setattr(tevaluate, "fast_path_supported",
                        lambda model, shape, device: tuo.fast_path_supported(model, shape, "cuda"))
    calls = []
    fused = tuo.fast_apply_v3  # the Validator's fused forward calls it (GraphedForward)
    monkeypatch.setattr(tuo, "fast_apply_v3", lambda *a, **k: calls.append(1) or fused(*a, **k))
    g = torch.Generator().manual_seed(0)
    model = _model(8, out_channels=3, dtype=None, roi=48).eval()
    for p in model.parameters():
        p.data.normal_(0.0, 0.1, generator=g)
    spec = SlidingWindowSpec(roi=(48, 48, 48), overlap=0.25, sw_batch=2, mode="constant")
    volume = torch.randn((48, 48, 60, 1), generator=g).numpy()
    validator = tevaluate.Validator(model, 3, "ct", spec, device="cpu")
    assert not validator.use_fast_path
    got = validator.infer_volume(volume)
    with torch.no_grad():
        want = sliding_window_inference(
            volume, lambda w: model(w, return_encoder_features=False), 3, spec, device="cpu")
    assert not calls
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("c,c_out", [(128, 64), (64, 32), (32, 16), (128, 128), (64, 64),
                                     (16, 8), (48, 24), (24, 8), (136, 64)])
@pytest.mark.parametrize("hw", [24, 48, 96])
def test_flat_route_selects_what_it_selected(monkeypatch, c, c_out, hw):
    """With the flat route on, ``flat_route`` selects what ``flat_supported
    and not`` the JAX terms of ``train_route`` select (its rule before the
    width table); on the card also only where K9 has the widths (C_out a
    multiple of 16), instead of raising."""
    monkeypatch.setattr(conv3d, "PALLAS_PER_CONV", True)
    shape = (2, c, hw, hw, hw)
    before = conv3d.flat_supported(shape, c_out) and not (
        hw * hw >= conv3d.OF_MIN_HW and c <= conv3d.MAX_C and c_out <= conv3d.MAX_C)
    assert conv3d.flat_route(shape, c_out) == before
    assert conv3d.flat_route(shape, c_out, device="cuda") == (
        before and conv_flat.has_kernel(c, c_out))


def test_feature_size_32_dec3_takes_the_tensor_cores():
    """dec3.conv1 at feature size 32: serving's K5 over (64+64) -> 64 and
    the flat route's K9 128 -> 64 on the tensor cores in bf16, on the CUDA
    cores in fp32."""
    assert conv_of.tc_route(128, 64, BF, "cat2")
    assert conv_of.tc_route(128, 64, BF, "flat")
    assert not conv_of.tc_route(128, 64, torch.float32, "cat2")
    assert not conv_of.tc_route(128, 64, torch.float32, "flat")
    model = _model(32)
    assert tuo.chain_has_kernels(model, 1)
    # the serving chain's widths at feature size 32, all on the tensor cores but enc1.conv1
    fs = 32
    for mode, c, c_out in (("affine_leaky", fs, fs), ("cat2", 4 * fs, 2 * fs),
                           ("affine_leaky", 2 * fs, 2 * fs), ("combine", 2 * fs, fs)):
        assert conv_of.tc_route(c, c_out, BF, mode), (mode, c, c_out)


@pytest.mark.parametrize("mode", ["plain", "affine_leaky", "combine"])
def test_unwidened_modes_stop_at_64(mode):
    c_out = 32 if mode == "combine" else 64
    assert conv_of.tc_route(64, c_out, BF, mode)
    assert not conv_of.tc_route(128, c_out, BF, mode)
    assert not conv_of.tc_route(96, c_out, BF, mode)
    assert conv_of.wgrad_tc_route(64, 64, BF) and not conv_of.wgrad_tc_route(128, 64, BF)


def _had_kernel(mode, c_in, c_out, dtype):
    """``conv_of.conv_has_kernel`` before the widening: the tensor cores up to
    C = 64 (CAT2 at C_out 32 only), the CUDA cores at C_out 16, 32, 64."""
    if dtype not in (torch.float32, BF) or (mode in ("cat2", "combine") and c_in % 2):
        return False
    slice_c = c_in // 2 if mode in ("cat2", "combine") else c_in
    mode_c_out = {"plain": (16, 32, 64), "affine_leaky": (16, 32, 64), "cat2": (32,),
                  "combine": (16, 32)}[mode]
    tc = dtype == BF and slice_c % 16 == 0 and 0 < c_in <= 64 and c_out in mode_c_out
    return tc or c_out in (16, 32, 64)


@pytest.mark.parametrize("mode", ["plain", "affine_leaky", "cat2", "combine"])
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
def test_no_width_lost_its_kernel(mode, dtype):
    for c_in in (1, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256):
        for c_out in (8, 16, 24, 32, 48, 64, 128):
            if _had_kernel(mode, c_in, c_out, dtype):
                assert conv_of.conv_has_kernel(mode, c_in, c_out, dtype), (c_in, c_out)
    for c in (8, 16, 32, 64, 128, 136):
        for c_out in (16, 32, 48, 64, 128):  # K9's CUDA-core widths stay the table
            assert conv_flat.has_kernel(c, c_out) == (c % 8 == 0 and c <= 128 and c_out % 16 == 0)


@pytest.mark.parametrize("c_in", [1, 4])
@pytest.mark.parametrize("fs", FEATURE_SIZES)
def test_narrow_route_within_the_width_table(fs, c_in):
    for name, shape, c_out, input_grad in unetr_convs(fs, c_in):
        c = shape[1]
        narrow = conv_of.narrow_tc_route(c, c_out, BF)
        assert narrow == (name == "encoder1.conv1" and fs in (16, 32)), (name, c, c_out)
        assert conv_of.wgrad_narrow_tc_route(c, c_out, BF) == narrow
        assert not (narrow and conv_of.tc_route(c, c_out, BF))
        assert not conv_of.narrow_tc_route(c, c_out, torch.float32)
        assert not conv_of.narrow_tc_route(c, c_out, BF, "affine_leaky")
        if narrow:
            assert conv_of.conv_has_kernel("plain", c, c_out, BF)
            assert conv_of.wgrad_has_kernel(c, c_out, BF)
            assert conv3d.train_route(shape, c_out, BF, input_grad=input_grad, device="cuda")


@pytest.mark.parametrize("c", [8, 16, 24, 32, 48, 64, 80])
@pytest.mark.parametrize("k_pad", [8, 16, 24, 32, 40])
def test_outhead_route_within_the_unchanged_width_table(c, k_pad):
    assert conv_of.outhead_has_kernel(c) == (c <= 64)
    assert conv_of.outhead_row_has_kernel(c, k_pad) == (c <= 32 and k_pad <= 32)
    tc = conv_of.outhead_tc_route(c, k_pad, BF)
    assert tc == (c % 16 == 0 and c <= 64 and k_pad in (8, 16, 32))
    assert not conv_of.outhead_tc_route(c, k_pad, torch.float32)
    if tc:
        assert conv_of.outhead_has_kernel(c)


@pytest.mark.parametrize("fs", [16, 32])
@pytest.mark.parametrize("n_classes", [4, 14])
def test_served_out_heads_take_the_tensor_cores(fs, n_classes):
    """The out head of every model the chain serves on the card (feature
    sizes 16 and 32; BraTS' 4 classes pad to 8, 14 to 16) is on the route."""
    model = _model(fs, out_channels=n_classes)
    assert tuo.chain_has_kernels(model, 1)
    k_pad = tuo.class_pad(n_classes)
    assert conv_of.outhead_tc_route(fs, k_pad, BF)
    assert conv_of.outhead_row_has_kernel(fs, k_pad)
