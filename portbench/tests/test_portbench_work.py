"""The operation and byte counts, against values worked by hand."""

from __future__ import annotations

import json

import pytest

from portbench import readings, work
from portbench.tests.tiny import REPO

BTCV = json.loads((REPO / "portbench/configs/unetr_b16_btcv.json").read_text())["model"]
V96 = 96**3


def test_one_conv_by_hand():
    layer = work.layer_by_name(BTCV)["decoder2.conv_block.conv1"]  # [up ; enc1] 32 -> 16
    assert (layer.c_in, layer.c_out, layer.taps, layer.voxels) == (32, 16, 27, V96)
    assert layer.flops == 2 * 27 * 32 * 16 * 884_736 == 24_461_180_928
    flops, act, wbytes, op = work.pass_work(layer, "fwd")
    assert (act, wbytes, op) == ((32 + 16) * 884_736 * 2, 32 * 16 * 27 * 2, "bf16")
    _, _, wgrad_bytes, _ = work.pass_work(layer, "wgrad")
    assert wgrad_bytes == 32 * 16 * 27 * 4  # the fp32 weight gradient
    # 84.96 MB at 3.35 TB/s (25.36 us) outlasts 24.46 GFLOP at 989 TFLOP/s (24.73 us)
    assert work.bound_s(flops, act + wbytes, op) == pytest.approx(84_962_304 / 3.35e12)


def test_one_vit_layer_by_hand():
    by = work.layer_by_name(BTCV)
    n, h, mlp = 216, 768, 3072  # (96 / 16)^3 tokens
    parts = ("attn.qkv", "attn.sdpa", "attn.out_proj", "mlp.linear1", "mlp.linear2")
    block = sum(by[f"vit.blocks.0.{part}"].flops for part in parts)
    by_hand = 2 * n * h * 3 * h + 2 * 2 * n * n * h + 2 * n * h * h + 2 * 2 * n * h * mlp
    assert block == by_hand == 3_200_974_848


def test_transposed_conv_takes_one_tap_per_output_voxel():
    layer = work.layer_by_name(BTCV)["decoder2.transp_conv"]  # 32 -> 16, 48^3 -> 96^3
    assert layer.flops == 2 * 32 * 16 * V96
    assert layer.in_voxels == 48**3 and layer.weight_elements == 32 * 16 * 8


def test_forward_totals():
    assert work.forward_flops(BTCV) == pytest.approx(126.574e9, rel=1e-4)
    brats = json.loads((REPO / "portbench/configs/unetr_b16_brats.json").read_text())["model"]
    assert work.forward_flops(brats) == pytest.approx(320.243e9, rel=1e-4)


def test_a_fused_tap_reads_its_input_once():
    ctx = readings.Context(kind="serve", task="ct", model=BTCV, trace=None, traced=1, completed=1,
                           window_s=1.0, items=1, families={}, peak_bytes=0)
    by = work.layer_by_name(BTCV)
    conv1, conv3 = by["decoder3.conv_block.conv1"], by["decoder3.conv_block.conv3"]
    family = {"work": [{"path": "serve", "layer": conv1.name, "pass": "fwd"},
                       {"path": "serve", "layer": conv3.name, "pass": "fwd",
                        "shares_input_of": f"{conv1.name}.fwd"},
                       {"path": "train", "layer": conv1.name, "pass": "wgrad"}]}
    flops = conv1.flops + conv3.flops
    nbytes = (64 + 32 + 32) * 48**3 * 2 + (64 * 32 * 27 + 64 * 32) * 2
    assert readings.family_bound_s(ctx, family) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))


def test_loss_work():
    flops, nbytes, op = work.loss_work(BTCV, "bwd", "ct")
    assert (flops, nbytes, op) == (13 * 14 * V96, 2 * 14 * V96 * 2 + V96 * 4, "fp32")
    with pytest.raises(ValueError):
        work.loss_work(BTCV, "fwd", "mri")
