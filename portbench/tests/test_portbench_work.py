"""The operation and byte counts, against values worked by hand, and the
readings of the benchmarked configurations pinned to what the harness read
before each configuration named its architecture."""

from __future__ import annotations

import json
import types

import pytest

from portbench import manifest, params, readings, work
from portbench.reference import unetr as unetr_reference
from portbench.serve import windows_per_volume
from portbench.tests.tiny import REPO

FOLDER = REPO / "portbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((REPO / c["file"]).read_text()) for c in BENCH["configs"]}
BTCV = CONFIGS["unetr_b16_btcv"]["model"]
UNETR = manifest.architecture(FOLDER, "unetr")
V96 = 96**3


def architecture(config: dict):
    return manifest.architecture(FOLDER, config["model"]["architecture"])


def test_one_conv_by_hand():
    layer = work.layer_by_name(UNETR, BTCV)["decoder2.conv_block.conv1"]  # [up ; enc1] 32 -> 16
    assert (layer.c_in, layer.c_out, layer.taps, layer.voxels) == (32, 16, 27, V96)
    assert layer.flops == 2 * 27 * 32 * 16 * 884_736 == 24_461_180_928
    flops, act, wbytes, op = work.pass_work(layer, "fwd")
    assert (act, wbytes, op) == ((32 + 16) * 884_736 * 2, 32 * 16 * 27 * 2, "bf16")
    _, _, wgrad_bytes, _ = work.pass_work(layer, "wgrad")
    assert wgrad_bytes == 32 * 16 * 27 * 4  # the fp32 weight gradient
    # 84.96 MB at 3.35 TB/s (25.36 us) outlasts 24.46 GFLOP at 989 TFLOP/s (24.73 us)
    assert work.bound_s(flops, act + wbytes, op) == pytest.approx(84_962_304 / 3.35e12)


def test_one_vit_layer_by_hand():
    by = work.layer_by_name(UNETR, BTCV)
    n, h, mlp = 216, 768, 3072  # (96 / 16)^3 tokens
    parts = ("attn.qkv", "attn.sdpa", "attn.out_proj", "mlp.linear1", "mlp.linear2")
    block = sum(by[f"vit.blocks.0.{part}"].flops for part in parts)
    by_hand = 2 * n * h * 3 * h + 2 * 2 * n * n * h + 2 * n * h * h + 2 * 2 * n * h * mlp
    assert block == by_hand == 3_200_974_848


def test_windowed_attention_by_hand():
    """343 windows of 343 tokens at width 48 (a Swin stage at 96^3, patch 2,
    window 7 after padding 48 to 49): QK^T and AV within each window."""
    rows = work.Layer("stage", "attention", 48, 48, 1, 343 * 343, windows=343)
    assert rows.flops == 343 * 4 * 343 * 343 * 48
    whole = work.Layer("global", "attention", 48, 48, 1, 343 * 343)
    assert whole.flops == 343 * rows.flops  # one window of all tokens


def test_transposed_conv_takes_one_tap_per_output_voxel():
    layer = work.layer_by_name(UNETR, BTCV)["decoder2.transp_conv"]  # 32 -> 16, 48^3 -> 96^3
    assert layer.flops == 2 * 32 * 16 * V96
    assert layer.in_voxels == 48**3 and layer.weight_elements == 32 * 16 * 8


FORWARD_FLOPS = {"unetr_b16_btcv": 126_573_871_104, "unetr_b16_brats": 320_243_499_008}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_totals(name):
    m = CONFIGS[name]["model"]
    arch = architecture(CONFIGS[name])
    total = work.forward_flops(arch, m)
    assert total == sum(layer.flops for layer in arch.layers(m)) > 0
    if name in FORWARD_FLOPS:  # read before the architectures had files of their own
        assert total == FORWARD_FLOPS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_each_familys_work_names_layers_of_the_architecture(name):
    config = CONFIGS[name]
    arch = architecture(config)
    by = work.layer_by_name(arch, config["model"])
    assert len(by) == len(arch.layers(config["model"]))  # names are unique
    for family in manifest.kernel_families(FOLDER):
        for path in ("serve", "train"):
            calls = set()
            for entry in arch.kernel_work(family, path, config["task"]):
                if "loss" in entry:
                    assert entry["loss"] in ("fwd", "bwd")
                    continue
                assert entry["layer"] in by and entry["pass"] in ("fwd", "dgrad", "wgrad")
                if "shares_input_of" in entry:
                    assert entry["shares_input_of"] in calls, entry
                else:
                    calls.add(f"{entry['layer']}.{entry['pass']}")


# family -> bound seconds per request, with 300 (CT) and 18 (BraTS) windows a
# volume and 4 crops a step, as the harness read them with each family's
# work in its kernels/<family>.json
BOUND_S = {
    ("unetr_b16_btcv", "serve"): {
        "K1_conv3x3x3_of": 0.014690276516586331, "K2_conv3x3x3_of_combine": 0.010141460021492537,
        "K3_outhead_of": 0.004753805506865672, "K4_outhead_row_of": 0.004753805506865672,
        "K5_conv3x3x3_of_cat2": 0.003847393921941355},
    ("unetr_b16_brats", "serve"): {
        "K1_conv3x3x3_of": 0.002156901521982162, "K2_conv3x3x3_of_combine": 0.0014423483223880598,
        "K3_outhead_of": 0.00045073121432835823, "K4_outhead_row_of": 0.00045073121432835823,
        "K5_conv3x3x3_of_cat2": 0.0005471849133427705},
    ("unetr_b16_btcv", "train"): {
        "K1_conv3x3x3_of": 0.0006576181258164587, "K6_conv3x3x3_wgrad_of": 0.00034678477634106516,
        "K7_dice_ce_sums": 3.3804838208955224e-05, "K8_dice_ce_bwd": 6.338407164179104e-05},
    ("unetr_b16_brats", "train"): {
        "K1_conv3x3x3_of": 0.0015737780738866638, "K6_conv3x3x3_wgrad_of": 0.00083698833246572},
}
FAMILIES = ["K1_conv3x3x3_of", "K2_conv3x3x3_of_combine", "K3_outhead_of", "K4_outhead_row_of",
            "K5_conv3x3x3_of_cat2", "K6_conv3x3x3_wgrad_of", "K7_dice_ce_sums", "K8_dice_ce_bwd",
            "conv_statistics_finish"]
BOUND_CASES = [(name, path, family) for name, path in BOUND_S for family in FAMILIES]


@pytest.mark.parametrize("name,path,family", BOUND_CASES,
                         ids=[f"{n}-{p}-{f}" for n, p, f in BOUND_CASES])
def test_bound_seconds_are_pinned(name, path, family):
    config = CONFIGS[name]
    items = windows_per_volume(config) if path == "serve" else 4
    ctx = readings.Context(kind=path, task=config["task"], model=config["model"], trace=None,
                           traced=1, completed=1, window_s=1.0, items=items, families={},
                           peak_bytes=0, architecture=architecture(config))
    want = BOUND_S[name, path].get(family, 0.0)
    assert readings.family_bound_s(ctx, family) == pytest.approx(want, rel=1e-12, abs=0.0)


# the weights at seed 2147483001 on the CPU, as the harness drew them from
# reference.unetr's table: the table's sha256 (names, shapes, kinds, fan-ins
# in order), the float64 sum of every element and the sum over tensors of
# (index + 1) x the tensor's sum of squares
WEIGHTS = {
    "unetr_b16_btcv": ("15f5ec422d0143a72d0d4d68ac9cdba83666b7f91cebc6d1c01a518eb407105e",
                       19753.456877513556, 8195397.287669571),
    "unetr_b16_brats": ("e5a29f7ad01c7ca26879a8bfb726fd2c2f4b0d4abf0c5cf06efd5a6d7f893c0f",
                        19778.78881827514, 8187221.449178135),
}


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_weights_are_pinned(name):
    import hashlib

    m = CONFIGS[name]["model"]
    table = unetr_reference.parameter_table(m)
    digest, total, weighted = WEIGHTS[name]
    rows = [[n, list(s), k, f] for n, s, k, f in table]
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == digest
    weights = params.make_weights(architecture(CONFIGS[name]), m, 2147483001, "cpu")
    assert [(n, tuple(t.shape)) for n, t in weights.items()] == [(n, s) for n, s, _, _ in table]
    values = list(weights.values())
    assert sum(float(t.double().sum()) for t in values) == pytest.approx(total, rel=1e-9)
    assert sum((i + 1) * float(t.double().square().sum()) for i, t in enumerate(values)) == \
        pytest.approx(weighted, rel=1e-9)


def test_a_fused_tap_reads_its_input_once():
    by = work.layer_by_name(UNETR, BTCV)
    conv1, conv3 = by["decoder3.conv_block.conv1"], by["decoder3.conv_block.conv3"]
    work_of = {"serve": [{"layer": conv1.name, "pass": "fwd"},
                         {"layer": conv3.name, "pass": "fwd",
                          "shares_input_of": f"{conv1.name}.fwd"}],
               "train": [{"layer": conv1.name, "pass": "wgrad"}]}
    arch = types.SimpleNamespace(  # UNETR's layers, one made-up family's work
        layers=UNETR.layers,
        kernel_work=lambda family, path, task: work_of[path] if family == "K" else [])
    ctx = readings.Context(kind="serve", task="ct", model=BTCV, trace=None, traced=1, completed=1,
                           window_s=1.0, items=1, families={}, peak_bytes=0, architecture=arch)
    flops = conv1.flops + conv3.flops
    nbytes = (64 + 32 + 32) * 48**3 * 2 + (64 * 32 * 27 + 64 * 32) * 2
    assert readings.family_bound_s(ctx, "K") == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert readings.family_bound_s(ctx, "another") == 0


def test_loss_work():
    flops, nbytes, op = work.loss_work(BTCV, "bwd", "ct")
    assert (flops, nbytes, op) == (13 * 14 * V96, 2 * 14 * V96 * 2 + V96 * 4, "fp32")
    with pytest.raises(ValueError):
        work.loss_work(BTCV, "fwd", "mri")
