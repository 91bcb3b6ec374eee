"""Swin UNETR's operation and byte counts (``architectures/swin_unetr.py``)
against values worked by hand, and its forward count pinned."""

from __future__ import annotations

import json

from portbench import manifest, work
from portbench.tests.tiny import REPO

FOLDER = REPO / "portbench"
ARCH = manifest.architecture(FOLDER, "swin_unetr")
M = json.loads((FOLDER / "configs" / "swin_unetr_btcv.json").read_text())["model"]


def test_forward_total_is_pinned():
    """637.05 GFLOP a 96^3 crop: convs and transposed convs 587.20, the Swin
    encoder's linears 26.99, the windows' QK^T and AV 22.87."""
    rows = ARCH.layers(M)
    assert work.forward_flops(ARCH, M) == 637_049_465_472
    by_kind = {}
    for row in rows:
        by_kind[row.kind] = by_kind.get(row.kind, 0) + row.flops
    assert by_kind["attention"] == 22_867_466_880
    assert by_kind["linear"] == 26_986_254_336
    assert by_kind["conv"] + by_kind["transp"] == 587_195_744_256
    assert len({row.name for row in rows}) == len(rows)


def test_one_attention_row_by_hand():
    """Stage 1: a 48^3 token grid padded to 49^3, 343 windows of 7^3 = 343
    tokens, width 48 (3 heads of 16); stage 4: one clamped 6^3 window of 216
    tokens at width 384."""
    by = work.layer_by_name(ARCH, M)
    row = by["swinViT.layers1.0.blocks.1.attn.sdpa"]
    assert (row.c_in, row.voxels, row.windows) == (48, 49**3, 343)
    assert row.flops == 343 * (2 * 343 * 343 * 48) * 2 == 7_747_892_544  # QK^T and AV
    assert by["swinViT.layers1.0.blocks.1.attn.qkv"].flops == 2 * 48 * 144 * 49**3  # padded
    assert by["swinViT.layers1.0.blocks.1.mlp.linear1"].flops == 2 * 48 * 192 * 48**3  # real
    assert by["swinViT.layers1.0.downsample.reduction"].flops == 2 * 384 * 96 * 24**3
    last = by["swinViT.layers4.0.blocks.0.attn.sdpa"]
    assert (last.voxels, last.windows, last.flops) == (216, 1, 4 * 216 * 216 * 384)


def test_window_attention_work_by_hand():
    """One step's attention calls over 4 crops with remat: per block two
    forwards and a backward (twice the operations); stage 1's unshifted
    block reads one (3, 343, 343) bias for all windows, its shifted block
    one bias-and-mask block per window; bf16."""
    row = work.layer_by_name(ARCH, M)["swinViT.layers1.0.blocks.0.attn.sdpa"]
    calls = ARCH.window_attention_work(M, 4, 2)
    assert len(calls) == 8 * 3
    qkvo = 4 * 49**3 * 48 * 2 * 4  # q, k, v, o of 4 crops
    bias, masked = 3 * 343**2 * 2, 343 * 3 * 343**2 * 2
    assert calls[0] == calls[1] == (4 * row.flops, qkvo + bias)
    assert calls[2] == (8 * row.flops, 2 * qkvo + 2 * bias)
    assert calls[3] == (4 * row.flops, qkvo + masked)
    assert calls[5] == (8 * row.flops, 2 * qkvo + 2 * masked)
    assert len(ARCH.window_attention_work(M, 4, 1)) == 8 * 2


def test_kernel_work_is_the_ct_loss_in_training_only():
    assert ARCH.kernel_work("K7_dice_ce_sums", "train", "ct") == [{"loss": "fwd", "task": "ct"}]
    assert ARCH.kernel_work("K8_dice_ce_bwd", "train", "ct") == [{"loss": "bwd", "task": "ct"}]
    for family in manifest.kernel_families(FOLDER):
        assert ARCH.kernel_work(family, "serve", "ct") == []
        assert ARCH.kernel_work(family, "train", "mri") == []
    assert ARCH.kernel_work("K1_conv3x3x3_of", "train", "ct") == []
