"""Swin UNETR (arXiv:2201.01266; BTCV fine-tuning at 96^3, feature size 48,
arXiv:2111.14791): what the benchmark needs of the architecture, found by
the name ``"swin_unetr"`` in a configuration's ``model`` group
(``manifest.architecture``).

- ``parameter_table``, ``forward``: the plain reference's weights and
  logits, whose equations are in ``portbench/reference/swin_unetr.py``.
- ``build``: the program's module, ``medseg_torch.models.swin_unetr.SwinUNETR``.
- ``layers``: the matmuls and convs of one window's forward pass, as
  ``work.Layer`` rows named as the MONAI modules are: the window
  attention's QK^T and AV (``attention``, ``windows`` windows on the padded
  grid) and the attention's linears on the padded grid, where the module
  computes them; the MLPs, the mergings and the convs on the real grid.
- ``window_attention_work``: the attention's operations and bytes per pass,
  for ``window_attention_roofline.*``.
- ``kernel_work``: the work each hand-kernel family carries: the fused CT
  DiceCE (K7, K8) in training. No 3x3x3 conv of this decoder (48 to 768
  channels) has a width of K1/K6's tables, so cuDNN runs them all.
- ``tiny``: a configuration cut to the CPU tests' size.
"""

from __future__ import annotations

import copy

from portbench.reference import swin_unetr as reference
from portbench.work import ELEMENT_BYTES, Layer

parameter_table = reference.parameter_table  # (name, shape, kind, fan_in) rows
forward = reference.forward  # logits of x; precision "fp32", or "fp8" for the control


def build(m: dict, dtype, remat: bool):
    """The program's SwinUNETR of the configuration's model group ``m``,
    its layers computing in ``dtype`` (None: float32)."""
    from medseg_torch.models.swin_unetr import SwinUNETR

    reference.check_model(m)
    return SwinUNETR(
        in_channels=m["in_channels"], out_channels=m["out_channels"],
        img_size=(m["img_size"],) * 3, feature_size=m["feature_size"],
        depths=tuple(m["depths"]), num_heads=tuple(m["num_heads"]),
        window_size=m["window_size"], patch_size=m["patch_size"], norm_name=m["norm_name"],
        normalize=m["normalize"], dtype=dtype, remat=remat,
    )


def stages(m: dict) -> list[dict]:
    """Per stage: width, heads, depth, grid edge, window edge, padded edge,
    windows and tokens per window (the window clamped where the grid is at
    most 7)."""
    out = []
    grid = m["img_size"] // m["patch_size"]
    for i, (c, depth, heads) in enumerate(zip(reference.stage_widths(m), m["depths"],
                                              m["num_heads"])):
        win, _ = reference.window_and_shift(grid, shifted=False)
        pad = -(-grid // win) * win
        out.append({"stage": f"swinViT.layers{i + 1}.0", "width": c, "heads": heads,
                    "depth": depth, "grid": grid, "window": win, "padded": pad,
                    "windows": (pad // win) ** 3, "tokens": win**3})
        grid = -(-grid // 2)
    return out


def _res_block(prefix, cin, cout, v):
    rows = [Layer(f"{prefix}.conv1", "conv", cin, cout, 27, v),
            Layer(f"{prefix}.conv2", "conv", cout, cout, 27, v)]
    if cin != cout:
        rows.append(Layer(f"{prefix}.conv3", "conv", cin, cout, 1, v))
    return rows


def layers(m: dict) -> list[Layer]:
    """The forward pass of one window of edge ``img_size``, layer by layer."""
    edge, p, fs = m["img_size"], m["patch_size"], m["feature_size"]
    c_in, k = m["in_channels"], m["out_channels"]
    out = [Layer("swinViT.patch_embed.proj", "linear", p**3 * c_in, fs, 1, (edge // p) ** 3)]
    for s in stages(m):
        c, real, padded = s["width"], s["grid"] ** 3, s["padded"] ** 3
        for j in range(s["depth"]):
            b = f"{s['stage']}.blocks.{j}"
            out += [Layer(f"{b}.attn.qkv", "linear", c, 3 * c, 1, padded),
                    Layer(f"{b}.attn.sdpa", "attention", c, c, 1, padded, s["windows"]),
                    Layer(f"{b}.attn.proj", "linear", c, c, 1, padded),
                    Layer(f"{b}.mlp.linear1", "linear", c, 4 * c, 1, real),
                    Layer(f"{b}.mlp.linear2", "linear", 4 * c, c, 1, real)]
        merged = (-(-s["grid"] // 2)) ** 3
        out.append(Layer(f"{s['stage']}.downsample.reduction", "linear", 8 * c, 2 * c, 1, merged))

    def vox(scale):
        return (edge // scale) ** 3

    out += _res_block("encoder1.layer", c_in, fs, vox(1))
    for name, width, scale in (("encoder2", fs, 2), ("encoder3", 2 * fs, 4),
                               ("encoder4", 4 * fs, 8), ("encoder10", 16 * fs, 32)):
        out += _res_block(f"{name}.layer", width, width, vox(scale))
    scale = 32
    for name, c_up, width in reference.decoders(fs):
        scale //= 2
        out.append(Layer(f"{name}.transp_conv", "transp", c_up, width, 8, vox(scale)))
        out += _res_block(f"{name}.conv_block", 2 * width, width, vox(scale))
    out.append(Layer("out.conv", "conv", fs, k, 1, vox(1)))
    return out


def window_attention_work(m: dict, items: int, forwards: int) -> list[tuple[float, float]]:
    """(operations, bytes) of each attention call of a training step over
    ``items`` crops: per block the forward ``forwards`` times (2 where remat
    recomputes it) and the backward (twice the forward's operations). Bytes in bf16, each
    tensor once a call: q, k, v and o of every crop (the backward also reads
    o and dO and writes dq, dk, dv), and the bias (with the shift mask, one
    (heads, n, n) block per window in shifted blocks, one for all windows in
    unshifted ones) read once and, in the backward, its gradient written
    once."""
    e = ELEMENT_BYTES["bf16"]
    by_name = {layer.name: layer for layer in layers(m)}
    out = []
    for s in stages(m):
        for j in range(s["depth"]):
            row = by_name[f"{s['stage']}.blocks.{j}.attn.sdpa"]
            shifted = j % 2 == 1 and s["grid"] > reference.WINDOW_MAX
            qkvo = 4 * row.voxels * row.c_in * e * items
            bias = (s["windows"] if shifted else 1) * s["heads"] * s["tokens"] ** 2 * e
            fwd = (row.flops * items, qkvo + bias)
            out += [fwd] * forwards
            out.append((2 * row.flops * items, 2 * qkvo + 2 * bias))
    return out


def kernel_work(family: str, path: str, task: str) -> list[dict]:
    """The entries ``family`` carries on ``path`` ("serve", "train") for
    ``task``: the fused DiceCE in CT training, nothing else."""
    entries = {"K7_dice_ce_sums": [{"loss": "fwd", "task": "ct"}],
               "K8_dice_ce_bwd": [{"loss": "bwd", "task": "ct"}]}.get(family, [])
    return [e for e in entries if path == "train" and e["task"] == task]


TINY_MODEL = {"img_size": 32, "feature_size": 24}
TINY_VOLUME = {"ct": [64, 64, 40], "mri": [48, 48, 39]}


def tiny(config: dict) -> dict:
    """``config`` at the CPU tests' size: the published structure at 32^3
    windows and crops (the stages' grids 16, 8, 4, 2: 16 pads to 21 and 8 to
    14 and both shift; 4^3 and 2^3 windows, clamped, read a slice of the
    bias index) and feature size 24, a small volume of each task. At feature
    size 12 (head width 4) the fp32 comparison of three training steps
    (``tests/test_portbench_reference.py``, seed 7, ATen's convolutions)
    read loss gaps of 1.07e-5-1.20e-5 at 1, 2 and 4 CPU threads, over its
    1e-5: a decoder leaky-ReLU pre-activation within float32 rounding of 0
    took one sign in the program and the other in the reference, and that
    voxel's gradient differed 100-fold (``tests/conftest.py``). At 24 it
    reads 2.3e-7 to 6.7e-6 at 1, 2, 4 and 8 threads."""
    out = copy.deepcopy(config)
    out["model"].update(TINY_MODEL)
    out["serve"]["roi"] = out["train"]["crop"] = TINY_MODEL["img_size"]
    out["serve"]["volume"] = list(TINY_VOLUME[config["task"]])
    return out
