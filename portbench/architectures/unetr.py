"""UNETR (Hatamizadeh et al., WACV 2022): what the benchmark needs of the
architecture, found by the name ``"unetr"`` in a configuration's ``model``
group (``manifest.architecture``).

- ``parameter_table``, ``forward``: the plain reference's weights and
  logits, whose equations are in ``portbench/reference/unetr.py``.
- ``build``: the program's module, ``medseg_torch.models.unetr.UNETR``.
- ``layers``: the matmuls and convs of one window's forward pass, as
  ``work.Layer`` rows named as the MONAI modules are.
- ``kernel_work``: the work each hand-kernel family (``kernels/<family>.json``)
  carries on each path of this architecture.
- ``tiny``: a configuration cut to the CPU tests' size.
"""

from __future__ import annotations

import copy

from portbench.reference import unetr as reference
from portbench.work import Layer

parameter_table = reference.parameter_table  # (name, shape, kind, fan_in) rows
forward = reference.forward  # logits of x; precision "fp32", or "fp8" for the control


def build(m: dict, dtype, remat: bool):
    """The program's UNETR of the configuration's model group ``m``, its
    layers computing in ``dtype`` (None: float32)."""
    from medseg_torch.models.unetr import UNETR

    return UNETR(
        in_channels=m["in_channels"], out_channels=m["out_channels"],
        img_size=(m["img_size"],) * 3, feature_size=m["feature_size"],
        hidden_size=m["hidden_size"], mlp_dim=m["mlp_dim"], num_heads=m["num_heads"],
        num_layers=m["num_layers"], patch_size=m["patch_size"], pos_embed=m["pos_embed"],
        norm_name=m["norm_name"], res_block=m["res_block"], dropout_rate=m["dropout_rate"],
        dtype=dtype, remat=remat,
    )


def layers(m: dict) -> list[Layer]:
    """The forward pass of one window of edge ``img_size``, layer by layer."""
    edge, p, hid = m["img_size"], m["patch_size"], m["hidden_size"]
    fs, c_in, k = m["feature_size"], m["in_channels"], m["out_channels"]
    tokens = (edge // p) ** 3
    out = [Layer("vit.patch_embedding", "linear", p**3 * c_in, hid, 1, tokens)]
    for i in range(m["num_layers"]):
        b = f"vit.blocks.{i}"
        out += [Layer(f"{b}.attn.qkv", "linear", hid, 3 * hid, 1, tokens),
                Layer(f"{b}.attn.sdpa", "attention", hid, hid, 1, tokens),
                Layer(f"{b}.attn.out_proj", "linear", hid, hid, 1, tokens),
                Layer(f"{b}.mlp.linear1", "linear", hid, m["mlp_dim"], 1, tokens),
                Layer(f"{b}.mlp.linear2", "linear", m["mlp_dim"], hid, 1, tokens)]

    def vox(scale):  # voxels of a stage at edge / scale
        return (edge // scale) ** 3

    def res_block(prefix, cin, cout, v):
        rows = [Layer(f"{prefix}.conv1", "conv", cin, cout, 27, v),
                Layer(f"{prefix}.conv2", "conv", cout, cout, 27, v)]
        if cin != cout:
            rows.append(Layer(f"{prefix}.conv3", "conv", cin, cout, 1, v))
        return rows

    grid = edge // p  # the token grid's edge: the encoders start there
    out += res_block("encoder1.layer", c_in, fs, vox(1))
    for name, width, ups in (("encoder2", 2 * fs, 2), ("encoder3", 4 * fs, 1),
                             ("encoder4", 8 * fs, 0)):
        size = 2 * grid
        out.append(Layer(f"{name}.transp_conv_init", "transp", hid, width, 8, size**3))
        for j in range(ups):
            size *= 2
            out.append(Layer(f"{name}.blocks.{j}", "transp", width, width, 8, size**3))
    size = grid
    for name, c_up, width in (("decoder5", hid, 8 * fs), ("decoder4", 8 * fs, 4 * fs),
                              ("decoder3", 4 * fs, 2 * fs), ("decoder2", 2 * fs, fs)):
        size *= 2
        out.append(Layer(f"{name}.transp_conv", "transp", c_up, width, 8, size**3))
        out += res_block(f"{name}.conv_block", 2 * width, width, size**3)
    out.append(Layer("out.conv", "conv", fs, k, 1, vox(1)))
    return out


def _passes(pass_: str, names) -> list[dict]:
    return [{"layer": name, "pass": pass_} for name in names]


# The 3x3x3 convs that the training step routes to K1 (forward, and the data
# gradient where the input needs one) and K6 (the filter gradient).
_TRAIN_CONVS = ("encoder1.layer.conv1", "encoder1.layer.conv2", "decoder3.conv_block.conv1",
                "decoder3.conv_block.conv2", "decoder2.conv_block.conv1",
                "decoder2.conv_block.conv2")
_OUT_HEAD = {"serve": _passes("fwd", ["out.conv"])}

# family -> path -> entries: a layer's pass ("fwd", "dgrad", "wgrad"; a tap
# fused into another conv's call names it in "shares_input_of"), or the
# DiceCE loss's pass ("loss"); "task" keeps an entry to one task.
KERNEL_WORK = {
    "K1_conv3x3x3_of": {
        "serve": _passes("fwd", ["encoder1.layer.conv1", "encoder1.layer.conv2",
                                 "decoder3.conv_block.conv2", "decoder2.conv_block.conv2"]),
        "train": _passes("fwd", _TRAIN_CONVS) + _passes("dgrad", _TRAIN_CONVS[1:]),
    },
    "K2_conv3x3x3_of_combine": {"serve": [
        {"layer": "decoder2.conv_block.conv1", "pass": "fwd"},
        {"layer": "decoder2.conv_block.conv3", "pass": "fwd",
         "shares_input_of": "decoder2.conv_block.conv1.fwd"}]},
    "K3_outhead_of": _OUT_HEAD,
    "K4_outhead_row_of": _OUT_HEAD,
    "K5_conv3x3x3_of_cat2": {"serve": [
        {"layer": "decoder3.conv_block.conv1", "pass": "fwd"},
        {"layer": "decoder3.conv_block.conv3", "pass": "fwd",
         "shares_input_of": "decoder3.conv_block.conv1.fwd"}]},
    "K6_conv3x3x3_wgrad_of": {"train": _passes("wgrad", _TRAIN_CONVS)},
    "K7_dice_ce_sums": {"train": [{"loss": "fwd", "task": "ct"}]},
    "K8_dice_ce_bwd": {"train": [{"loss": "bwd", "task": "ct"}]},
}


def kernel_work(family: str, path: str, task: str) -> list[dict]:
    """The entries ``family`` carries on ``path`` ("serve", "train") for
    ``task``; none for a family this architecture gives no work."""
    entries = KERNEL_WORK.get(family, {}).get(path, [])
    return [e for e in entries if e.get("task", task) == task]


TINY_MODEL = {"img_size": 32, "hidden_size": 32, "mlp_dim": 64, "num_heads": 2, "num_layers": 4}
TINY_VOLUME = {"ct": [64, 64, 40], "mri": [48, 48, 39]}


def tiny(config: dict) -> dict:
    """``config`` at the CPU tests' size: the published structure at hidden
    32, 4 layers, 32^3 windows and crops, a small volume of each task."""
    out = copy.deepcopy(config)
    out["model"].update(TINY_MODEL)
    out["serve"]["roi"] = out["train"]["crop"] = TINY_MODEL["img_size"]
    out["serve"]["volume"] = list(TINY_VOLUME[config["task"]])
    return out
