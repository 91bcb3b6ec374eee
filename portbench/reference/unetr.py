"""UNETR (Hatamizadeh et al., WACV 2022) as MONAI 0.6's ``monai.networks.nets.UNETR``
defines it, written out as plain PyTorch functions over a dict of weights.

The configuration is the ``model`` group of a configuration file:
``in_channels``, ``out_channels``, ``img_size`` (the cube's edge),
``feature_size``, ``hidden_size``, ``mlp_dim``, ``num_heads``,
``num_layers``, ``patch_size``, ``pos_embed`` ("perceptron"), ``norm_name``
("instance"), ``res_block`` (true) and ``dropout_rate`` (0).

- ViT: non-overlapping p^3 patches, ``b c (h p1) (w p2) (d p3) -> b (h w d)
  (p1 p2 p3 c)``, one Linear, a learned positional embedding, no class
  token; pre-LN blocks (qkv without bias, softmax(q k^T / sqrt(head)) v,
  out projection with bias, MLP with the exact erf GELU), LayerNorm eps
  1e-5; returns the final LayerNorm and every block's output.
- Encoders tap hidden_states[L/4], [L/2] and [3L/4] ([3], [6], [9] at 12
  layers, counted from 0): encoder2 three transposed convs (k = s = 2), encoder3
  two, encoder4 one; encoder1 a residual block on the raw input.
- Residual block (``UnetResBlock``): conv3x3x3 - instance norm - leaky
  ReLU(0.01) - conv3x3x3 - instance norm, plus conv1x1 - instance norm where
  the channel count changes, then leaky ReLU. Every conv has a bias;
  instance norm is affine, eps 1e-5, biased variance.
- Decoder stage (``UnetrUpBlock``): transposed conv, concat [up ; skip],
  residual block. Out head: a 1x1x1 conv.

Weights are named as the MONAI module names them, which is also how the
program's modules name them. ``precision`` is ``"fp32"`` or ``"fp8"``
(``precision.round_operand`` on every matmul and conv operand).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import round_operand

LEAKY_SLOPE = 0.01
NORM_EPS = 1e-5


def _res_block(prefix: str, c_in: int, c_out: int) -> list[tuple[str, tuple, str, int]]:
    rows = [
        (f"{prefix}.conv1.conv.weight", (c_out, c_in, 3, 3, 3), "conv", c_in * 27),
        (f"{prefix}.conv1.conv.bias", (c_out,), "bias", 0),
        (f"{prefix}.conv2.conv.weight", (c_out, c_out, 3, 3, 3), "conv", c_out * 27),
        (f"{prefix}.conv2.conv.bias", (c_out,), "bias", 0),
        (f"{prefix}.norm1.weight", (c_out,), "norm_weight", 0),
        (f"{prefix}.norm1.bias", (c_out,), "norm_bias", 0),
        (f"{prefix}.norm2.weight", (c_out,), "norm_weight", 0),
        (f"{prefix}.norm2.bias", (c_out,), "norm_bias", 0),
    ]
    if c_in != c_out:
        rows += [
            (f"{prefix}.conv3.conv.weight", (c_out, c_in, 1, 1, 1), "conv", c_in),
            (f"{prefix}.conv3.conv.bias", (c_out,), "bias", 0),
            (f"{prefix}.norm3.weight", (c_out,), "norm_weight", 0),
            (f"{prefix}.norm3.bias", (c_out,), "norm_bias", 0),
        ]
    return rows


def _transp(prefix: str, c_in: int, c_out: int) -> list[tuple[str, tuple, str, int]]:
    # k = s = 2: every output voxel sees one tap of each input channel
    return [(f"{prefix}.conv.weight", (c_in, c_out, 2, 2, 2), "conv", c_in),
            (f"{prefix}.conv.bias", (c_out,), "bias", 0)]


def parameter_table(m: dict) -> list[tuple[str, tuple, str, int]]:
    """Every weight as (name, shape, kind, fan_in); kind is "linear", "conv",
    "pos", "bias", "norm_weight" or "norm_bias"."""
    hid, mlp, c_in = m["hidden_size"], m["mlp_dim"], m["in_channels"]
    p, fs, k = m["patch_size"], m["feature_size"], m["out_channels"]
    n_tokens = (m["img_size"] // p) ** 3
    rows = [
        ("vit.patch_embedding.position_embeddings", (1, n_tokens, hid), "pos", 0),
        ("vit.patch_embedding.patch_embeddings.1.weight", (hid, p**3 * c_in), "linear",
         p**3 * c_in),
        ("vit.patch_embedding.patch_embeddings.1.bias", (hid,), "bias", 0),
    ]
    for i in range(m["num_layers"]):
        b = f"vit.blocks.{i}"
        rows += [
            (f"{b}.norm1.weight", (hid,), "norm_weight", 0),
            (f"{b}.norm1.bias", (hid,), "norm_bias", 0),
            (f"{b}.attn.qkv.weight", (3 * hid, hid), "linear", hid),
            (f"{b}.attn.out_proj.weight", (hid, hid), "linear", hid),
            (f"{b}.attn.out_proj.bias", (hid,), "bias", 0),
            (f"{b}.norm2.weight", (hid,), "norm_weight", 0),
            (f"{b}.norm2.bias", (hid,), "norm_bias", 0),
            (f"{b}.mlp.linear1.weight", (mlp, hid), "linear", hid),
            (f"{b}.mlp.linear1.bias", (mlp,), "bias", 0),
            (f"{b}.mlp.linear2.weight", (hid, mlp), "linear", mlp),
            (f"{b}.mlp.linear2.bias", (hid,), "bias", 0),
        ]
    rows += [("vit.norm.weight", (hid,), "norm_weight", 0),
             ("vit.norm.bias", (hid,), "norm_bias", 0)]
    rows += _res_block("encoder1.layer", c_in, fs)
    for name, width, ups in (("encoder2", 2 * fs, 2), ("encoder3", 4 * fs, 1),
                             ("encoder4", 8 * fs, 0)):
        rows += _transp(f"{name}.transp_conv_init", hid, width)
        for j in range(ups):
            rows += _transp(f"{name}.blocks.{j}", width, width)
    for name, c_up, width in (("decoder5", hid, 8 * fs), ("decoder4", 8 * fs, 4 * fs),
                              ("decoder3", 4 * fs, 2 * fs), ("decoder2", 2 * fs, fs)):
        rows += _transp(f"{name}.transp_conv", c_up, width)
        rows += _res_block(f"{name}.conv_block", 2 * width, width)
    rows += [("out.conv.conv.weight", (k, fs, 1, 1, 1), "conv", fs),
             ("out.conv.conv.bias", (k,), "bias", 0)]
    return rows


def check_model(m: dict) -> None:
    """The equations above are those of this form of UNETR only."""
    want = {"pos_embed": "perceptron", "norm_name": "instance", "res_block": True,
            "dropout_rate": 0.0}
    for key, value in want.items():
        if m[key] != value:
            raise ValueError(f"the reference UNETR has {key} = {value!r}, not {m[key]!r}")
    if m["img_size"] % m["patch_size"] or m["hidden_size"] % m["num_heads"]:
        raise ValueError("img_size must divide by patch_size and hidden_size by num_heads")


class Ops:
    """The layers, with both operands of every matmul and conv rounded by
    ``precision``."""

    def __init__(self, w: dict, precision: str = "fp32") -> None:
        self.w = w
        self.precision = precision

    def r(self, x):
        return round_operand(x, self.precision)

    def linear(self, x, name, bias=True):
        b = self.w[f"{name}.bias"] if bias else None
        return F.linear(self.r(x), self.r(self.w[f"{name}.weight"]), b)

    def conv(self, x, name):
        weight = self.w[f"{name}.conv.weight"]
        pad = (weight.shape[-1] - 1) // 2
        return F.conv3d(self.r(x), self.r(weight), self.w[f"{name}.conv.bias"], padding=pad)

    def transp(self, x, name):
        return F.conv_transpose3d(self.r(x), self.r(self.w[f"{name}.conv.weight"]),
                                  self.w[f"{name}.conv.bias"], stride=2)

    def matmul(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    def layer_norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            NORM_EPS)

    def instance_norm(self, x, name):
        dims = (2, 3, 4)
        mean = x.mean(dim=dims, keepdim=True)
        var = (x - mean).square().mean(dim=dims, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + NORM_EPS)
        return y * self.w[f"{name}.weight"].view(1, -1, 1, 1, 1) + \
            self.w[f"{name}.bias"].view(1, -1, 1, 1, 1)

    def res_block(self, x, prefix):
        y = F.leaky_relu(self.instance_norm(self.conv(x, f"{prefix}.conv1"), f"{prefix}.norm1"),
                         LEAKY_SLOPE)
        y = self.instance_norm(self.conv(y, f"{prefix}.conv2"), f"{prefix}.norm2")
        if f"{prefix}.conv3.conv.weight" in self.w:
            x = self.instance_norm(self.conv(x, f"{prefix}.conv3"), f"{prefix}.norm3")
        return F.leaky_relu(y + x, LEAKY_SLOPE)


def vit(ops: Ops, m: dict, x: torch.Tensor):
    b, c, d, h, w = x.shape
    p, hid, heads = m["patch_size"], m["hidden_size"], m["num_heads"]
    hd = hid // heads
    t = x.reshape(b, c, d // p, p, h // p, p, w // p, p).permute(0, 2, 4, 6, 3, 5, 7, 1)
    t = t.reshape(b, (d // p) * (h // p) * (w // p), p**3 * c)
    t = ops.linear(t, "vit.patch_embedding.patch_embeddings.1")
    t = t + ops.w["vit.patch_embedding.position_embeddings"]
    n = t.shape[1]
    hidden_states = []
    for i in range(m["num_layers"]):
        blk = f"vit.blocks.{i}"
        y = ops.layer_norm(t, f"{blk}.norm1")
        qkv = ops.linear(y, f"{blk}.attn.qkv", bias=False).reshape(b, n, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        att = torch.softmax(ops.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        y = ops.matmul(att, v).transpose(1, 2).reshape(b, n, hid)
        t = t + ops.linear(y, f"{blk}.attn.out_proj")
        y = ops.layer_norm(t, f"{blk}.norm2")
        y = F.gelu(ops.linear(y, f"{blk}.mlp.linear1"))
        t = t + ops.linear(y, f"{blk}.mlp.linear2")
        hidden_states.append(t)
    return ops.layer_norm(t, "vit.norm"), hidden_states


def forward(w: dict, m: dict, x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """Logits (B, out_channels, D, H, W) of x (B, in_channels, D, H, W)."""
    ops = Ops(w, precision)
    grid = m["img_size"] // m["patch_size"]
    hid = m["hidden_size"]

    def proj(t):
        return t.reshape(t.shape[0], grid, grid, grid, hid).permute(0, 4, 1, 2, 3)

    def pr_up(t, name, ups):
        y = ops.transp(t, f"{name}.transp_conv_init")
        for j in range(ups):
            y = ops.transp(y, f"{name}.blocks.{j}")
        return y

    def up(t, skip, name):
        y = torch.cat([ops.transp(t, f"{name}.transp_conv"), skip], dim=1)
        return ops.res_block(y, f"{name}.conv_block")

    tokens, hs = vit(ops, m, x)
    q = m["num_layers"] // 4
    enc1 = ops.res_block(x, "encoder1.layer")
    enc2 = pr_up(proj(hs[q]), "encoder2", 2)
    enc3 = pr_up(proj(hs[2 * q]), "encoder3", 1)
    enc4 = pr_up(proj(hs[3 * q]), "encoder4", 0)
    dec3 = up(proj(tokens), enc4, "decoder5")
    dec2 = up(dec3, enc3, "decoder4")
    dec1 = up(dec2, enc2, "decoder3")
    out = up(dec1, enc1, "decoder2")
    return ops.conv(out, "out.conv")
