"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266; Tang et al., CVPR 2022,
arXiv:2111.14791) as MONAI's ``monai.networks.nets.SwinUNETR`` version 1
defines it (``downsample="merging"``, ``use_v2=False``), written out as plain
PyTorch functions over a dict of weights.

The configuration is the ``model`` group of a configuration file:
``in_channels``, ``out_channels``, ``img_size`` (the cube's edge),
``feature_size``, ``depths``, ``num_heads``, ``window_size``,
``patch_size``, ``norm_name`` ("instance"), ``normalize`` (true) and the
drop rates ``drop_rate``, ``attn_drop_rate``, ``dropout_path_rate`` (0).

- Patch embedding: a conv with kernel = stride = p (bias). Tokens are then
  held as a (B, D, H, W, C) grid.
- Four stages i = 0..3 at width C = feature_size * 2^i with num_heads[i]
  heads, each depths[i] blocks then a patch merging. Block j:
  ``x + A(LN1(x))``, then ``x + W2 GELU(W1 LN2(x) + b1) + b2`` (LayerNorm eps
  1e-5, MLP 4C wide, the exact erf GELU).
- A (window attention): per dim the window w is 7, or the grid edge g where
  g <= 7, in which case that dim does not shift; the shift is 3 in odd
  blocks j and 0 in even ones. The normed grid is zero-padded at the far
  end of each dim to a multiple of w; a shifted block rolls it by -3 on every
  shifted dim. Windows are the w_d x w_h x w_w blocks in row-major order,
  tokens row-major within a window. Per window and head: ``softmax(q k^T /
  sqrt(C / heads) + B + M) v`` with q, k, v from one Linear C -> 3C with bias.
  B[i, j] = T[idx[i, j]], T the (2*7 - 1)^3 x heads table and idx the 7^3 x
  7^3 relative-position index of a 7^3 window, idx = (d_i - d_j + 6) * 169 +
  (h_i - h_j + 6) * 13 + (w_i - w_j + 6); a window of n < 343 tokens takes
  idx's first n x n entries (MONAI's slice, whatever the window's shape).
  M is 0 in unshifted blocks; in shifted ones -100 between tokens whose
  positions on the padded grid fall in different regions, each dim cut into
  [0, P - w), [P - w, P - s), [P - s, P) (P the padded edge, s the shift).
  Then a Linear C -> C with bias; the windows are put back, rolled by +3,
  and the padding is cropped.
- Patch merging: pad each odd edge by one, concatenate the eight strided
  sub-grids x[a::2, b::2, c::2] in the order (a, b, c) = (0,0,0), (1,0,0),
  (0,1,0), (0,0,1), (1,0,1), (0,1,0), (0,0,1), (1,1,1) (version 1's: the fifth
  and sixth repeat the third and fourth), LayerNorm over 8C, Linear 8C -> 2C
  without bias.
- Taps: the patch embedding's output and each stage's (after its merging),
  each under a LayerNorm over channels without affine, eps 1e-5.
- Decoder, UNETR's residual blocks (``reference/unetr.py``): encoder1 on the
  raw input (C_in -> F), encoder2/3/4 on taps 0/1/2 (F, 2F, 4F), encoder10
  on tap 4 (16F); decoder5 (16F -> 8F, skip tap 3), decoder4 (8F -> 4F, skip
  encoder4), decoder3 (-> 2F, encoder3), decoder2 (-> F, encoder2),
  decoder1 (F -> F, encoder1): transposed conv (k = s = 2), concat [up ;
  skip], residual block; the out head a 1x1x1 conv.

Departures from MONAI's module, all as the port's blocks have them: every
conv and transposed conv of the decoder has a bias (MONAI's ``UnetResBlock``
convs and ``UnetrUpBlock.transp_conv`` have none), and every instance norm
has an affine scale and shift (MONAI's ``"instance"`` norm has none); the
relative-position index and the shift masks are not weights (MONAI keeps
the index in the state dict). Weights are named as MONAI names them.
``precision`` is ``"fp32"`` or ``"fp8"`` (``precision.round_operand`` on both
operands of every matmul and conv: q, k, v and the probabilities included).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.unetr import Ops, _res_block, _transp

NORM_EPS = 1e-5
WINDOW_MAX = 7  # the window the bias table and index are built for
MASK = -100.0
MERGE = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))


def stage_widths(m: dict) -> list[int]:
    return [m["feature_size"] * 2**i for i in range(4)]


def parameter_table(m: dict) -> list[tuple[str, tuple, str, int]]:
    """Every weight as (name, shape, kind, fan_in); the bias table is "pos"
    (N(0, 0.02^2), MONAI's ``trunc_normal_(std=0.02)``)."""
    fs, c_in, k, p = m["feature_size"], m["in_channels"], m["out_channels"], m["patch_size"]
    w = m["window_size"]
    rows = [("swinViT.patch_embed.proj.weight", (fs, c_in, p, p, p), "conv", c_in * p**3),
            ("swinViT.patch_embed.proj.bias", (fs,), "bias", 0)]
    for i, (c, depth, heads) in enumerate(zip(stage_widths(m), m["depths"], m["num_heads"])):
        stage = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            b = f"{stage}.blocks.{j}"
            rows += [
                (f"{b}.norm1.weight", (c,), "norm_weight", 0),
                (f"{b}.norm1.bias", (c,), "norm_bias", 0),
                (f"{b}.attn.relative_position_bias_table", ((2 * w - 1) ** 3, heads), "pos", 0),
                (f"{b}.attn.qkv.weight", (3 * c, c), "linear", c),
                (f"{b}.attn.qkv.bias", (3 * c,), "bias", 0),
                (f"{b}.attn.proj.weight", (c, c), "linear", c),
                (f"{b}.attn.proj.bias", (c,), "bias", 0),
                (f"{b}.norm2.weight", (c,), "norm_weight", 0),
                (f"{b}.norm2.bias", (c,), "norm_bias", 0),
                (f"{b}.mlp.linear1.weight", (4 * c, c), "linear", c),
                (f"{b}.mlp.linear1.bias", (4 * c,), "bias", 0),
                (f"{b}.mlp.linear2.weight", (c, 4 * c), "linear", 4 * c),
                (f"{b}.mlp.linear2.bias", (c,), "bias", 0),
            ]
        rows += [(f"{stage}.downsample.norm.weight", (8 * c,), "norm_weight", 0),
                 (f"{stage}.downsample.norm.bias", (8 * c,), "norm_bias", 0),
                 (f"{stage}.downsample.reduction.weight", (2 * c, 8 * c), "linear", 8 * c)]
    rows += _res_block("encoder1.layer", c_in, fs)
    for name, width in (("encoder2", fs), ("encoder3", 2 * fs), ("encoder4", 4 * fs),
                        ("encoder10", 16 * fs)):
        rows += _res_block(f"{name}.layer", width, width)
    for name, c_up, width in decoders(fs):
        rows += _transp(f"{name}.transp_conv", c_up, width)
        rows += _res_block(f"{name}.conv_block", 2 * width, width)
    rows += [("out.conv.conv.weight", (k, fs, 1, 1, 1), "conv", fs),
             ("out.conv.conv.bias", (k,), "bias", 0)]
    return rows


def decoders(fs: int) -> list[tuple[str, int, int]]:
    """(name, upsampled channels in, width) of each decoder stage."""
    return [("decoder5", 16 * fs, 8 * fs), ("decoder4", 8 * fs, 4 * fs),
            ("decoder3", 4 * fs, 2 * fs), ("decoder2", 2 * fs, fs), ("decoder1", fs, fs)]


def check_model(m: dict) -> None:
    """The equations above are those of this form of Swin UNETR only."""
    want = {"norm_name": "instance", "normalize": True, "drop_rate": 0.0, "attn_drop_rate": 0.0,
            "dropout_path_rate": 0.0, "window_size": WINDOW_MAX}
    for key, value in want.items():
        if m[key] != value:
            raise ValueError(f"the reference Swin UNETR has {key} = {value!r}, not {m[key]!r}")
    if m["img_size"] % m["patch_size"] ** 5 or m["feature_size"] % 12:
        raise ValueError("img_size must divide by patch_size^5 and feature_size by 12")


def window_and_shift(grid: int, shifted: bool) -> tuple[int, int]:
    """The window edge and shift of one dim of a grid edge ``grid``."""
    if grid <= WINDOW_MAX:
        return grid, 0
    return WINDOW_MAX, WINDOW_MAX // 2 if shifted else 0


def relative_index() -> torch.Tensor:
    """(343, 343) int64 rows of the bias table, from the coordinates of two
    tokens of a 7^3 window."""
    r = torch.arange(WINDOW_MAX)
    d, h, w = (t.reshape(-1) for t in torch.meshgrid(r, r, r, indexing="ij"))
    e = 2 * WINDOW_MAX - 1

    def delta(t):
        return t[:, None] - t[None, :] + WINDOW_MAX - 1

    return delta(d) * e * e + delta(h) * e + delta(w)


def regions(padded: int, win: int, shift: int) -> torch.Tensor:
    """The region (0, 1, 2) of each position along one padded edge; with
    shift 0 one region, as MONAI's slices [:-w], [-w:-0] (empty) and [-0:]
    (all) leave it."""
    t = torch.arange(padded)
    out = torch.full((padded,), 2)
    if shift:
        out[t < padded - shift] = 1
        out[t < padded - win] = 0
    return out


def partition(x: torch.Tensor, win) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * windows, tokens, C)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // win[0], win[0], h // win[1], win[1], w // win[2], win[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, win[0] * win[1] * win[2], c)


def unpartition(x: torch.Tensor, win, b: int, dims) -> torch.Tensor:
    d, h, w = dims
    x = x.reshape(b, d // win[0], h // win[1], w // win[2], win[0], win[1], win[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def layer_norm(ops: Ops, x: torch.Tensor, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), ops.w[f"{name}.weight"], ops.w[f"{name}.bias"],
                        NORM_EPS)


def window_attention(ops: Ops, x: torch.Tensor, name: str, heads: int, shifted: bool):
    """A(x) of one block on a (B, D, H, W, C) grid, already normed."""
    b, d, h, w, c = x.shape
    grid = (d, h, w)
    win, shift = zip(*(window_and_shift(g, shifted) for g in grid))
    pad = [-(-g // s) * s for g, s in zip(grid, win)]
    x = F.pad(x, (0, 0, 0, pad[2] - w, 0, pad[1] - h, 0, pad[0] - d))
    if any(shift):
        x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    tokens = partition(x, win)
    n = tokens.shape[1]
    hd = c // heads
    qkv = ops.linear(tokens, f"{name}.qkv").reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] / math.sqrt(hd), qkv[1], qkv[2]
    logits = ops.matmul(q, k.transpose(-1, -2))
    table = ops.w[f"{name}.relative_position_bias_table"]
    bias = table[relative_index().to(x.device)[:n, :n]].permute(2, 0, 1)  # (heads, n, n)
    logits = logits + bias
    if any(shift):
        ids = torch.zeros(pad, dtype=torch.long, device=x.device)
        for axis, (p, s_win, s) in enumerate(zip(pad, win, shift)):
            view = [1, 1, 1]
            view[axis] = p
            ids = ids * 3 + regions(p, s_win, s).to(x.device).view(view)
        ids = partition(ids[None, ..., None].float(), win)[..., 0]  # (windows, n)
        mask = torch.where(ids[:, :, None] != ids[:, None, :], MASK, 0.0)
        windows = mask.shape[0]
        logits = (logits.reshape(b, windows, heads, n, n) + mask[None, :, None]).reshape(
            -1, heads, n, n)
    att = torch.softmax(logits, dim=-1)
    y = ops.matmul(att, v).transpose(1, 2).reshape(-1, n, c)
    y = unpartition(ops.linear(y, f"{name}.proj"), win, b, pad)
    if any(shift):
        y = torch.roll(y, shifts=shift, dims=(1, 2, 3))
    return y[:, :d, :h, :w]


def merge(ops: Ops, x: torch.Tensor, name: str) -> torch.Tensor:
    _, d, h, w, _ = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, a::2, b::2, c::2] for a, b, c in MERGE], dim=-1)
    return ops.linear(layer_norm(ops, x, f"{name}.norm"), f"{name}.reduction", bias=False)


def tap(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) under a LayerNorm over C without affine, as (B, C, D, H, W)."""
    return F.layer_norm(x, (x.shape[-1],), eps=NORM_EPS).permute(0, 4, 1, 2, 3)


def encoder(ops: Ops, m: dict, x: torch.Tensor) -> list[torch.Tensor]:
    p = m["patch_size"]
    t = F.conv3d(ops.r(x), ops.r(ops.w["swinViT.patch_embed.proj.weight"]),
                 ops.w["swinViT.patch_embed.proj.bias"], stride=p).permute(0, 2, 3, 4, 1)
    taps = [tap(t)]
    for i, (depth, heads) in enumerate(zip(m["depths"], m["num_heads"])):
        stage = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            b = f"{stage}.blocks.{j}"
            t = t + window_attention(ops, layer_norm(ops, t, f"{b}.norm1"), f"{b}.attn", heads,
                                     shifted=j % 2 == 1)
            y = F.gelu(ops.linear(layer_norm(ops, t, f"{b}.norm2"), f"{b}.mlp.linear1"))
            t = t + ops.linear(y, f"{b}.mlp.linear2")
        t = merge(ops, t, f"{stage}.downsample")
        taps.append(tap(t))
    return taps


def forward(w: dict, m: dict, x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """Logits (B, out_channels, D, H, W) of x (B, in_channels, D, H, W)."""
    check_model(m)
    ops = Ops(w, precision)

    def up(t, skip, name):
        y = torch.cat([ops.transp(t, f"{name}.transp_conv"), skip], dim=1)
        return ops.res_block(y, f"{name}.conv_block")

    hs = encoder(ops, m, x)
    enc0 = ops.res_block(x, "encoder1.layer")
    enc1 = ops.res_block(hs[0], "encoder2.layer")
    enc2 = ops.res_block(hs[1], "encoder3.layer")
    enc3 = ops.res_block(hs[2], "encoder4.layer")
    dec4 = ops.res_block(hs[4], "encoder10.layer")
    dec3 = up(dec4, hs[3], "decoder5")
    dec2 = up(dec3, enc3, "decoder4")
    dec1 = up(dec2, enc2, "decoder3")
    dec0 = up(dec1, enc1, "decoder2")
    return ops.conv(up(dec0, enc0, "decoder1"), "out.conv")
