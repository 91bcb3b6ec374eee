"""Swin UNETR: a Swin transformer encoder under UNETR's residual conv
decoder, NCDHW (Hatamizadeh et al., arXiv:2201.01266; Tang et al., CVPR
2022, arXiv:2111.14791).

MONAI's ``monai.networks.nets.SwinUNETR`` in its first version
(``downsample="merging"``, ``use_v2=False``), the module its published
checkpoints load into:

- ``swinViT.patch_embed``: a Conv3d with kernel = stride = ``patch_size``
  (bias, no norm); the token grid is then held channels last.
- Four stages (``swinViT.layers{1..4}.0``), each ``depths[i]`` Swin blocks at
  width ``feature_size * 2**i`` with ``num_heads[i]`` heads, then a patch
  merging. A block is ``x + attention(norm1(x))``, then ``x + mlp(norm2(x))``
  (LayerNorm eps 1e-5; MLP ratio 4, exact erf GELU).
- Window attention: the normed grid is zero-padded at its far end to a
  multiple of the window, the even blocks attend within ``window_size``^3
  windows, the odd ones within windows cyclically shifted by ``window_size //
  2`` (``torch.roll``) under a -100 mask between the 27 regions the shift
  wraps together (MONAI's ``compute_mask``). Where a grid edge is at most the
  window, the window is clamped to the grid and that block does not shift
  (``get_window_size``). Each head adds a learned relative-position bias
  from a (2w - 1)^3-row table, indexed by the (w^3, w^3) relative-position
  index; a window of n < w^3 tokens reads the index's first n x n entries,
  as MONAI does. qkv has a bias; q is scaled by head_dim^-0.5.
- Patch merging (MONAI's ``PatchMerging``, not ``PatchMergingV2``): the eight
  2x2x2 sub-grids concatenated in version 1's order, whose fifth and sixth
  slices repeat the third and fourth, then LayerNorm over 8C and a Linear 8C
  -> 2C without bias.
- Five taps, each the stage output under a LayerNorm over channels without
  affine (``normalize=True``): the patch embedding's and the four stages'.
- Decoder: ``encoder1`` on the raw input, ``encoder2/3/4`` on the first
  three taps, ``encoder10`` on the last, ``decoder5..1`` (``UnetrUpBlock``:
  transposed conv, concat with the skip, residual block), the 1x1x1 ``out``
  head; the port's UNETR blocks (``models.blocks``), so every conv and
  transposed conv has a bias and every instance norm an affine, as in
  ``models.unetr``.

Weights carry MONAI's names (``swinViT.layers1.0.blocks.1.attn.
relative_position_bias_table``, ``swinViT.layers1.0.downsample.reduction.
weight``, ``encoder10.layer.conv1.conv.weight``, ...). What follows from the
window (the relative-position index, the shift masks at ``img_size``) is
kept in non-persistent buffers.

``dtype`` is the compute dtype (parameters stay fp32, LayerNorm and
instance-norm statistics in fp32); setting ``model.dtype`` sets it on every
layer. The windows attend through ``F.scaled_dot_product_attention``, with
the bias (plus the shift mask) as a float ``attn_mask`` in the compute
dtype, so that the table's gradient comes back through it. ``remat=True`` is
MONAI's ``use_checkpoint``: each block's attention part and MLP part are
recomputed in the backward pass (non-reentrant); the decoder keeps its
activations.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from medseg_torch.models.blocks import UnetOutBlock, UnetrBasicBlock, UnetrUpBlock, compute_dtype
from medseg_torch.models.vit import layer_norm, linear
from medseg_torch.utils.profiling import span

MASK_VALUE = -100.0  # between tokens of different shift regions (MONAI's compute_mask)
MLP_RATIO = 4
NORM_EPS = 1e-5
# version 1's merge order: (d, h, w) offsets of the eight slices, the fifth and
# sixth repeating the third and fourth
MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1),
               (1, 1, 1))


def window_for(grid, window: int, shift: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """MONAI's ``get_window_size``: per dim, the window clamped to a grid edge
    of at most ``window``, where the shift is then 0."""
    sizes = tuple(min(g, window) for g in grid)
    shifts = tuple(0 if g <= window else shift for g in grid)
    return sizes, shifts


def padded(grid, window) -> tuple[int, ...]:
    return tuple(-(-g // w) * w for g, w in zip(grid, window))


def relative_position_index(window: int) -> torch.Tensor:
    """(w^3, w^3) int64: the bias table's row for query i and key j, from
    their coordinates' difference in a w^3 window (MONAI's formula)."""
    coords = torch.stack(torch.meshgrid(*(torch.arange(window),) * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    span_ = 2 * window - 1
    return rel[..., 0] * span_ * span_ + rel[..., 1] * span_ + rel[..., 2]


def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * windows, w_d * w_h * w_w, C), windows row-major."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window, dims) -> torch.Tensor:
    """The inverse of ``window_partition`` onto (B, D, H, W, C)."""
    b, d, h, w = dims
    wd, wh, ww = window
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_mask(dims, window, shift) -> torch.Tensor:
    """(windows, n, n) fp32: 0 between tokens of one shift region, -100
    between regions, over a padded grid ``dims`` (MONAI's ``compute_mask``:
    each dim cut at ``-window`` and ``-shift`` into three bands)."""
    regions = torch.zeros((1, *dims, 1))
    cnt = 0
    bands = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window, shift)]
    for d, h, w in itertools.product(*bands):
        regions[:, d, h, w, :] = cnt
        cnt += 1
    ids = window_partition(regions, window).squeeze(-1)
    diff = ids.unsqueeze(1) - ids.unsqueeze(2)
    return torch.where(diff != 0, MASK_VALUE, 0.0)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with a relative-position
    bias per head (MONAI's ``WindowAttention``)."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self, n: int) -> torch.Tensor:
        """(heads, n, n) fp32: the first n x n entries of the index, read
        from the table."""
        index = self.relative_position_index[:n, :n].reshape(-1)
        return self.relative_position_bias_table[index].view(n, n, -1).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None, windows: int) -> torch.Tensor:
        """``x`` (B * windows, n, C), the windows of each sample together;
        ``mask`` (windows, n, n) or None."""
        bw, n, c = x.shape
        heads = self.num_heads
        qkv = linear(self.qkv, x, self.dtype)
        dt = qkv.dtype
        bias = self.bias(n).to(dt)
        if mask is None:  # one bias for every window: (B * windows, heads, n, d)
            q, k, v = qkv.view(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
            y = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.unsqueeze(0))
            y = y.transpose(1, 2)
        else:  # a bias and a mask per (window, head), shared by the samples
            b = bw // windows
            q, k, v = qkv.view(b, windows, n, 3, heads, c // heads).permute(3, 0, 1, 4, 2, 5) \
                .reshape(3, b, windows * heads, n, c // heads)
            attn_mask = (bias.unsqueeze(0) + mask.to(dt).unsqueeze(1)).view(1, -1, n, n)
            y = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
            y = y.view(b, windows, heads, n, c // heads).permute(0, 1, 3, 2, 4)
        return linear(self.proj, y.reshape(bw, n, c), self.dtype)


class MLPBlock(nn.Module):
    """Linear - exact GELU - Linear (MONAI's ``MLPBlock``)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.linear2, F.gelu(linear(self.linear1, x, self.dtype)), self.dtype)


class SwinTransformerBlock(nn.Module):
    """Pre-norm window attention (shifted when ``shift`` > 0) and MLP, each
    with a residual, on a (B, D, H, W, C) grid."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 dtype: torch.dtype | None = None, remat: bool = False) -> None:
        super().__init__()
        self.window = window
        self.shift = shift
        self.dtype = dtype
        self.remat = remat
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn = WindowAttention(dim, num_heads, window, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.mlp = MLPBlock(dim, MLP_RATIO * dim, dtype)

    def attention_part(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        with span("medseg.swin.attention"):
            b, d, h, w, c = x.shape
            window, shift = window_for((d, h, w), self.window, self.shift)
            x = layer_norm(self.norm1, x, self.dtype)
            dp, hp, wp = padded((d, h, w), window)
            x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h, 0, dp - d))
            shifted = any(shift)
            if shifted:
                x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
            windows = (dp // window[0]) * (hp // window[1]) * (wp // window[2])
            y = self.attn(window_partition(x, window), mask if shifted else None, windows)
            y = window_reverse(y, window, (b, dp, hp, wp))
            if shifted:
                y = torch.roll(y, shifts=shift, dims=(1, 2, 3))
            return y[:, :d, :h, :w].contiguous()

    def mlp_part(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(layer_norm(self.norm2, x, self.dtype))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            x = x + checkpoint(self.attention_part, x, mask, use_reentrant=False)
            return x + checkpoint(self.mlp_part, x, use_reentrant=False)
        x = x + self.attention_part(x, mask)
        return x + self.mlp_part(x)


class PatchMerging(nn.Module):
    """2x2x2 token merging in MONAI version 1's slice order, LayerNorm over
    8C, Linear 8C -> 2C without bias."""

    def __init__(self, dim: int, dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(8 * dim, eps=NORM_EPS)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in MERGE_ORDER], dim=-1)
        return linear(self.reduction, layer_norm(self.norm, x, self.dtype), self.dtype)


class BasicLayer(nn.Module):
    """One stage: ``depth`` blocks, unshifted and shifted in turn, then a
    patch merging. ``grid``: the stage's token grid at the model's
    ``img_size``, whose shift mask is kept as a buffer."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, grid,
                 dtype: torch.dtype | None = None, remat: bool = False) -> None:
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2,
                                 dtype, remat)
            for i in range(depth))
        self.downsample = PatchMerging(dim, dtype)
        self.grid = tuple(grid)
        self.register_buffer("shift_mask", self._mask(grid), persistent=False)

    def _mask(self, grid) -> torch.Tensor:
        window, shift = window_for(grid, self.window, self.window // 2)
        return shift_mask(padded(grid, window), window, shift)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        grid = tuple(x.shape[1:4])
        mask = self.shift_mask if grid == self.grid else self._mask(grid).to(x.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return self.downsample(x)


class SwinTransformer(nn.Module):
    """The encoder: patch embedding and four stages; returns the five taps,
    NCDHW, each normalized over channels where ``normalize``."""

    def __init__(self, in_channels: int, embed_dim: int, window: int, patch_size: int,
                 depths, num_heads, grid, normalize: bool = True,
                 dtype: torch.dtype | None = None, remat: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.normalize = normalize
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv3d(in_channels, embed_dim, patch_size, patch_size)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            stage = BasicLayer(embed_dim * 2**i, depth, heads, window,
                               tuple(g // 2**i for g in grid), dtype, remat)
            setattr(self, f"layers{i + 1}", nn.ModuleList([stage]))

    def tap(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) -> (B, C, D, H, W), over channels normalized."""
        if self.normalize:
            y = F.layer_norm(x.to(torch.promote_types(x.dtype, torch.float32)), x.shape[-1:],
                             eps=NORM_EPS)
            x = y.to(x.dtype)
        return x.permute(0, 4, 1, 2, 3).contiguous()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        with span("medseg.swin.encoder"):
            proj = self.patch_embed.proj
            dt = compute_dtype(self.dtype, x, proj.weight)
            x = F.conv3d(x.to(dt), proj.weight.to(dt), proj.bias.to(dt), stride=proj.stride)
            x = x.permute(0, 2, 3, 4, 1)
            taps = [self.tap(x)]
            for i in range(1, 5):
                x = getattr(self, f"layers{i}")[0](x)
                taps.append(self.tap(x))
            return taps


class SwinUNETR(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 14,
        img_size: tuple[int, int, int] = (96, 96, 96),
        feature_size: int = 48,
        depths: tuple[int, ...] = (2, 2, 2, 2),
        num_heads: tuple[int, ...] = (3, 6, 12, 24),
        window_size: int = 7,
        patch_size: int = 2,
        norm_name: str = "instance",
        normalize: bool = True,
        dtype: torch.dtype | None = None,
        remat: bool = False,
    ) -> None:
        super().__init__()
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError("Swin UNETR has four stages: depths and num_heads need four entries")
        if any(s % patch_size**5 for s in img_size):
            raise ValueError(f"img_size {tuple(img_size)} must divide by patch_size**5")
        if feature_size % 12:
            raise ValueError("feature_size should be divisible by 12")
        if norm_name != "instance":
            raise ValueError(f"norm_name {norm_name!r} is not supported (only 'instance')")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.img_size = tuple(img_size)
        self.feature_size = fs = feature_size
        self.swinViT = SwinTransformer(
            in_channels, fs, window_size, patch_size, depths, num_heads,
            tuple(s // patch_size for s in img_size), normalize, remat=remat)
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, out_channels)
        self.dtype = dtype  # sets every layer's compute dtype

    @property
    def dtype(self) -> torch.dtype | None:
        return self._dtype

    @dtype.setter
    def dtype(self, value: torch.dtype | None) -> None:
        self._dtype = value
        for m in self.modules():
            if m is not self and "dtype" in vars(m):
                m.dtype = value

    def forward(self, x_in: torch.Tensor, *, return_encoder_features: bool = False):
        """x_in: (B, C, D, H, W) -> logits (B, out_channels, D, H, W), in the
        signature the entry points call (``return_encoder_features=False``;
        UNETR's pretraining features have no counterpart here)."""
        if return_encoder_features:
            raise ValueError("SwinUNETR returns logits only")
        hidden = self.swinViT(x_in)
        enc0 = self.encoder1(x_in)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        dec4 = self.encoder10(hidden[4])
        dec3 = self.decoder5(dec4, hidden[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0, enc0))
