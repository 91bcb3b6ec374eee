"""3D Vision Transformer encoder, NCDHW input (counterpart of
``medseg/models/vit.py``).

MONAI 0.6.0 ``ViT`` as the reference configures it: patch embedding
("perceptron": non-overlapping p^3 patches flattened channel-fastest, then one
Linear; or "conv": a Conv3d with kernel = stride = p) plus a learnable
positional embedding, no cls token; pre-LN transformer blocks (qkv without
bias, out projection with bias, MLP with exact erf GELU); returns
``(LayerNorm(final), [every block's output])``. Attention goes through
``F.scaled_dot_product_attention``, as the JAX side uses plain
``jax.nn.dot_product_attention``. Parameter names follow MONAI's
(``patch_embedding.patch_embeddings.1``, ``blocks.{i}.attn.qkv``,
``blocks.{i}.mlp.linear1``, ...).

``dtype`` is the compute dtype, as flax's ``dtype=`` on every Dense and
LayerNorm: parameters stay fp32, each Linear casts its input, weight and
bias to it; each LayerNorm takes fp32 statistics and returns ``dtype``.
``remat=True`` recomputes each transformer block in the backward pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from medseg_torch.models.blocks import compute_dtype


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``layer(x)`` in the compute dtype (flax ``Dense(dtype=...)``)."""
    dt = compute_dtype(dtype, x, layer.weight)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``layer(x)`` with statistics in at least fp32, returned in the compute
    dtype (flax ``LayerNorm(dtype=...)``)."""
    dt = compute_dtype(dtype, x, layer.weight)
    st = torch.promote_types(x.dtype, torch.float32)
    y = F.layer_norm(x.to(st), layer.normalized_shape, layer.weight.to(st), layer.bias.to(st),
                     layer.eps)
    return y.to(dt)


class _PatchRearrange(nn.Module):
    """``b c (h p1) (w p2) (d p3) -> b (h w d) (p1 p2 p3 c)``: tokens
    row-major over the patch grid, features channel-fastest."""

    def __init__(self, patch_size: int) -> None:
        super().__init__()
        self.patch_size = patch_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, d, h, w = x.shape
        p = self.patch_size
        x = x.reshape(b, c, d // p, p, h // p, p, w // p, p)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)
        return x.reshape(b, (d // p) * (h // p) * (w // p), p * p * p * c)


class PatchEmbeddingBlock(nn.Module):
    def __init__(self, in_channels: int, img_size, patch_size: int, hidden_size: int,
                 pos_embed: str = "perceptron", dropout_rate: float = 0.0,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        if any(s % patch_size for s in img_size):
            raise ValueError(f"volume {tuple(img_size)} not divisible by patch size {patch_size}")
        n = 1
        for s in img_size:
            n *= s // patch_size
        if pos_embed == "conv":
            self.patch_embeddings = nn.Conv3d(in_channels, hidden_size, patch_size, patch_size)
        else:
            self.patch_embeddings = nn.Sequential(
                _PatchRearrange(patch_size),
                nn.Linear(patch_size**3 * in_channels, hidden_size),
            )
        self.pos_embed = pos_embed
        self.position_embeddings = nn.Parameter(torch.zeros(1, n, hidden_size))
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pos_embed == "conv":
            conv = self.patch_embeddings
            dt = compute_dtype(self.dtype, x, conv.weight)
            x = F.conv3d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride)
            x = x.flatten(2).transpose(1, 2)  # row-major over (d, h, w)
        else:
            rearrange, proj = self.patch_embeddings
            x = linear(proj, rearrange(x), self.dtype)
        return self.dropout(x + self.position_embeddings.to(x.dtype))


class SABlock(nn.Module):
    """MONAI SABlock contract: fused qkv (no bias), out projection (bias)."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, bias=False)
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, hid = x.shape
        qkv = linear(self.qkv, x, self.dtype).reshape(b, n, 3, self.num_heads, hid // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (b, heads, n, head_dim)
        y = F.scaled_dot_product_attention(q, k, v)
        y = y.transpose(1, 2).reshape(b, n, hid)
        return self.drop(linear(self.out_proj, y, self.dtype))


class MLPBlock(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(hidden_size, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, hidden_size)
        # exact erf GELU (the parity contract); the tests set "tanh" to hold
        # the JAX package's ``gelu_approx``
        self.approximate = "none"
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop(F.gelu(linear(self.linear1, x, self.dtype), approximate=self.approximate))
        return self.drop(linear(self.linear2, y, self.dtype))


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (MONAI TransformerBlock contract)."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int,
                 dropout_rate: float = 0.0, dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.attn = SABlock(hidden_size, num_heads, dropout_rate, dtype)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.mlp = MLPBlock(hidden_size, mlp_dim, dropout_rate, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.norm1, x, self.dtype))
        return x + self.mlp(layer_norm(self.norm2, x, self.dtype))


class ViT(nn.Module):
    """3D ViT encoder returning the final normed hidden plus all block outputs."""

    def __init__(self, in_channels: int, img_size, patch_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_layers: int = 12, num_heads: int = 12,
                 pos_embed: str = "perceptron", dropout_rate: float = 0.0,
                 dtype: torch.dtype | None = None, remat: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.patch_embedding = PatchEmbeddingBlock(
            in_channels, img_size, patch_size, hidden_size, pos_embed, dropout_rate, dtype
        )
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, mlp_dim, num_heads, dropout_rate, dtype)
            for _ in range(num_layers)
        )
        self.norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def block_outputs(self, x: torch.Tensor, depth: int | None = None) -> list[torch.Tensor]:
        """The outputs of the first ``depth`` blocks (all by default)."""
        tokens = self.patch_embedding(x)
        hidden_states = []
        for blk in self.blocks[:depth]:
            if self.remat and torch.is_grad_enabled():
                tokens = checkpoint(blk, tokens, use_reentrant=False)
            else:
                tokens = blk(tokens)
            hidden_states.append(tokens)
        return hidden_states

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        hidden_states = self.block_outputs(x)
        return layer_norm(self.norm, hidden_states[-1], self.dtype), hidden_states
