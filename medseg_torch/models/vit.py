"""3D Vision Transformer encoder, NCDHW input (counterpart of
``medseg/models/vit.py``).

MONAI 0.6.0 ``ViT`` as the reference configures it: patch embedding
("perceptron": non-overlapping p^3 patches flattened channel-fastest, then one
Linear; or "conv": a Conv3d with kernel = stride = p) plus a learnable
positional embedding, no cls token; pre-LN transformer blocks (qkv without
bias, out projection with bias, MLP with exact erf GELU unless
``gelu_approx``); returns ``(LayerNorm(final), [every block's output])``.
Attention goes through ``F.scaled_dot_product_attention``, as the JAX side
uses plain ``jax.nn.dot_product_attention``. Parameter names follow MONAI's
(``patch_embedding.patch_embeddings.1``, ``blocks.{i}.attn.qkv``,
``blocks.{i}.mlp.linear1``, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
                 pos_embed: str = "perceptron", dropout_rate: float = 0.0) -> None:
        super().__init__()
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
        x = self.patch_embeddings(x)
        if self.pos_embed == "conv":
            x = x.flatten(2).transpose(1, 2)  # row-major over (d, h, w)
        return self.dropout(x + self.position_embeddings.to(x.dtype))


class SABlock(nn.Module):
    """MONAI SABlock contract: fused qkv (no bias), out projection (bias)."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, bias=False)
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, hid = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hid // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (b, heads, n, head_dim)
        y = F.scaled_dot_product_attention(q, k, v)
        y = y.transpose(1, 2).reshape(b, n, hid)
        return self.drop(self.out_proj(y))


class MLPBlock(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, dropout_rate: float = 0.0,
                 gelu_approx: bool = False) -> None:
        super().__init__()
        self.linear1 = nn.Linear(hidden_size, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, hidden_size)
        # torch nn.GELU default = exact erf (the parity contract); tanh is
        # the serving option of the JAX package's ``gelu_approx``
        self.approximate = "tanh" if gelu_approx else "none"
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop(F.gelu(self.linear1(x), approximate=self.approximate))
        return self.drop(self.linear2(y))


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (MONAI TransformerBlock contract)."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int,
                 dropout_rate: float = 0.0, gelu_approx: bool = False) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.attn = SABlock(hidden_size, num_heads, dropout_rate)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.mlp = MLPBlock(hidden_size, mlp_dim, dropout_rate, gelu_approx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """3D ViT encoder returning the final normed hidden plus all block outputs."""

    def __init__(self, in_channels: int, img_size, patch_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_layers: int = 12, num_heads: int = 12,
                 pos_embed: str = "perceptron", dropout_rate: float = 0.0,
                 gelu_approx: bool = False) -> None:
        super().__init__()
        self.patch_embedding = PatchEmbeddingBlock(
            in_channels, img_size, patch_size, hidden_size, pos_embed, dropout_rate
        )
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, mlp_dim, num_heads, dropout_rate, gelu_approx)
            for _ in range(num_layers)
        )
        self.norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        tokens = self.patch_embedding(x)
        hidden_states = []
        for blk in self.blocks:
            tokens = blk(tokens)
            hidden_states.append(tokens)
        return self.norm(tokens), hidden_states
