"""UNETR: ViT-encoded 3D U-Net, NCDHW (counterpart of ``medseg/models/unetr.py``).

Same topology contract: ViT encoder; decoder taps at ``num_layers // 4``
multiples plus the final normed output; encoder1 on the raw input,
encoder2/3/4 upsample the token grids by 8x/4x/2x; decoder5..decoder2
upsample and merge skips; 1x1x1 out head. ``proj_feat`` is a reshape plus a
permute to NCDHW.

``dtype`` is the compute dtype of the whole module, as in the flax module:
parameters stay fp32, every layer computes in ``dtype`` (norm statistics in
fp32) and the logits come out in it; it is also the kernels' operand type in
the fused serving forward (``medseg_torch.kernels.unetr_of.fast_apply_v3``).
Setting ``model.dtype`` sets it on every layer. ``remat`` recomputes stages
in the backward pass (``torch.utils.checkpoint``, non-reentrant), with the
JAX values: True / "all" every stage; "lowres" the ViT blocks and the
<= 24^3 stages, keeping the full-resolution activations; False none.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from medseg_torch.models.blocks import (
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrPrUpBlock,
    UnetrUpBlock,
)
from medseg_torch.models.vit import ViT


class UNETR(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 14,
        img_size: tuple[int, int, int] = (96, 96, 96),
        feature_size: int = 16,
        hidden_size: int = 768,
        mlp_dim: int = 3072,
        num_heads: int = 12,
        num_layers: int = 12,
        patch_size: int = 16,
        pos_embed: str = "perceptron",
        norm_name: str = "instance",
        res_block: bool = True,
        conv_block: bool = False,
        dropout_rate: float = 0.0,
        dtype: torch.dtype | None = None,
        remat: bool | str = False,
    ) -> None:
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError("dropout_rate should be between 0 and 1.")
        if hidden_size % num_heads != 0:
            raise ValueError("hidden size should be divisible by num_heads.")
        if pos_embed not in ("conv", "perceptron"):
            # same enum + exception class as the reference ctor
            raise KeyError(f"Position embedding layer of type {pos_embed} is not supported.")
        if conv_block:
            raise NotImplementedError(
                "conv_block=True (conv blocks between the encoder upsamplings) is not "
                "ported; every reference run uses False"
            )
        if remat not in (True, False, "all", "lowres"):
            raise ValueError(f"remat {remat!r} is not one of True, False, 'all', 'lowres'")
        if norm_name != "instance":
            # the fused serving kernels compute instance statistics; other
            # norms are rejected loudly rather than silently approximated
            raise ValueError(
                f"norm_name {norm_name!r} is not supported (only 'instance'; "
                "the kernel epilogues compute instance statistics)"
            )
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.img_size = tuple(img_size)
        self.feature_size = feature_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.patch_size = patch_size
        self.res_block = res_block
        self.remat_all = remat in (True, "all")
        self.remat_low = self.remat_all or remat == "lowres"
        self.feat_size = tuple(s // patch_size for s in self.img_size)
        self.vit = ViT(
            in_channels, self.img_size, patch_size, hidden_size, mlp_dim, num_layers,
            num_heads, pos_embed, dropout_rate, remat=bool(remat),
        )
        fs = feature_size
        self.encoder1 = UnetrBasicBlock(in_channels, fs, res_block=res_block)
        self.encoder2 = UnetrPrUpBlock(hidden_size, fs * 2, num_layer=2)
        self.encoder3 = UnetrPrUpBlock(hidden_size, fs * 4, num_layer=1)
        self.encoder4 = UnetrPrUpBlock(hidden_size, fs * 8, num_layer=0)
        self.decoder5 = UnetrUpBlock(hidden_size, fs * 8, res_block=res_block)
        self.decoder4 = UnetrUpBlock(fs * 8, fs * 4, res_block=res_block)
        self.decoder3 = UnetrUpBlock(fs * 4, fs * 2, res_block=res_block)
        self.decoder2 = UnetrUpBlock(fs * 2, fs, res_block=res_block)
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

    def proj_feat(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, N, hidden) -> (B, hidden, fd, fh, fw)."""
        b = tokens.shape[0]
        return tokens.reshape(b, *self.feat_size, self.hidden_size).permute(0, 4, 1, 2, 3)

    @staticmethod
    def _stage(module, remat: bool, *args):
        if remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def _encode(self, x_in: torch.Tensor):
        x, hidden_states = self.vit(x_in)
        q = self.num_layers // 4
        low, stage = self.remat_low, self._stage
        enc1 = stage(self.encoder1, self.remat_all, x_in)
        enc2 = stage(self.encoder2, low, self.proj_feat(hidden_states[1 * q]))
        enc3 = stage(self.encoder3, low, self.proj_feat(hidden_states[2 * q]))
        enc4 = stage(self.encoder4, low, self.proj_feat(hidden_states[3 * q]))
        return x, enc1, enc2, enc3, enc4

    def forward(
        self,
        x_in: torch.Tensor,
        *,
        freeze_encoder: bool = False,
        return_encoder_features: bool = True,
    ):
        """x_in: (B, C, D, H, W). Returns ``(enc4, logits)`` like the
        reference's local variant, or logits only with
        ``return_encoder_features=False``. ``freeze_encoder`` stops the
        gradient at the ViT output and the encoder taps (the six taps the
        JAX forward stops: x, enc1..enc4 and dec4); they are computed without
        autograd, which gives the same values and keeps no activations."""
        if freeze_encoder:
            with torch.no_grad():
                x, enc1, enc2, enc3, enc4 = self._encode(x_in)
        else:
            x, enc1, enc2, enc3, enc4 = self._encode(x_in)
        low, full, stage = self.remat_low, self.remat_all, self._stage
        dec3 = stage(self.decoder5, low, self.proj_feat(x), enc4)
        dec2 = stage(self.decoder4, low, dec3, enc3)
        dec1 = stage(self.decoder3, full, dec2, enc2)
        outf = stage(self.decoder2, full, dec1, enc1)
        logits = self.out(outf)
        if return_encoder_features:
            return enc4, logits
        return logits

    def encoder4_features(self, x_in: torch.Tensor) -> torch.Tensor:
        """enc4 alone: the ViT blocks up to the one whose output enc4 taps,
        then encoder4; the same values and gradients as ``forward``'s enc4,
        without the blocks after the tap, the final norm, the other
        encoders and the decoder (all that the feat stage's loss does not
        read)."""
        depth = 3 * (self.num_layers // 4) + 1
        tokens = self.vit.block_outputs(x_in, depth)[-1]
        return self._stage(self.encoder4, self.remat_low, self.proj_feat(tokens))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init drawn from ``generator`` alone: conv/linear kernels
    N(0, 1/fan_in) (flax's lecun scale), the positional embedding N(0, 0.02^2),
    biases 0 and norm scales 1."""
    for name, p in model.named_parameters():
        if name.endswith("position_embeddings"):
            std = 0.02
        elif p.ndim >= 2:
            std = (p.numel() / p.shape[0]) ** -0.5
        else:
            p.fill_(1.0 if ".norm" in name and name.endswith("weight") else 0.0)
            continue
        p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float32) * std)
    return model


def unetr_b16(
    in_channels: int, out_channels: int, crop_size: int, dtype: torch.dtype | None = None,
    remat: bool | str = False,
) -> UNETR:
    """The one configuration every reference run uses: ViT-B, feature_size 16."""
    return UNETR(
        in_channels=in_channels,
        out_channels=out_channels,
        img_size=(crop_size, crop_size, crop_size),
        feature_size=16,
        hidden_size=768,
        mlp_dim=3072,
        num_heads=12,
        res_block=True,
        dropout_rate=0.0,
        dtype=dtype,
        remat=remat,
    )
