"""Shared CLI plumbing (counterpart of ``apply_overrides`` and
``build_model`` in ``medseg/cli/common.py``)."""

from __future__ import annotations

import dataclasses

import torch

from medseg_torch.models.unetr import UNETR


def apply_overrides(cfg, args):
    """Apply CLI model-size / data overrides onto the dataset preset."""
    model = cfg.model
    crop = args.crop_size if args.crop_size else model.crop_size
    model = dataclasses.replace(
        model,
        crop_size=crop,
        feature_size=args.feature_size,
        hidden_size=args.hidden_size,
        mlp_dim=args.mlp_dim,
        num_heads=args.num_heads,
        num_layers=args.num_layers,
        out_channels=args.n_classes,
    )
    data = dataclasses.replace(cfg.data, crop_size=crop, num_workers=args.num_workers)
    return cfg.replace(model=model, data=data)


def build_model(args, cfg, *, remat: bool = True) -> UNETR:
    """The UNETR of the (possibly overridden) model config; ``--bf16``
    selects the bf16 compute dtype. ``remat`` recomputes the stages in the
    backward pass (nothing at inference)."""
    m = cfg.model
    return UNETR(
        in_channels=m.in_channels,
        out_channels=m.out_channels,
        img_size=(m.crop_size,) * 3,
        feature_size=m.feature_size,
        hidden_size=m.hidden_size,
        mlp_dim=m.mlp_dim,
        num_heads=m.num_heads,
        num_layers=m.num_layers,
        dtype=torch.bfloat16 if args.bf16 else None,
        remat=remat,
    )
