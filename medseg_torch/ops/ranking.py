"""Ranking-based self-supervised pretraining objectives (counterpart of
``medseg/ops/ranking.py``).

Per step there are only ``P*G`` distinct slices (P=4 partitions x G=4 views
= 16): all of them are gathered in one ``index_select`` on the sliced axis,
one (16, 16, C) channelwise cosine matrix is computed in one einsum
(`pairwise_channel_cosine`), and the losses index it with a static triplet
table (`triplet_index_table`, a numpy copy of the JAX package's) and reduce.
Losses are pure: the caller takes the gradient and steps the optimizer.

Slice-view layout per partition (it defines the triplet indexing):
``[vol1_aug1, vol1_aug2, vol2_aug1, vol2_aug2]``, the order in which the
loader collates two volumes of two crops each.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

COS_EPS = 1e-6  # torch.nn.CosineSimilarity(dim=-1, eps=1e-6) of the reference
GROUP = 4  # 2 volumes x 2 augmentations


def gather_partition_slices(
    feats: torch.Tensor, slice_indices: torch.Tensor, axis: int
) -> torch.Tensor:
    """Gather per-partition slices from a batch of 4 feature volumes.

    Args:
      feats: (4, C, D, H, W) — [vol1_aug1, vol1_aug2, vol2_aug1, vol2_aug2].
      slice_indices: (P,) int tensor on ``feats``' device — one slice index
        per partition (see `sample_partition_indices`).
      axis: spatial axis to slice: 0 (D), 1 (H) or 2 (W), tensor dim
        ``axis + 2``.

    Returns:
      (P, 4, C, S): per partition, per view, channels x the two other spatial
      axes flattened in order.
    """
    if feats.ndim != 5 or feats.shape[0] != GROUP:
        raise ValueError(f"expected (4, C, D, H, W) features, got {tuple(feats.shape)}")
    sl = torch.index_select(feats, axis + 2, slice_indices)  # (4, C, ..., P, ...)
    sl = sl.movedim(axis + 2, 0)  # (P, 4, C, s1, s2)
    p, g, c = sl.shape[:3]
    return sl.reshape(p, g, c, -1)


def sample_partition_indices(
    rng: np.random.Generator, dim_size: int, num_partitions: int
) -> np.ndarray:
    """One random offset shared by all partitions of size ``dim_size // P``
    (the reference's sampling rule)."""
    partition_size = dim_size // num_partitions
    init_idx = int(rng.integers(0, partition_size))
    return np.asarray(
        [init_idx + k * partition_size for k in range(num_partitions)], dtype=np.int32
    )


def sample_half_indices(rng: np.random.Generator, dim_size: int) -> np.ndarray:
    """The legacy 2-half rule: one slice drawn uniformly from the lower half
    of the axis and one, independently, from the upper half; with
    ``num_partitions=2`` the losses below then compute the legacy
    ``extract_triplets`` objective."""
    half = dim_size // 2
    low = int(rng.integers(0, half))
    high = half + int(rng.integers(0, dim_size - half))
    return np.asarray([low, high], dtype=np.int32)


@lru_cache(maxsize=None)
def triplet_index_table(num_partitions: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (ref, sim, dissim) flat-slice indices in the reference's
    enumeration order. Flat index = partition * 4 + view. For each partition:
    all ordered pairs of its 4 views (12 permutations) crossed with every
    view of every other partition -> P * 12 * (P-1)*4 triplets (576 at
    P=4)."""
    refs, sims, dissims = [], [], []
    for p in range(num_partitions):
        own = [p * GROUP + g for g in range(GROUP)]
        others = [
            q * GROUP + g
            for q in range(num_partitions)
            if q != p
            for g in range(GROUP)
        ]
        for (r, s), d in itertools.product(itertools.permutations(own, 2), others):
            refs.append(r)
            sims.append(s)
            dissims.append(d)
    return (
        np.asarray(refs, dtype=np.int32),
        np.asarray(sims, dtype=np.int32),
        np.asarray(dissims, dtype=np.int32),
    )


@lru_cache(maxsize=None)
def _device_table(num_partitions: int, device: torch.device):
    """The triplet table and the dissimilar-list counts as tensors on
    ``device``, copied there once."""
    r, s, d = triplet_index_table(num_partitions)
    counts = np.bincount(d, minlength=num_partitions * GROUP).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (r.astype(np.int64),
                                                            s.astype(np.int64),
                                                            d.astype(np.int64), counts))


def pairwise_channel_cosine(slices: torch.Tensor) -> torch.Tensor:
    """All-pairs channelwise cosine similarity in one einsum.

    Args:
      slices: (P, 4, C, S) from `gather_partition_slices`.
    Returns:
      (P*4, P*4, C) fp32: ``cos[a, b, c] = <x_a[c], x_b[c]> / (|x_a[c]| |x_b[c]|)``,
      each norm clamped to >= eps (not ``F.cosine_similarity``'s clamp).
    """
    p, g, c, s = slices.shape
    x = slices.reshape(p * g, c, s).float()
    norms = torch.linalg.vector_norm(x, dim=-1).clamp_min(COS_EPS)
    xn = x / norms[..., None]
    return torch.einsum("acs,bcs->abc", xn, xn)


def bt_ranking_loss(cos: torch.Tensor, num_partitions: int, temperature: float) -> torch.Tensor:
    """Bradley-Terry ranking loss over the cosine matrix (paper Eq. 2):
    ``sum_triplets mean_c log(1 + exp(-(cos(ref,sim) - cos(ref,dissim)) / tau))``."""
    r, s, d, _ = _device_table(num_partitions, cos.device)
    comp = (cos[r, s] - cos[r, d]) / temperature  # (T, C)
    return F.softplus(-comp).mean(dim=-1).sum()


def info_nce_loss(cos: torch.Tensor, num_partitions: int, temperature: float) -> torch.Tensor:
    """Global contrastive (InfoNCE) baseline over the same triplet table.

    For every (ref, sim) entry the reference's denominator sums
    ``exp(cos(ref, dissim_j) / tau)`` over the whole dissimilar list plus the
    numerator; each slice k occurs ``counts[k]`` times in that list, so the
    denominator is ``sum_k counts[k] * exp(cos[ref, k] / tau)``.
    """
    r, s, _, counts = _device_table(num_partitions, cos.device)
    if counts.shape[0] != cos.shape[0]:
        raise ValueError(f"cosine matrix of {cos.shape[0]} slices for {num_partitions} partitions")
    sim_logits = cos[r, s] / temperature  # (T, C)
    numerator = torch.exp(sim_logits)
    denom_by_ref = torch.einsum("k,akc->ac", counts, torch.exp(cos / temperature))
    log_ratio = sim_logits - torch.log(denom_by_ref[r] + numerator)
    return (-log_ratio.mean(dim=-1)).sum()
