"""The port's ranking objectives (``medseg_torch.ops.ranking``) against the
JAX package's (``medseg.ops.ranking``) on the same numpy features.

Features are (4, D, H, W, C) for JAX and their NCDHW transpose for the port.
The gathers and the index samplers and tables are exact; the cosine matrix,
both losses and their gradients with respect to the features agree at rtol
1e-5 (fp32 on both sides, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.ops import ranking as jr
from medseg_torch.ops import ranking as tr

TEMP = 0.1


def _feats(seed: int, shape=(4, 8, 12, 16, 6)) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_gather_partition_slices_is_jax_gather(axis):
    feats = _feats(0)
    idx = np.asarray([0, 2, 4, 6], np.int32)
    want = np.asarray(jr.gather_partition_slices(jnp.asarray(feats), jnp.asarray(idx), axis))
    got = tr.gather_partition_slices(_ncdhw(feats), torch.from_numpy(idx).long(), axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_rejects_a_batch_other_than_four():
    with pytest.raises(ValueError, match="4, C, D, H, W"):
        tr.gather_partition_slices(torch.zeros(2, 3, 4, 4, 4), torch.zeros(4, dtype=torch.long), 0)


@pytest.mark.parametrize("dim,parts", [(8, 4), (12, 4), (96, 4), (7, 2), (32, 3)])
def test_index_samplers_draw_the_jax_numbers(dim, parts):
    for seed in range(5):
        np.testing.assert_array_equal(
            tr.sample_partition_indices(np.random.default_rng(seed), dim, parts),
            jr.sample_partition_indices(np.random.default_rng(seed), dim, parts))
        np.testing.assert_array_equal(
            tr.sample_half_indices(np.random.default_rng(seed), dim),
            jr.sample_half_indices(np.random.default_rng(seed), dim))


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_triplet_tables_equal(parts):
    for got, want in zip(tr.triplet_index_table(parts), jr.triplet_index_table(parts)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_pairwise_channel_cosine_matches():
    feats = _feats(1)
    idx = np.asarray([1, 3, 5, 7], np.int32)
    j = jr.pairwise_channel_cosine(jr.gather_partition_slices(jnp.asarray(feats), jnp.asarray(idx), 1))
    t = tr.pairwise_channel_cosine(tr.gather_partition_slices(_ncdhw(feats), torch.from_numpy(idx).long(), 1))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_cosine_clamps_each_norm():
    """A zero slice has cosine 0 with everything (each norm clamped at eps),
    where ``F.cosine_similarity`` would clamp the product of the norms."""
    slices = torch.zeros(1, 4, 2, 5)
    slices[0, 1:] = torch.randn(3, 2, 5)
    cos = tr.pairwise_channel_cosine(slices)
    assert torch.equal(cos[0], torch.zeros_like(cos[0]))
    torch.testing.assert_close(torch.diagonal(cos[1:, 1:]), torch.ones(2, 3))


@pytest.mark.parametrize("loss", ["bt", "info_nce"])
@pytest.mark.parametrize("parts,axis", [(4, 0), (4, 1), (4, 2), (2, 0)])
def test_losses_and_gradients_match_jax(loss, parts, axis):
    feats = _feats(2 + axis)
    rng = np.random.default_rng(7)
    dim = feats.shape[1 + axis]
    idx = (tr.sample_partition_indices(rng, dim, parts) if parts == 4
           else tr.sample_half_indices(rng, dim))
    j_loss = {"bt": jr.bt_ranking_loss, "info_nce": jr.info_nce_loss}[loss]
    t_loss = {"bt": tr.bt_ranking_loss, "info_nce": tr.info_nce_loss}[loss]

    def j_fn(f):
        cos = jr.pairwise_channel_cosine(jr.gather_partition_slices(f, jnp.asarray(idx), axis))
        return j_loss(cos, parts, TEMP)

    want, want_grad = jax.value_and_grad(j_fn)(jnp.asarray(feats))
    f = _ncdhw(feats).requires_grad_(True)
    got = t_loss(tr.pairwise_channel_cosine(
        tr.gather_partition_slices(f, torch.from_numpy(idx).long(), axis)), parts, TEMP)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.moveaxis(np.asarray(want_grad), -1, 1),
                               rtol=1e-5, atol=1e-5 * float(np.abs(want_grad).max()))


def test_bt_loss_orders_similarity():
    """Lower loss when the views of a partition are truly similar."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(1, 6, 8, 8, 8)).astype(np.float32)
    similar = torch.from_numpy(np.concatenate(
        [base + 0.01 * rng.normal(size=base.shape).astype(np.float32) for _ in range(4)]))
    random = torch.from_numpy(rng.normal(size=(4, 6, 8, 8, 8)).astype(np.float32))
    idx = torch.tensor([0, 2, 4, 6])
    losses = [tr.bt_ranking_loss(tr.pairwise_channel_cosine(tr.gather_partition_slices(f, idx, 0)),
                                 4, TEMP) for f in (similar, random)]
    assert losses[0] < losses[1]
