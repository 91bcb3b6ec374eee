"""The port's pretraining engine (``medseg_torch.engine.pretrain``) against
the JAX package's, at the same weights (``state_dict_from_flax``).

The tiny UNETR of ``tests/test_engine.py`` (feature size 4, hidden 24, 4
layers, crop 32), fp32, a batch of 4 numpy volumes, lr 1e-3.
``conv3d.OF_MIN_HW`` is lowered so that the decoder's 3x3x3 convs run through
the port's autograd Function (its plain versions on the CPU), as in
``tests/test_torch_train.py``. A feat step then a recon step on one state,
for both losses: the loss 1e-4 relative; every parameter (the ViT's, which
the recon stage freezes, included) 1e-4 absolute after each step, except
for at most one element in a thousand of a leaf. AdamW's first steps move
each element by about lr whatever its gradient's size, so an element whose
true gradient is rounding noise (it happens in a few per leaf) may step the
other way on one side: every element is held to 2 * lr per step, which
bounds that. A parameter that was not stepped at all (a frozen encoder
whose moments still move it, a decoder that weight decay shrinks in the
feat stage) would have all its elements off by ~7e-4. The leaves whose true
gradient an instance norm cancels to 0 are noise throughout and are held
to the 2 * lr bound only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.engine.pretrain import make_pretrain_step as j_make_step
from medseg.engine.state import create_train_state as j_create_state
from medseg.models.unetr import UNETR as JUNETR
from medseg_torch.engine import pretrain as tp
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.engine.state import create_train_state
from medseg_torch.kernels import conv3d
from medseg_torch.models.unetr import UNETR
from test_torch_train import NORM_CANCELLED

TINY = dict(in_channels=1, out_channels=2, img_size=(32, 32, 32), feature_size=4, hidden_size=24,
            mlp_dim=48, num_heads=4, num_layers=4, patch_size=16)
LR, WD, TEMP, P = 1e-3, 1e-5, 0.1, 4


@pytest.fixture(scope="module")
def setup():
    model = JUNETR(**TINY)
    images = np.random.default_rng(0).normal(size=(4, 32, 32, 32, 1)).astype(np.float32)
    state = j_create_state(model, rng=jax.random.key(0), sample_input=jnp.asarray(images),
                           learning_rate=LR, weight_decay=WD)
    return model, state, images


@pytest.fixture(autouse=True)
def routed(monkeypatch):
    monkeypatch.setattr(conv3d, "OF_MIN_HW", 1)


def _port_state(params, **kw):
    return create_train_state(UNETR(**TINY, **kw), generator=torch.Generator().manual_seed(0),
                              learning_rate=LR, weight_decay=WD, device="cpu", params=params)


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("loss_type", ["ranking", "contrastive"])
def test_feat_then_recon_steps_match_jax(setup, loss_type):
    jmodel, jstate, images = setup
    state = _port_state(jstate.params)
    rng = np.random.default_rng(1)
    for n, (arc, axis) in enumerate((("feat", 1), ("recon", 2)), start=1):
        idx = tp.sample_partition_indices(rng, tp.feature_dim_for_axis(32, arc, axis), P)
        j_step = j_make_step(jmodel, update_arc=arc, loss_type=loss_type, num_partitions=P,
                             temperature=TEMP, donate=False)
        t_step = tp.make_pretrain_step(state.model, update_arc=arc, loss_type=loss_type,
                                       num_partitions=P, temperature=TEMP)
        jstate, j_loss = j_step(jstate, jnp.asarray(images), jnp.asarray(idx), axis=axis)
        state, t_loss = t_step(state, _ncdhw(images), idx, axis=axis)
        assert state.step == int(jstate.step) == n
        np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4, err_msg=arc)
        want = state_dict_from_flax(jax.tree_util.tree_map(np.array, jstate.params))
        for name, p in state.model.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            assert diff.max() <= 2 * LR * n, (arc, name, diff.max())
            if not NORM_CANCELLED.search(name):
                off = int((diff > 1e-4).sum())
                assert off <= max(1, diff.size // 1000), (arc, name, off, diff.size)


def test_recon_leaves_the_encoder_without_gradients(setup):
    _, jstate, images = setup
    model = _port_state(jstate.params).model
    loss_fn = tp.make_pretrain_loss(model, update_arc="recon", loss_type="ranking",
                                    num_partitions=P, temperature=TEMP)
    loss_fn(_ncdhw(images), torch.tensor([0, 8, 16, 24]), 0).backward()
    frozen = ("vit.", "encoder1.", "encoder2.", "encoder3.", "encoder4.")
    for name, p in model.named_parameters():
        if name.startswith(frozen):
            assert p.grad is None, name
        else:
            assert p.grad is not None and p.grad.abs().sum() > 0, name


@pytest.mark.parametrize("remat", [False, True])
def test_encoder_only_feat_forward_is_the_full_one(setup, remat):
    """``encoder4_features`` computes enc4 and its gradients exactly as the
    full forward does; the parameters it skips (the later ViT blocks, the
    final norm, the other encoders, the decoder) get no gradient."""
    _, jstate, images = setup
    x = _ncdhw(images)
    grads, feats = [], []
    for encoder_only in (True, False):
        model = _port_state(jstate.params, remat=remat).model
        enc4 = model.encoder4_features(x) if encoder_only else model(x)[0]
        feats.append(enc4.detach())
        slices = tp.gather_partition_slices(enc4, torch.tensor([0, 1, 2, 3]), 1)
        tp.bt_ranking_loss(tp.pairwise_channel_cosine(slices), P, TEMP).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert torch.equal(feats[0], feats[1])
    # feat stage of the 4-layer model: enc4 taps block 3, the last one
    used = ("vit.patch_embedding.", "vit.blocks.", "encoder4.")
    for name, g in grads[1].items():
        if name.startswith(used):
            assert torch.equal(grads[0][name], g), name
        else:
            assert grads[0][name] is None and (g is None or not g.any()), name


def test_encoder_only_forward_stops_at_the_tapped_block():
    model = UNETR(**{**TINY, "num_layers": 8})
    seen = []
    for i, blk in enumerate(model.vit.blocks):
        blk.register_forward_hook(lambda m, a, out, i=i: seen.append(i))
    model.encoder4_features(torch.zeros(1, 1, 32, 32, 32))
    assert seen == list(range(7))  # hidden_states[3 * (8 // 4)] is block 6's output


def test_step_options_and_errors(setup):
    _, jstate, _ = setup
    state = _port_state(jstate.params)
    with pytest.raises(ValueError, match="update_arc"):
        tp.make_pretrain_step(state.model, update_arc="both", loss_type="ranking",
                              num_partitions=P, temperature=TEMP)
    with pytest.raises(ValueError, match="loss_type"):
        tp.make_pretrain_step(state.model, update_arc="feat", loss_type="mse",
                              num_partitions=P, temperature=TEMP)
    step = tp.make_pretrain_step(UNETR(**TINY), update_arc="feat", loss_type="ranking",
                                 num_partitions=P, temperature=TEMP)
    with pytest.raises(ValueError, match="another model"):
        step(state, torch.zeros(4, 1, 32, 32, 32), np.arange(4), axis=0)


def test_pretrain_epoch_cycles_the_axes(setup):
    _, jstate, images = setup
    state = _port_state(jstate.params)
    step = tp.make_pretrain_step(state.model, update_arc="feat", loss_type="ranking",
                                 num_partitions=P, temperature=TEMP)
    seen = []

    def batches(axis):
        seen.append(axis)
        return [{"image": _ncdhw(images)}, {"image": _ncdhw(images[:2])}]  # the second is skipped

    state, loss = tp.pretrain_epoch(step, state, batches, update_arc="feat", crop_size=32,
                                    num_partitions=P, rng=np.random.default_rng(0))
    assert seen == [0, 1, 2] and state.step == 3 and np.isfinite(loss)


def test_feature_dim_for_axis():
    assert tp.feature_dim_for_axis(96, "feat", 0) == 12
    assert tp.feature_dim_for_axis(96, "recon", 2) == 96


def test_convergence_tracker():
    t = tp.ConvergenceTracker(rtol=1e-2, window=3, max_iterations=100)
    for loss in [10.0, 5.0, 3.0]:
        t.update(loss)
        assert not t.converged
    t.update(6.0)  # mean(5, 3, 6) = 4.67, |4.67 - 6| = 1.33 > 0.0467
    assert not t.converged
    for _ in range(5):
        t.update(4.0)
    assert t.converged  # flat losses
    t2 = tp.ConvergenceTracker(max_iterations=2)
    t2.update(1.0)
    t2.update(100.0)
    assert t2.converged  # iteration cap
    t3 = tp.ConvergenceTracker(window=2)
    t3.update(0.0)
    t3.update(0.0)
    assert t3.converged  # a zero mean counts as converged


def test_convergence_tracker_resume_accounting():
    """A resumed stage carries the epochs it had consumed."""
    t = tp.ConvergenceTracker(rtol=1e-2, window=10, max_iterations=5)
    t.iterations = 5
    assert t.converged
    t2 = tp.ConvergenceTracker(rtol=1e-2, window=10, max_iterations=5)
    t2.iterations = 3
    assert not t2.converged
    t2.update(1.0)
    t2.update(1.0)
    assert t2.converged
