"""The port's training step and loop (``medseg_torch.engine``) against the
JAX package's, at the same weights (``state_dict_from_flax``).

The tiny UNETR of ``tests/test_engine.py`` (feature size 4, hidden 24, 4
layers, crop 32), fp32, batch 2, labels ``image > 0``. ``conv3d.OF_MIN_HW``
is lowered so that every 3x3x3 conv runs through the port's autograd
Function (its plain versions, on the CPU), as the JAX tests force their
routing on. Tolerances: the loss 1e-4 relative; each leaf's gradient 1e-4
relative L2, except the leaves an instance norm cancels, held to 1e-4 of
the largest gradient instead: the conv biases in front of a norm and
encoder1.conv3's 1x1 weights on the one-channel image (the norm keeps only
their sign) have a true gradient of 0, and a decoder's transpose-conv bias
keeps only the zero padding's border effect through the block's norms, so
their relative errors are rounding noise of either side. Parameters
after AdamW steps agree within 2 * lr * steps (those noise-level gradients
become updates of up to lr).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medseg.engine.state import create_train_state as j_create_state
from medseg.engine.train import make_train_step as j_make_step
from medseg.models.unetr import UNETR as JUNETR
from medseg.ops.losses import dice_ce_loss as j_dice_ce
from medseg_torch.engine import train as ttrain
from medseg_torch.engine.checkpoint import state_dict_from_flax
from medseg_torch.engine.state import adamw, create_train_state
from medseg_torch.kernels import conv3d, conv_of
from medseg_torch.models.unetr import UNETR
from medseg_torch.ops.sliding_window import SlidingWindowSpec

TINY = dict(in_channels=1, out_channels=2, img_size=(32, 32, 32), feature_size=4, hidden_size=24,
            mlp_dim=48, num_heads=4, num_layers=4, patch_size=16)
LR, WD = 1e-3, 1e-5
NORM_CANCELLED = re.compile(
    r"(encoder1\.layer|conv_block)\.conv[123]\.conv\.bias|encoder1\.layer\.conv3\.conv\.weight"
    r"|decoder\d\.transp_conv\.conv\.bias"
)


@pytest.fixture(scope="module")
def setup():
    model = JUNETR(**TINY)
    rng = np.random.default_rng(0)
    image = rng.normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
    label = (image[..., 0] > 0).astype(np.int32)
    state = j_create_state(model, rng=jax.random.key(0), sample_input=jnp.asarray(image),
                           learning_rate=LR, weight_decay=WD)
    return model, state, image, label


@pytest.fixture(autouse=True)
def routed(monkeypatch):
    monkeypatch.setattr(conv3d, "OF_MIN_HW", 1)


def _port_state(params, **kw):
    model = UNETR(**TINY, **kw)
    return create_train_state(model, generator=torch.Generator().manual_seed(0),
                              learning_rate=LR, weight_decay=WD, device="cpu", params=params)


def _batch(image, label):
    return {"image": torch.from_numpy(np.moveaxis(image, -1, 1).copy()),
            "label": torch.from_numpy(label)}


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_loss_and_gradients_match_jax(setup, monkeypatch):
    jmodel, jstate, image, label = setup

    def loss_fn(params):
        logits = jmodel.apply(params, jnp.asarray(image), return_encoder_features=False)
        return j_dice_ce(logits, jnp.asarray(label), softmax=True, to_onehot_y=True)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.array, j_grads))

    wgrads = []
    wgrad = conv_of.conv3x3x3_wgrad_of
    monkeypatch.setattr(conv_of, "conv3x3x3_wgrad_of",
                        lambda *a: wgrads.append(1) or wgrad(*a))
    state = _port_state(jstate.params)
    batch = _batch(image, label)
    loss = ttrain.make_loss_fn("ct")(state.model, batch["image"], batch["label"].int())
    loss.backward()
    assert len(wgrads) == 10  # every 3x3x3 conv (2 per res block) went through K6's wrapper
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    got = _grads(state.model)
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        if NORM_CANCELLED.search(name):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale, err_msg=name)
        else:
            assert _rel_l2(g.numpy(), w) < 1e-4, name


def test_three_steps_match_jax(setup):
    jmodel, jstate, image, label = setup
    j_step = j_make_step(jmodel, task="ct", donate=False)
    jb = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    state = _port_state(jstate.params)
    step = ttrain.make_train_step(state.model, task="ct")
    tb = _batch(image, label)
    j_losses, t_losses = [], []
    for _ in range(3):
        jstate, jl = j_step(jstate, jb)
        state, tl = step(state, tb)
        j_losses.append(float(jl))
        t_losses.append(tl.item())
    assert state.step == 3 and int(jstate.step) == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.array, jstate.params))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * LR * 3, err_msg=name)


@pytest.mark.parametrize("remat", [True, "lowres"])
def test_remat_gives_the_same_gradients(setup, monkeypatch, remat):
    _, jstate, image, label = setup
    batch = _batch(image, label)
    calls = []
    conv = conv_of.conv3x3x3_of
    monkeypatch.setattr(conv_of, "conv3x3x3_of", lambda *a, **k: calls.append(1) or conv(*a, **k))
    grads, counts = [], []
    for r in (False, remat):
        calls.clear()
        state = _port_state(jstate.params, remat=r)
        ttrain.make_loss_fn("ct")(state.model, batch["image"], batch["label"].int()).backward()
        grads.append(_grads(state.model))
        counts.append(len(calls))
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-9, msg=name)
    # the recompute re-runs the routed forward convs (all of them with "all",
    # those of the <= 24^3 stages with "lowres")
    assert counts[1] > counts[0]


def test_adamw_matches_optax():
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in ((5, 4), (7,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params] for _ in range(4)]
    tx = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
    j_params = [jnp.asarray(p) for p in params]
    opt_state = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = adamw(t_params, LR, 0.1)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for p, x in zip(t_params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for p, jp in zip(t_params, j_params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def _loop_state(setup):
    _, jstate, image, label = setup
    state = _port_state(jstate.params)
    return state, ttrain.make_train_step(state.model, task="ct"), _batch(image, label)


def _forever(batch):
    while True:
        yield batch


def test_train_loop_tracks_best(setup):
    state, step, batch = _loop_state(setup)
    metrics = iter([0.3, 0.5, 0.4])
    saved = []

    class Checkpointer:
        def save(self, st, *, name="best", metrics=None):
            saved.append((name, st.step, metrics))

        def wait(self):
            saved.append(("wait", None, None))

    loop = ttrain.TrainLoop(step, max_iterations=6, eval_num=2, validator=lambda s: next(metrics),
                            checkpointer=Checkpointer(), log_fn=lambda s: None,
                            save_latest_every=3)
    state = loop.run(state, _forever(batch))
    assert loop.best_metric == pytest.approx(0.5)
    assert loop.best_step == 4
    assert len(loop.loss_history) == 6 and state.step == 6
    assert saved == [("best", 2, {"dice": 0.3}), ("latest", 3, None), ("best", 4, {"dice": 0.5}),
                     ("latest", 6, None), ("wait", None, None)]


def test_train_loop_sync_every_keeps_the_history(setup):
    """``sync_every > 1`` changes only when the host reads the losses back."""
    histories, seen = [], []
    for sync_every in (1, 4):
        state, step, batch = _loop_state(setup)
        loop = ttrain.TrainLoop(step, max_iterations=7, eval_num=100, log_fn=lambda s: None,
                                sync_every=sync_every,
                                progress=lambda s, t, l: seen.append((s, t)))
        loop.run(state, _forever(batch))
        histories.append(loop.loss_history)
    assert len(histories[0]) == len(histories[1]) == 7
    np.testing.assert_allclose(histories[0], histories[1], rtol=1e-6)
    assert seen[-1] == (7, 7)


def test_validator_scores_the_current_weights(setup):
    state, _, _ = _loop_state(setup)
    rng = np.random.default_rng(5)
    volume = {"image": rng.normal(size=(40, 36, 32, 1)).astype(np.float32),
              "label": (rng.uniform(size=(40, 36, 32)) > 0.5).astype(np.int64)}
    spec = SlidingWindowSpec(roi=(32, 32, 32), overlap=0.25, sw_batch=2, mode="gaussian")
    validate = ttrain.make_validator(lambda: [volume], 2, "ct", spec, device="cpu")
    first = validate(state)
    assert state.model.training
    with torch.no_grad():  # push every voxel to class 1
        state.model.out.conv.conv.bias.copy_(torch.tensor([-50.0, 50.0]))
    second = validate(state)
    assert second != first
    assert second == pytest.approx(validate(state))
    assert state.model.training


def test_create_train_state_draws_from_the_generator():
    states = [create_train_state(UNETR(**TINY), generator=torch.Generator().manual_seed(s),
                                 learning_rate=LR, weight_decay=WD, device="cpu")
              for s in (1, 1, 2)]
    p = [dict(s.model.named_parameters())["encoder1.layer.conv1.conv.weight"] for s in states]
    torch.testing.assert_close(p[0], p[1], rtol=0, atol=0)
    assert not torch.equal(p[0], p[2])
    assert states[0].step == 0 and states[0].model.training


def test_mri_step_runs(setup):
    _, jstate, image, _ = setup
    state = _port_state(jstate.params)
    step = ttrain.make_train_step(state.model, task="mri")
    target = torch.from_numpy(np.stack([image[..., 0] > 0, image[..., 0] <= 0], 1).astype(np.float32))
    state, loss = step(state, {"image": _batch(image, image[..., 0])["image"], "label": target})
    assert loss.dtype == torch.float32 and np.isfinite(loss.item()) and state.step == 1


def test_step_options_and_errors(setup):
    state, _, _ = _loop_state(setup)
    with pytest.raises(NotImplementedError, match="augment"):
        ttrain.make_train_step(state.model, device_augment=True)
    with pytest.raises(ValueError, match="task"):
        ttrain.make_train_step(state.model, task="brats")
    step = ttrain.make_train_step(UNETR(**TINY))
    with pytest.raises(ValueError, match="another model"):
        step(state, {"image": torch.zeros(1), "label": torch.zeros(1)})
