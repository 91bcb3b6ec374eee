"""The port's device augmentation (``medseg_torch.ops.augment``) against the
JAX package's (``medseg.ops.augment``).

torch and jax draw different random numbers, so each transform is held to
the JAX one at fixed decisions (each flip axis, rot90 by k = 1, 2, 3, an
intensity shift, and all of them chained), bitwise, on the transposed
layouts: JAX works on one channels-last (D, H, W, C) sample and rotates in
its (0, 1) plane, the port on (C, D, H, W) samples of a (B, C, D, H, W)
batch over dims (-3, -2). The draws are held to their probabilities by
frequency: over N = 4000 samples from a seeded generator each count lies
within 5 binomial standard deviations of N p (flips and rot90 p = 0.1,
shift p = 0.5, each k a third of the rotations), and the shifts' mean
within 5 standard errors of 0. Probability 0 is the identity; labels go
through the same flips and rotation as the image and never the shift.
``make_train_step(device_augment=True)`` takes a step on a tiny model whose
loss is the loss of the batch augmented from the state's generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.ops import augment as ja
from medseg_torch.engine.state import create_train_state
from medseg_torch.engine.train import make_loss_fn, make_train_step
from medseg_torch.models.unetr import UNETR
from medseg_torch.ops import augment as ta
from medseg_torch.ops.augment import Decision

N_DRAWS = 4000


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: these tensors are small, and under a
    parallel test run an 8-thread pool per worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sample(seed, c=2, shape=(6, 6, 5)):
    """One channels-last image and a 2-channel float label."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=shape + (c,)).astype(np.float32)
    label = (rng.random(shape + (2,)) > 0.5).astype(np.float32)
    return image, label


def _to_port(x):  # (D, H, W, C) -> (1, C, D, H, W)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 0)))[None]


def _to_jax_layout(t):  # (1, C, D, H, W) -> (D, H, W, C)
    return np.moveaxis(t[0].numpy(), 0, -1)


def _key_with_k(k, max_k=3):
    """A key whose ``_maybe_rot90`` draw is k (the JAX draw, found by seed)."""
    for seed in range(1000):
        key = jax.random.key(seed)
        _, kk = jax.random.split(key)
        if int(jax.random.randint(kk, (), 1, max_k + 1)) == k:
            return key
    raise AssertionError(k)


def _jax_shift_value(key, offsets=0.1):
    _, ks = jax.random.split(key)
    return float(jax.random.uniform(ks, (), minval=-offsets, maxval=offsets))


def _jax_chain(image, label, flips, k, shift_key):
    img, lab = jnp.asarray(image), jnp.asarray(label)
    for axis, flip in enumerate(flips):
        img, lab = ja._maybe_flip(jax.random.key(0), img, lab, axis, 1.0 if flip else 0.0)
    if k:
        img, lab = ja._maybe_rot90(_key_with_k(k), img, lab, 1.0, 3)
    if shift_key is not None:
        img = ja._maybe_shift(shift_key, img, 0.1, 1.0)
    return np.asarray(img), np.asarray(lab)


DECISIONS = {
    "flip_d": ((True, False, False), 0, False),
    "flip_h": ((False, True, False), 0, False),
    "flip_w": ((False, False, True), 0, False),
    "rot_k1": ((False, False, False), 1, False),
    "rot_k2": ((False, False, False), 2, False),
    "rot_k3": ((False, False, False), 3, False),
    "shift": ((False, False, False), 0, True),
    "all": ((True, True, True), 3, True),
}


@pytest.mark.parametrize("name", sorted(DECISIONS))
def test_fixed_decisions_match_jax(name):
    flips, k, shift = DECISIONS[name]
    image, label = _sample(1, shape=(6, 6, 5))
    shift_key = jax.random.key(5) if shift else None
    want_img, want_lab = _jax_chain(image, label, flips, k, shift_key)
    decision = Decision(flips=flips, k=k, shift=_jax_shift_value(shift_key) if shift else 0.0)
    got_img, got_lab = ta.apply_decisions(_to_port(image), _to_port(label), [decision])
    np.testing.assert_array_equal(_to_jax_layout(got_img), want_img)
    np.testing.assert_array_equal(_to_jax_layout(got_lab), want_lab)


def test_each_sample_takes_its_own_decision():
    images, labels = zip(*(_sample(s, shape=(4, 4, 3)) for s in (2, 3, 4)))
    decisions = [Decision(), Decision(flips=(False, True, False), k=2), Decision(shift=0.05)]
    got_img, got_lab = ta.apply_decisions(
        torch.cat([_to_port(x) for x in images]), torch.cat([_to_port(x) for x in labels]),
        decisions)
    for i, d in enumerate(decisions):
        want_img, want_lab = _jax_chain(images[i], labels[i], d.flips, d.k, None)
        np.testing.assert_array_equal(_to_jax_layout(got_img[i:i + 1]), want_img + np.float32(d.shift))
        np.testing.assert_array_equal(_to_jax_layout(got_lab[i:i + 1]), want_lab)


def test_draw_frequencies_match_the_probabilities():
    g = torch.Generator().manual_seed(0)
    decisions = [d for _ in range(4) for d in ta.draw_decisions(g, N_DRAWS // 4)]
    n = len(decisions)

    def within(count, p):
        return abs(count - n * p) <= 5 * np.sqrt(n * p * (1 - p))

    for axis in range(3):
        assert within(sum(d.flips[axis] for d in decisions), 0.1), axis
    rotated = [d.k for d in decisions if d.k]
    assert within(len(rotated), 0.1)
    for k in (1, 2, 3):
        count = rotated.count(k)
        assert abs(count - len(rotated) / 3) <= 5 * np.sqrt(len(rotated) * 2 / 9), (k, count)
    shifts = np.array([d.shift for d in decisions if d.shift])
    assert within(len(shifts), 0.5)
    assert np.abs(shifts).max() <= 0.1
    assert abs(shifts.mean()) <= 5 * (0.2 / np.sqrt(12)) / np.sqrt(len(shifts))
    # the same seed draws the same decisions
    again = ta.draw_decisions(torch.Generator().manual_seed(0), N_DRAWS // 4)
    assert again == decisions[: N_DRAWS // 4]


def test_probability_zero_is_the_identity():
    g = torch.Generator().manual_seed(1)
    image = torch.randn((3, 2, 5, 5, 4), generator=g)
    label = torch.randint(0, 3, (3, 1, 5, 5, 4), generator=g)
    out_img, out_lab = ta.augment_batch(g, image, label, flip_prob=0.0, rot_prob=0.0,
                                        shift_prob=0.0)
    assert torch.equal(out_img, image) and torch.equal(out_lab, label)
    assert out_lab.dtype == label.dtype


@pytest.mark.parametrize("label_dims", [4, 5])
def test_labels_follow_the_geometry(label_dims):
    """Flips and rotations move the label with the image (a label made from
    the image stays the same function of it); the shift leaves it alone."""
    g = torch.Generator().manual_seed(2)
    image = torch.randn((8, 1, 6, 6, 4), generator=g)
    label = (image > 0).to(torch.int32)
    if label_dims == 4:
        label = label[:, 0]
    out_img, out_lab = ta.augment_batch(g, image, label, flip_prob=0.5, rot_prob=0.5,
                                        shift_prob=0.0)
    assert out_lab.shape == label.shape and out_lab.dtype == label.dtype
    want = (out_img > 0).to(torch.int32)
    assert torch.equal(out_lab, want if label_dims == 5 else want[:, 0])
    assert not torch.equal(out_img, image)  # some sample moved
    shifted, same = ta.augment_batch(g, image, label, flip_prob=0.0, rot_prob=0.0,
                                     shift_prob=1.0)
    assert torch.equal(same, label)
    delta = (shifted - image).flatten(1)
    assert torch.allclose(delta, delta[:, :1].expand_as(delta), atol=1e-6)
    assert delta.abs().max() <= 0.1 + 1e-6


def test_rot90_needs_cubic_depth_and_height():
    image = torch.zeros((1, 1, 6, 5, 5))
    for k in (1, 2):
        with pytest.raises(ValueError, match="D == H"):
            ta.apply_decisions(image, image, [Decision(k=k)])
    with pytest.raises(ValueError, match="D == H"):
        ta.augment_batch(torch.Generator(), image, image)
    out, _ = ta.augment_batch(torch.Generator(), image, image, rot_prob=0.0)
    assert out.shape == image.shape


def test_scale_intensity_range_matches_jax():
    x = np.linspace(-400, 400, 97, dtype=np.float32).reshape(97, 1)
    for clip in (True, False):
        got = ta.scale_intensity_range_device(torch.from_numpy(x), clip=clip).numpy()
        want = np.asarray(ja.scale_intensity_range_device(jnp.asarray(x), clip=clip))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_train_step_with_device_augment():
    """One step on a tiny model: its loss is the loss of the batch that
    ``augment_batch`` makes from the state's generator, and the generator
    moves on."""
    model = UNETR(in_channels=1, out_channels=2, img_size=(16, 16, 16), feature_size=2,
                  hidden_size=16, mlp_dim=32, num_heads=2, num_layers=2)
    state = create_train_state(model, generator=torch.Generator().manual_seed(0),
                               learning_rate=1e-3, weight_decay=1e-5, device="cpu")
    g = torch.Generator().manual_seed(1)
    image = torch.randn((4, 1, 16, 16, 16), generator=g)
    label = (image > 0.3).to(torch.int64)
    step = make_train_step(model, task="ct", device_augment=True)
    twin = torch.Generator()  # replays the step's draws
    twin.set_state(state.generator.get_state())
    aug_img, aug_lab = ta.augment_batch(twin, image, label)
    with torch.no_grad():
        want = make_loss_fn("ct")(model, aug_img, aug_lab.to(torch.int32)).item()
    state, loss = step(state, {"image": image, "label": label})
    assert state.step == 1 and np.isfinite(loss.item())
    assert loss.item() == pytest.approx(want, rel=1e-6)
    assert torch.equal(state.generator.get_state(), twin.get_state())
