"""The library routes on the card (``chip_smoke.library_route``): each
launches none of the kernels it replaces and the default launches all of
them, and each library route's loss and gradients agree with the kernels'
at the training bounds (loss 1e-3 relative, global gradient 5e-2 relative
L2).

Marked ``cuda``; skips where ``torch.cuda.is_available()`` is false. Run on
the card (no JAX there) with:

    python -m pytest tests/test_torch_library_routes_cuda.py --noconftest -q

A bf16 UNETR at a 48^3 crop (feature size 16, a 4-layer ViT of width 48,
14 classes, batch 2): its full-resolution convs take K1 (enc1.conv1 on the
narrow-input kernel) and K6, its CT loss K7 and K8. ``chip_smoke.py``'s
routes phase runs the same library routes on config 5 and config 2.
"""

import pytest
import torch

import chip_smoke
from medseg_torch.engine.train import make_loss_fn
from medseg_torch.kernels import conv_of, loss_of
from medseg_torch.models.unetr import UNETR, init_weights

pytestmark = pytest.mark.cuda

LOSS_REL, GRAD_REL_L2 = 1e-3, 5e-2
K1, K6, K7, K8 = "conv3x3x3_of", "conv3x3x3_wgrad_of", "dice_ce_sums", "dice_ce_bwd"
RUNS = {  # run -> (the parts on the library, the kernels it must not launch)
    "convs": (("convs",), (K1, K6)),
    "wgrad": (("wgrad",), (K6,)),
    "loss": (("loss",), (K7, K8)),
    "all": (("convs", "wgrad", "loss"), (K1, K6, K7, K8)),
}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in conv_of.KERNELS + loss_of.KERNELS}


def _run(device, parts=()):
    """Loss, flattened gradient and kernel launches of one forward and
    backward with ``parts`` on the library, at weights and a batch from
    seed 0."""
    g = torch.Generator().manual_seed(0)
    model = UNETR(in_channels=1, out_channels=14, img_size=(48,) * 3, feature_size=16,
                  hidden_size=48, mlp_dim=96, num_heads=4, num_layers=4, dtype=torch.bfloat16)
    model = init_weights(model, g).to(device)
    image = torch.randn((2, 1, 48, 48, 48), generator=g).to(device)
    label = torch.randint(0, 14, (2, 48, 48, 48), generator=g, dtype=torch.int32).to(device)
    conv_of.reset_launches()
    loss_of.reset_launches()
    with chip_smoke.library_route(parts):
        loss = make_loss_fn("ct")(model, image, label)
        loss.backward()
        torch.cuda.synchronize()
    grad = torch.cat([p.grad.float().ravel() for p in model.parameters()])
    return loss.item(), grad, _launches()


@pytest.fixture(scope="module")
def default(device):
    return _run(device)


def test_default_launches_every_kernel_of_the_step(default):
    _, _, launches = default
    assert all(launches[k] > 0 for k in (K1, K6, K7, K8)), launches


@pytest.mark.parametrize("run", sorted(RUNS))
def test_library_route_replaces_its_kernels_within_the_training_bounds(device, default, run):
    parts, replaced = RUNS[run]
    loss_k, grad_k, launches_k = default
    loss, grad, launches = _run(device, parts)
    assert all(launches[k] == 0 for k in replaced), launches
    kept = [k for k in (K1, K6, K7, K8) if k not in replaced]
    # what a route does not replace runs as in the default: the data
    # gradient stays on K1 with the filter gradient on the library
    assert all(launches[k] == launches_k[k] for k in kept), (launches, launches_k)
    assert abs(loss - loss_k) / abs(loss_k) < LOSS_REL
    assert ((grad - grad_k).norm() / grad_k.norm()).item() < GRAD_REL_L2
