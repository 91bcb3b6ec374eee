"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; skips where ``torch.cuda.is_available()`` is false (CUDA
kernels have no CPU mode). The repository's ``tests/conftest.py`` imports
jax, which a GPU host running only the port need not have, so run these
there with:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Small shapes (2 x 16^3 and 8^3 volumes); ``chip_smoke.py`` repeats the
comparisons at the serving path's full shapes. Tolerances are those of
``medseg_torch.kernels.kernel_check``.
"""

import pytest
import torch

from medseg_torch.kernels import conv_of, kernel_check

pytestmark = pytest.mark.cuda

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # fp32 references in full fp32 (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@DTYPES
def test_kernels_match_plain(device, dtype):
    cases = kernel_check.kernel_cases(device, dtype, batch=2, full=16)
    results = [kernel_check.run_case(case, dtype) for case in cases]
    bad = [r for r in results if not r["ok"]]
    assert not bad, bad


def test_each_wrapper_counts_its_launches(device):
    cases = kernel_check.kernel_cases(device, torch.float32, batch=1, full=16)
    conv_of.reset_launches()
    for case in cases:
        case.kernel(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in conv_of.KERNELS}
    assert counts == {
        "conv3x3x3_of": 5, "conv3x3x3_of_cat2": 1, "conv3x3x3_of_combine": 2, "outhead_of": 1,
    }


def test_wrapper_raises_instead_of_falling_back(device):
    x = torch.randn(1, 16, 8, 8, 8, device=device)
    w = torch.randn(16, 16, 3, 3, 3, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        conv_of.conv3x3x3_of(x.transpose(2, 3), w)
    with pytest.raises(ValueError, match="C_out"):
        conv_of.conv3x3x3_of(x, torch.randn(8, 16, 3, 3, 3, device=device))
    with pytest.raises(ValueError, match="dtype"):
        conv_of.conv3x3x3_of(x.half(), w.half())


@pytest.mark.parametrize("c_in", [1, 4])
def test_fused_forward_matches_module(device, c_in):
    from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights
    from medseg_torch.models.unetr import UNETR, init_weights

    g = torch.Generator().manual_seed(0)
    model = UNETR(in_channels=c_in, out_channels=3, img_size=(32, 32, 32), feature_size=16,
                  hidden_size=24, mlp_dim=48, num_heads=4, num_layers=4)
    model = init_weights(model, g).to(device).eval()
    x = torch.randn((2, c_in, 32, 32, 32), generator=g).to(device)
    scale = torch.rand((2, 1, 32, 32, 32), generator=g).to(device)
    with torch.no_grad():
        ref = model(x, return_encoder_features=False) * scale
    got = fast_apply_v3(model, x, fused_weights(model), out_scale=scale)
    assert got.shape == (2, 8, 32, 32, 32)
    err = (got[:, :3] - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    assert err < 1e-3  # fp32 chain: sums in another order than cuDNN's
