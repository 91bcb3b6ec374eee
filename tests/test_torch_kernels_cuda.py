"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; skips where ``torch.cuda.is_available()`` is false (CUDA
kernels have no CPU mode). The repository's ``tests/conftest.py`` imports
jax, which a GPU host running only the port need not have, so run these
there with:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Small shapes (2 x 16^3 and 8^3 volumes; the tensor-core routes of K1, K2,
K5, K6 and K9 at a 9x17x18 volume, ragged against their 2x8x16 tile, and K5
and K9 also at 9x17x24, where W % 8 == 0 takes the asynchronous staging;
K3's at a 3x5x9 volume and K4's on windows at x-starts that differ mod 8, as
``tests/test_torch_outhead_tc.py`` emulates them on the CPU; K7 and K8 at
the ragged shapes of ``tests/test_torch_loss_vec.py``, on both routes, and
K7's sums bitwise from call to call);
``chip_smoke.py``
repeats the comparisons at the serving path's, the training step's and the
pretraining path's full shapes. Tolerances are those of
``medseg_torch.kernels.kernel_check``.
"""

import pytest
import torch

from medseg_torch.kernels import conv_flat, conv_of, kernel_check, loss_of

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


@DTYPES
def test_brats_shaped_kernels_match_plain(device, dtype):
    """The BraTS window's cases (four input channels, 8 padded classes, K4
    with a bf16 accumulator), cut to 16^3."""
    cases = kernel_check.brats_cases(device, dtype, batch=1, full=16)
    results = [kernel_check.run_case(case, dtype) for case in cases]
    bad = [r for r in results if not r["ok"]]
    assert not bad, bad


@DTYPES
def test_training_kernels_match_plain(device, dtype):
    cases = kernel_check.training_cases(device, dtype, batch=2, full=16)
    results = [kernel_check.run_case(case, dtype) for case in cases]
    bad = [r for r in results if not r["ok"]]
    assert not bad, bad


@DTYPES
def test_flat_kernel_matches_plain(device, dtype):
    """K9 at the flat route's shape and the JAX table's, cut to 16^3 and 8^3."""
    cases = kernel_check.flat_cases(device, dtype, batch=2, full=16)
    conv_flat.reset_launches()
    results = [kernel_check.run_case(case, dtype) for case in cases]
    bad = [r for r in results if not r["ok"]]
    assert not bad, bad
    assert conv_flat.conv3x3x3_flat.launches == len(cases)


def test_flat_kernel_raises_on_what_it_lacks(device):
    x = torch.randn(1, 16, 4, 8, 8, device=device)
    w = torch.randn(16, 16, 3, 3, 3, device=device)
    with pytest.raises(ValueError, match="C_out"):
        conv_flat.conv3x3x3_flat(x, torch.randn(8, 16, 3, 3, 3, device=device))
    with pytest.raises(ValueError, match="C=12"):
        conv_flat.conv3x3x3_flat(x[:, :12].contiguous(), w[:, :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        conv_flat.conv3x3x3_flat(x.transpose(3, 4), w)
    with pytest.raises(ValueError, match="dtype"):
        conv_flat.conv3x3x3_flat(x.half(), w.half())


def test_flat_route_step_launches_k9(device):
    """A tiny UNETR's recon-stage loss with the flat route forced on (the
    width threshold lowered): K9 runs the channel-reducing convs, forward and
    remat recompute, and the gradients match the same model without any
    route (cuDNN convs)."""
    import copy

    from medseg_torch.engine.pretrain import make_pretrain_loss
    from medseg_torch.kernels import conv3d
    from medseg_torch.models.unetr import UNETR, init_weights

    g = torch.Generator().manual_seed(2)
    model = init_weights(UNETR(in_channels=1, out_channels=3, img_size=(32, 32, 32),
                               feature_size=16, hidden_size=24, mlp_dim=48, num_heads=4,
                               num_layers=4, remat=True), g)
    x = torch.randn((4, 1, 32, 32, 32), generator=g).to(device)
    idx = torch.tensor([1, 9, 17, 25], device=device)
    saved = conv3d.PALLAS_PER_CONV, conv3d.FLAT_MIN_W, conv3d.OF_MIN_HW
    grads, losses = [], []
    try:
        for routed in (True, False):
            conv3d.PALLAS_PER_CONV, conv3d.FLAT_MIN_W = routed, 16
            conv3d.OF_MIN_HW = float("inf")  # K1 declines: the flat route's convs only
            m = copy.deepcopy(model).to(device)
            conv_flat.reset_launches()
            loss = make_pretrain_loss(m, update_arc="recon", loss_type="ranking",
                                      num_partitions=4, temperature=0.1)(x, idx, 0)
            loss.backward()
            # decoder2.conv1 (32 -> 16 at 32^3) and decoder3.conv1 (64 -> 32 at 16^3), x2
            assert conv_flat.conv3x3x3_flat.launches == (4 if routed else 0)
            losses.append(loss.item())
            grads.append({n: p.grad for n, p in m.named_parameters() if p.grad is not None})
    finally:
        conv3d.PALLAS_PER_CONV, conv3d.FLAT_MIN_W, conv3d.OF_MIN_HW = saved
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    num = sum((grads[0][n] - grads[1][n]).square().sum() for n in grads[1])
    den = sum(grads[1][n].square().sum() for n in grads[1])
    assert (num / den).sqrt().item() < 1e-3


def test_training_kernels_count_their_launches(device):
    cases = kernel_check.training_cases(device, torch.float32, batch=1, full=16)
    conv_of.reset_launches()
    loss_of.reset_launches()
    for case in cases:
        case.kernel(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in conv_of.KERNELS + loss_of.KERNELS}
    # fp32 takes the CUDA-core routes: K1's data gradient 16->32 is one
    # launch, 32->64 two 32-wide launches; K7 and K8 one each per loss case
    # (14 classes, 2 classes, a ragged volume), K7's two device kernels
    # counted as one
    assert counts == {
        "conv3x3x3_of": 3, "conv3x3x3_of_cat2": 0, "conv3x3x3_of_combine": 0, "outhead_of": 0,
        "outhead_row_of": 0, "conv3x3x3_wgrad_of": 6, "dice_ce_sums": 3, "dice_ce_bwd": 3,
    }


# K7 and K8 at the shapes that tests/test_torch_loss_vec.py emulates on the
# CPU: (B, K, (D, H, W)); V % 8 in {0, 3, 4, 7}, V below one block's share
LOSS_SHAPES = [(1, 14, (4, 8, 8)), (3, 2, (3, 3, 3)), (3, 16, (5, 5, 7)), (1, 1, (4, 9, 10)),
               (1, 2, (3, 4, 11)), (3, 14, (16, 16, 20)), (2, 5, (17, 17, 17))]


def _loss_inputs(device, dtype, bsz, k, shape, seed=5):
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn((bsz, k, *shape), generator=g) * 3.0).to(device, dtype)
    labels = torch.randint(0, k, (bsz, *shape), generator=g, dtype=torch.int32).to(device)
    coefs = (torch.randn((bsz, k), generator=g).to(device),
             torch.randn((bsz, k), generator=g).to(device),
             (torch.rand((bsz,), generator=g) + 0.5).to(device))
    return logits, labels, coefs


@DTYPES
@pytest.mark.parametrize("bsz,k,shape", LOSS_SHAPES,
                         ids=[f"B{b}-K{k}-{'x'.join(map(str, s))}" for b, k, s in LOSS_SHAPES])
def test_loss_kernels_match_plain_at_ragged_shapes(device, dtype, bsz, k, shape):
    """K7 and K8 on both routes (16-byte words where V % VEC == 0, one voxel
    at a time elsewhere) against their plain versions, with
    ``kernel_check``'s tolerances; a logits tensor that starts off 16 bytes
    takes the voxel route and gives the same results."""
    logits, labels, coefs = _loss_inputs(device, dtype, bsz, k, shape)
    loss_of.reset_launches()
    got, want = loss_of.dice_ce_sums(logits, labels), loss_of.dice_ce_sums_plain(logits, labels)
    for a, b in zip(got, want):
        assert kernel_check._rel_err(a, b) <= kernel_check.STATS_TOL
    dl = loss_of.dice_ce_bwd(logits, labels, *coefs)
    ref = loss_of.dice_ce_bwd_plain(logits, labels, *coefs)
    assert dl.dtype == dtype and kernel_check._rel_err(dl, ref) <= kernel_check.OUT_TOL[dtype]
    assert (loss_of.dice_ce_sums.launches, loss_of.dice_ce_bwd.launches) == (1, 1)
    shifted = torch.empty(logits.numel() + 1, dtype=dtype, device=device)[1:].view_as(logits)
    shifted.copy_(logits)
    assert not loss_of.vector_route(labels[0].numel(), dtype, shifted)
    for a, b in zip(loss_of.dice_ce_sums(shifted, labels), want):
        assert kernel_check._rel_err(a, b) <= kernel_check.STATS_TOL
    dl = loss_of.dice_ce_bwd(shifted, labels, *coefs)
    assert kernel_check._rel_err(dl, ref) <= kernel_check.OUT_TOL[dtype]


@DTYPES
def test_loss_sums_are_bitwise_reproducible(device, dtype):
    """Two K7 calls on the same inputs give the same bits: each block writes
    its partial sums and the finish adds them in block order (no atomics)."""
    logits, labels, _ = _loss_inputs(device, dtype, 2, 14, (32, 48, 48))
    first = [t.clone() for t in loss_of.dice_ce_sums(logits, labels)]
    second = loss_of.dice_ce_sums(logits, labels)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


TC_VOLUME = (9, 17, 18)  # ragged against the tensor-core kernels' 2x8x16 voxel tile


def _randn(g, *shape, scale=1.0):
    return torch.randn(shape, generator=g) * scale


@pytest.mark.parametrize("affine,residual", [(False, False), (True, False), (False, True),
                                             (True, True)], ids=["plain", "affine", "res",
                                                                 "affine-res"])
@pytest.mark.parametrize("c_in,c_out", [(16, 16), (16, 32), (32, 64), (64, 32), (64, 64),
                                        (48, 16)])
def test_tc_conv_matches_plain(device, c_in, c_out, affine, residual):
    """K1's tensor-core route (bf16, C_in % 16 == 0) against its plain
    version at a ragged volume, with the prologue and the residual tap."""
    g = torch.Generator().manual_seed(c_in * 100 + c_out)
    bf = torch.bfloat16
    x = _randn(g, 1, c_in, *TC_VOLUME).to(device, bf)
    w = _randn(g, c_out, c_in, 3, 3, 3, scale=(27 * c_in) ** -0.5).to(device, bf)
    args = [x, w]
    if affine:
        args += [(torch.rand((1, c_in), generator=g) + 0.5).to(device),
                 _randn(g, 1, c_in, scale=0.5).to(device)]
    kwargs = {"wres": _randn(g, c_out, c_in, 1, 1, 1, scale=c_in ** -0.5).to(device, bf)
              } if residual else {}
    case = kernel_check.Case("tc", conv_of.conv3x3x3_of, conv_of.conv3x3x3_of_plain, tuple(args),
                             kwargs)
    conv_of.reset_launches()
    r = kernel_check.run_case(case, bf)
    assert r["ok"], r
    assert conv_of.conv3x3x3_of.launches == conv_of.conv3x3x3_of.tc_launches == 1


@pytest.mark.parametrize("c,c_out", [(16, 16), (32, 16), (64, 32), (32, 64), (64, 64)])
def test_tc_wgrad_matches_plain(device, c, c_out):
    """K6's tensor-core route against its plain version at a ragged volume."""
    g = torch.Generator().manual_seed(c * 100 + c_out)
    bf = torch.bfloat16
    x = _randn(g, 2, c, *TC_VOLUME).to(device, bf)
    cot = _randn(g, 2, c_out, *TC_VOLUME).to(device, bf)
    case = kernel_check.Case("tc wgrad", conv_of.conv3x3x3_wgrad_of,
                             conv_of.conv3x3x3_wgrad_of_plain, (x, cot))
    conv_of.reset_launches()
    r = kernel_check.run_case(case, bf)
    assert r["ok"], r
    assert conv_of.conv3x3x3_wgrad_of.launches == conv_of.conv3x3x3_wgrad_of.tc_launches == 1


@pytest.mark.parametrize("c_in,c_out", [(16, 16), (32, 32), (64, 64)])
def test_tc_routes_walk_many_tiles(device, c_in, c_out):
    """675 tiles of 2x8x16 over three batch elements, more than the blocks
    of either tensor-core kernel: K1's persistent blocks cross batch
    elements (their statistics leave per element), at 64 -> 64 with the
    weights streamed slice by slice; K6's tile groups sum several tiles."""
    g = torch.Generator().manual_seed(c_in + c_out)
    bf = torch.bfloat16
    shape = (3, c_in, 30, 40, 33)
    x = _randn(g, *shape).to(device, bf)
    w = _randn(g, c_out, c_in, 3, 3, 3, scale=(27 * c_in) ** -0.5).to(device, bf)
    a = (torch.rand((3, c_in), generator=g) + 0.5).to(device)
    b = _randn(g, 3, c_in, scale=0.5).to(device)
    cot = _randn(g, 3, c_out, *shape[2:]).to(device, bf)
    assert conv_of.tc_tiles(shape) == 675
    conv_of.reset_launches()
    for case in (
        kernel_check.Case("tc", conv_of.conv3x3x3_of, conv_of.conv3x3x3_of_plain, (x, w, a, b)),
        kernel_check.Case("tc wgrad", conv_of.conv3x3x3_wgrad_of,
                          conv_of.conv3x3x3_wgrad_of_plain, (x, cot)),
    ):
        r = kernel_check.run_case(case, bf)
        assert r["ok"], r
    assert conv_of.conv3x3x3_of.tc_launches == conv_of.conv3x3x3_wgrad_of.tc_launches == 1


@pytest.mark.parametrize("mode,c,c_out,x_channels", [
    ("cat2", 64, 32, 0), ("combine", 32, 16, 1), ("combine", 32, 16, 16), ("combine", 64, 32, 1),
    ("combine", 64, 32, 32),
], ids=["cat2-64-32", "combine-32-16-x1", "combine-32-16-x16", "combine-64-32-x1",
        "combine-64-32-x32"])
def test_tc_two_stream_modes_match_plain(device, mode, c, c_out, x_channels):
    """K5 (cat2) and K2 (combine, x of 1 or C/2 channels) on the tensor-core
    route against their plain versions at a ragged volume, two batch
    elements (the statistics leave per element)."""
    g = torch.Generator().manual_seed(c * 100 + c_out + x_channels)
    bf = torch.bfloat16
    half = c // 2

    def vol(ch):
        return _randn(g, 2, ch, *TC_VOLUME).to(device, bf)

    def affine():
        return ((torch.rand((2, half), generator=g) + 0.5).to(device),
                _randn(g, 2, half, scale=0.5).to(device))

    w = _randn(g, c_out, c, 3, 3, 3, scale=(27 * c) ** -0.5).to(device, bf)
    wres = _randn(g, c_out, c, 1, 1, 1, scale=c ** -0.5).to(device, bf)
    if mode == "cat2":
        case = kernel_check.Case("tc cat2", conv_of.conv3x3x3_of_cat2,
                                 conv_of.conv3x3x3_of_cat2_plain, (vol(half), vol(half), w, wres))
    else:
        case = kernel_check.Case(
            "tc combine", conv_of.conv3x3x3_of_combine, conv_of.conv3x3x3_of_combine_plain,
            (vol(half), vol(half), vol(x_channels), *affine(), *affine(), w, wres))
    assert conv_of.tc_route(c, c_out, bf, mode)
    conv_of.reset_launches()
    r = kernel_check.run_case(case, bf)
    assert r["ok"], r
    assert case.kernel.launches == case.kernel.tc_launches == 1


ASYNC_VOLUME = (9, 17, 24)  # ragged against the tile, W % 8 == 0: the cp.async staging


@pytest.mark.parametrize("vol", [ASYNC_VOLUME, TC_VOLUME], ids=["async", "registers"])
@pytest.mark.parametrize("c,c_out", [(64, 32), (128, 64), (64, 64), (128, 32)])
def test_tc_cat2_stagings_match_plain(device, c, c_out, vol):
    """K5 on the tensor cores up to C = 128 at both stagings (cp.async where W
    % 8 == 0, registers otherwise), two batch elements, against its plain
    version; one tensor-core launch each."""
    g = torch.Generator().manual_seed(c * 10 + c_out + vol[2])
    bf = torch.bfloat16
    xa, xb = (_randn(g, 2, c // 2, *vol).to(device, bf) for _ in range(2))
    w = _randn(g, c_out, c, 3, 3, 3, scale=(27 * c) ** -0.5).to(device, bf)
    wres = _randn(g, c_out, c, 1, 1, 1, scale=c ** -0.5).to(device, bf)
    assert conv_of.tc_staging("cat2", vol[2]) == (vol == ASYNC_VOLUME)
    case = kernel_check.Case("tc cat2", conv_of.conv3x3x3_of_cat2, conv_of.conv3x3x3_of_cat2_plain,
                             (xa, xb, w, wres))
    conv_of.reset_launches()
    r = kernel_check.run_case(case, bf)
    assert r["ok"], r
    assert case.kernel.launches == case.kernel.tc_launches == 1


@pytest.mark.parametrize("vol", [ASYNC_VOLUME, TC_VOLUME, (5, 12, 20)],
                         ids=["async", "registers", "registers-w20"])
@pytest.mark.parametrize("c,c_out", [(128, 64), (32, 16), (64, 32), (16, 64)])
def test_tc_flat_matches_plain(device, c, c_out, vol):
    """K9 on the tensor cores (mode FLAT: fp32 out, no statistics) at both
    stagings against its plain version; one tensor-core launch each."""
    g = torch.Generator().manual_seed(c + c_out + vol[2])
    bf = torch.bfloat16
    x = _randn(g, 2, c, *vol).to(device, bf)
    w = _randn(g, c_out, c, 3, 3, 3, scale=(27 * c) ** -0.5).to(device, bf)
    case = kernel_check.Case("tc flat", conv_flat.conv3x3x3_flat, conv_flat.conv3x3x3_flat_plain,
                             (x, w))
    conv_flat.reset_launches()
    r = kernel_check.run_case(case, bf)
    assert r["ok"], r
    assert conv_flat.conv3x3x3_flat.launches == conv_flat.conv3x3x3_flat.tc_launches == 1


def test_async_routes_walk_many_tiles(device):
    """K5 (32+32)->32 (two groups per block, resident weights) and K9
    128->64 (one group, weights streamed over 8 slices) over 675 tiles of
    three batch elements with the cp.async staging: the groups cross batch
    elements (K5's statistics leave per element)."""
    g = torch.Generator().manual_seed(7)
    bf = torch.bfloat16
    vol = (30, 40, 40)
    assert conv_of.tc_tiles((3, 1, *vol)) == 3 * 15 * 5 * 3
    xa, xb = (_randn(g, 3, 32, *vol).to(device, bf) for _ in range(2))
    w5 = _randn(g, 32, 64, 3, 3, 3, scale=(27 * 64) ** -0.5).to(device, bf)
    wres = _randn(g, 32, 64, 1, 1, 1, scale=64 ** -0.5).to(device, bf)
    x = _randn(g, 3, 128, *vol).to(device, bf)
    w9 = _randn(g, 64, 128, 3, 3, 3, scale=(27 * 128) ** -0.5).to(device, bf)
    conv_of.reset_launches()
    conv_flat.reset_launches()
    for case in (
        kernel_check.Case("tc cat2", conv_of.conv3x3x3_of_cat2, conv_of.conv3x3x3_of_cat2_plain,
                          (xa, xb, w5, wres)),
        kernel_check.Case("tc flat", conv_flat.conv3x3x3_flat, conv_flat.conv3x3x3_flat_plain,
                          (x, w9)),
    ):
        r = kernel_check.run_case(case, bf)
        assert r["ok"], r
    assert conv_of.conv3x3x3_of_cat2.tc_launches == conv_flat.conv3x3x3_flat.tc_launches == 1


def test_async_staging_raises_on_a_misaligned_input(device):
    """The cp.async staging needs each stream to start at a 16-byte boundary: a
    view two bytes in raises, it does not take the other route."""
    bf = torch.bfloat16
    n = 2 * 32 * 8 * 8 * 16
    x = torch.randn(n + 1, device=device).to(bf)[1:].view(2, 32, 8, 8, 16)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.randn(16, 32, 3, 3, 3, device=device).to(bf)
    with pytest.raises(ValueError, match="16-byte"):
        conv_flat.conv3x3x3_flat(x, w)
    conv_flat.conv3x3x3_flat(x.clone(), w)  # the aligned copy launches


def test_tc_two_stream_modes_walk_many_tiles(device):
    """K2 with a 1-channel x over 675 tiles of three batch elements: the
    persistent blocks cross batch elements and both streams."""
    g = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    vol = (30, 40, 33)
    up, y = (_randn(g, 3, 16, *vol).to(device, bf) for _ in range(2))
    x1 = _randn(g, 3, 1, *vol).to(device, bf)
    aff = [(torch.rand((3, 16), generator=g) + 0.5).to(device) if i % 2 == 0
           else _randn(g, 3, 16, scale=0.5).to(device) for i in range(4)]
    w = _randn(g, 16, 32, 3, 3, 3, scale=(27 * 32) ** -0.5).to(device, bf)
    wres = _randn(g, 16, 32, 1, 1, 1, scale=32 ** -0.5).to(device, bf)
    case = kernel_check.Case("tc combine", conv_of.conv3x3x3_of_combine,
                             conv_of.conv3x3x3_of_combine_plain, (up, y, x1, *aff, w, wres))
    conv_of.reset_launches()
    r = kernel_check.run_case(case, bf)
    assert r["ok"], r
    assert conv_of.conv3x3x3_of_combine.tc_launches == 1


def test_routes_count_tc_launches(device):
    """bf16 with C_in % 16 == 0 takes the tensor cores, one launch even at
    64 output channels; fp32 and C_in = 1 take the CUDA cores (64 wide: two
    launches). K5 and K2 take the tensor cores in bf16 at the decoder's
    widths (K5 up to C = 128, feature size 32), the CUDA cores in fp32; K9
    takes them in bf16 at C % 16 == 0, the CUDA cores in fp32 and at C =
    24."""
    def conv(c_in, c_out, dtype):
        x = torch.randn(1, c_in, 4, 8, 8, device=device, dtype=dtype)
        conv_of.conv3x3x3_of(x, torch.randn(c_out, c_in, 3, 3, 3, device=device, dtype=dtype))

    def wgrad(c, c_out, dtype):
        x = torch.randn(1, c, 4, 8, 8, device=device, dtype=dtype)
        conv_of.conv3x3x3_wgrad_of(x, torch.randn(1, c_out, 4, 8, 8, device=device, dtype=dtype))

    def rand(*shape, dtype):
        return torch.randn(*shape, device=device, dtype=dtype)

    def cat2(c_in, c_out, dtype):
        h = c_in // 2
        conv_of.conv3x3x3_of_cat2(
            rand(1, h, 4, 8, 8, dtype=dtype), rand(1, h, 4, 8, 8, dtype=dtype),
            rand(c_out, c_in, 3, 3, 3, dtype=dtype), rand(c_out, c_in, 1, 1, 1, dtype=dtype))

    def combine(c_in, c_out, dtype):
        h = c_in // 2
        aff = [torch.rand(1, h, device=device) for _ in range(4)]
        conv_of.conv3x3x3_of_combine(
            rand(1, h, 4, 8, 8, dtype=dtype), rand(1, h, 4, 8, 8, dtype=dtype),
            rand(1, 1, 4, 8, 8, dtype=dtype), *aff, rand(c_out, c_in, 3, 3, 3, dtype=dtype),
            rand(c_out, c_in, 1, 1, 1, dtype=dtype))

    def flat(c_in, c_out, dtype):
        conv_flat.conv3x3x3_flat(rand(1, c_in, 4, 8, 8, dtype=dtype),
                                 rand(c_out, c_in, 3, 3, 3, dtype=dtype))

    k1, k6 = conv_of.conv3x3x3_of, conv_of.conv3x3x3_wgrad_of
    k9 = conv_flat.conv3x3x3_flat
    k5, k2 = conv_of.conv3x3x3_of_cat2, conv_of.conv3x3x3_of_combine
    bf, f32 = torch.bfloat16, torch.float32
    for fn, wrapper, c_in, c_out, dtype, launches, tc in (
        (conv, k1, 16, 16, bf, 1, 1), (conv, k1, 16, 16, f32, 1, 0), (conv, k1, 1, 16, bf, 1, 0),
        (conv, k1, 32, 64, bf, 1, 1), (conv, k1, 32, 64, f32, 2, 0),
        (wgrad, k6, 16, 16, bf, 1, 1), (wgrad, k6, 16, 16, f32, 1, 0), (wgrad, k6, 1, 16, bf, 1, 0),
        (wgrad, k6, 32, 64, bf, 1, 1), (wgrad, k6, 32, 64, f32, 2, 0),
        (cat2, k5, 64, 32, bf, 1, 1), (cat2, k5, 64, 32, f32, 1, 0), (cat2, k5, 128, 64, bf, 1, 1),
        (cat2, k5, 128, 64, f32, 2, 0), (cat2, k5, 128, 32, bf, 1, 1),
        (flat, k9, 128, 64, bf, 1, 1), (flat, k9, 32, 16, bf, 1, 1), (flat, k9, 128, 64, f32, 1, 0),
        (flat, k9, 24, 16, bf, 1, 0),
        (combine, k2, 32, 16, bf, 1, 1), (combine, k2, 64, 32, bf, 1, 1),
        (combine, k2, 32, 16, f32, 1, 0),
    ):
        conv_of.reset_launches()
        conv_flat.reset_launches()
        fn(c_in, c_out, dtype)
        assert (wrapper.launches, wrapper.tc_launches) == (launches, tc), (c_in, c_out, dtype)
    torch.cuda.synchronize()


def test_training_step_matches_the_step_without_kernels(device):
    """The tiny UNETR's loss and gradients through the kernels (fp32, the
    32^3 and 16^3 convs routed through K1/K6, the loss through K7/K8) against
    the same model on the same card without them (cuDNN convs, the autograd
    loss): only the kernels differ, in summation order."""
    import copy

    from medseg_torch.engine.train import make_loss_fn
    from medseg_torch.kernels import conv3d
    from medseg_torch.models.unetr import UNETR, init_weights
    from medseg_torch.ops.losses import dice_ce_loss

    g = torch.Generator().manual_seed(0)
    model = init_weights(UNETR(in_channels=1, out_channels=3, img_size=(32, 32, 32),
                               feature_size=16, hidden_size=24, mlp_dim=48, num_heads=4,
                               num_layers=4, remat=True), g)
    x = torch.randn((2, 1, 32, 32, 32), generator=g).to(device)
    y = torch.randint(0, 3, (2, 32, 32, 32), generator=g, dtype=torch.int32).to(device)
    route_min_hw = conv3d.OF_MIN_HW
    grads, losses = [], []
    try:
        for routed in (True, False):
            conv3d.OF_MIN_HW = 16 * 16 if routed else float("inf")
            m = copy.deepcopy(model).to(device)
            conv_of.reset_launches()
            loss_of.reset_launches()
            if routed:
                loss = make_loss_fn("ct")(m, x, y)
            else:
                logits = m(x, return_encoder_features=False)
                loss = dice_ce_loss(logits, y, softmax=True, to_onehot_y=True)
            loss.backward()
            launched = conv_of.conv3x3x3_wgrad_of.launches + loss_of.dice_ce_bwd.launches
            assert (launched > 0) == routed
            losses.append(loss.item())
            grads.append({n: p.grad for n, p in m.named_parameters()})
    finally:
        conv3d.OF_MIN_HW = route_min_hw
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    num = sum((grads[0][n] - grads[1][n]).square().sum() for n in grads[1])
    den = sum(grads[1][n].square().sum() for n in grads[1])
    assert (num / den).sqrt().item() < 1e-4


def test_each_wrapper_counts_its_launches(device):
    cases = kernel_check.kernel_cases(device, torch.float32, batch=1, full=16)
    conv_of.reset_launches()
    for case in cases:
        case.kernel(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in conv_of.KERNELS}
    # K4: one launch per case (six windows each: fp32 and bf16 accumulators,
    # and the row with an x-start off 8 voxels); K5: (32+32)->32 once,
    # (64+64)->64 as two 32-wide launches in fp32
    assert counts == {
        "conv3x3x3_of": 5, "conv3x3x3_of_cat2": 3, "conv3x3x3_of_combine": 2, "outhead_of": 1,
        "outhead_row_of": 3, "conv3x3x3_wgrad_of": 0,
    }


# K4's windows on the CPU emulation's shapes (tests/test_torch_outhead_tc.py):
# 3x4x13 at x-starts 0, 7, 19, 32 (mod 8: 0, 7, 3, 0) in a 5x8x45 accumulator
ROW_ROI, ROW_ACC = (3, 4, 13), (5, 8, 45)
ROW_STARTS = [(0, 0, 0), (0, 2, 7), (1, 0, 19), (2, 3, 32)]


def _head_args(g, device, bsz, c, k, vol, dtype=torch.bfloat16):
    """z, res, the four affines, head, bias and blend weight of K3/K4."""
    def aff():
        return [(torch.rand((bsz, c), generator=g) + 0.5).to(device),
                _randn(g, bsz, c, scale=0.5).to(device)]

    return (_randn(g, bsz, c, *vol).to(device, dtype), _randn(g, bsz, c, *vol).to(device, dtype),
            *aff(), *aff(), _randn(g, k, c, scale=c**-0.5).to(device, dtype),
            _randn(g, k, scale=0.1).to(device), torch.rand((bsz, 1, *vol), generator=g).to(device))


def _covered(starts, roi, shape):
    mask = torch.zeros(shape, dtype=torch.bool)
    for d, h, w in starts:
        mask[d : d + roi[0], h : h + roi[1], w : w + roi[2]] = True
    return mask


@pytest.mark.parametrize("c,k", [(16, 8), (16, 16), (32, 32), (48, 16), (64, 32)])
@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "unscaled"])
def test_tc_outhead_matches_plain(device, c, k, scaled):
    """K3's tensor-core route at a ragged volume (V = 3x5x9 = 135: a ragged
    last segment, channel planes off 16-byte boundaries)."""
    g = torch.Generator().manual_seed(c * 100 + k)
    args = _head_args(g, device, 2, c, k, (3, 5, 9))
    case = kernel_check.Case("tc outhead", conv_of.outhead_of, conv_of.outhead_of_plain,
                             args if scaled else args[:-1])
    conv_of.reset_launches()
    r = kernel_check.run_case(case, torch.bfloat16)
    assert r["ok"], r
    assert conv_of.outhead_of.launches == conv_of.outhead_of.tc_launches == 1


@pytest.mark.parametrize("c,k", [(16, 16), (16, 8), (32, 32), (32, 16)])
@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16], ids=["acc-fp32", "acc-bf16"])
def test_tc_outhead_row_matches_plain(device, c, k, acc_dtype):
    """K4's tensor-core route on windows at x-starts that differ mod 8 in an
    accumulator whose rows are not a multiple of 8; the voxels no window
    covers keep their bits."""
    g = torch.Generator().manual_seed(c * 100 + k + 1)
    args = _head_args(g, device, len(ROW_STARTS), c, k, ROW_ROI)
    acc = _randn(g, k, *ROW_ACC).to(device, acc_dtype)
    starts = torch.tensor(ROW_STARTS, dtype=torch.int32)
    case = kernel_check.Case(
        "tc outhead row", conv_of.outhead_row_of, conv_of.outhead_row_of_plain,
        (*args, starts, acc), inplace=10,
        out_tol=kernel_check.OUT_TOL[acc_dtype] if acc_dtype == torch.bfloat16 else None)
    conv_of.reset_launches()
    r = kernel_check.run_case(case, torch.bfloat16)
    assert r["ok"], r
    assert conv_of.outhead_row_of.launches == conv_of.outhead_row_of.tc_launches == 1
    got = acc.clone()
    conv_of.outhead_row_of(*args, starts, got)
    off = ~_covered(ROW_STARTS, ROW_ROI, ROW_ACC).to(device)
    assert torch.equal(got[:, off], acc[:, off])


def test_tc_outhead_row_splits_large_batches(device):
    """18 windows of 2x2x9 along one row at x-starts 0, 2, ..., 34: two
    launches (16 + 2), both on the tensor cores, each rounding the bf16
    accumulator once."""
    g = torch.Generator().manual_seed(18)
    starts = [(0, 0, 2 * i) for i in range(18)]
    args = _head_args(g, device, 18, 16, 8, (2, 2, 9))
    acc = torch.zeros((8, 2, 2, 48), dtype=torch.bfloat16, device=device)
    case = kernel_check.Case("tc outhead row x18", conv_of.outhead_row_of,
                             conv_of.outhead_row_of_plain, (*args, starts, acc), inplace=10,
                             out_tol=kernel_check.OUT_TOL[torch.bfloat16])
    conv_of.reset_launches()
    r = kernel_check.run_case(case, torch.bfloat16)
    assert r["ok"], r
    assert conv_of.outhead_row_of.launches == conv_of.outhead_row_of.tc_launches == 2


def test_tc_outhead_reads_inputs_at_any_alignment(device):
    """z and res that start 2 bytes past a 16-byte boundary (contiguous views
    one element into their storage): the shifted loads of every item."""
    g = torch.Generator().manual_seed(5)
    args = list(_head_args(g, device, len(ROW_STARTS), 16, 16, ROW_ROI))
    for i in (0, 1):
        t = args[i]
        view = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:].view(t.shape)
        args[i] = view.copy_(t)
        assert args[i].data_ptr() % 16 == 2
    conv_of.reset_launches()
    r = kernel_check.run_case(kernel_check.Case(
        "tc outhead offset", conv_of.outhead_of, conv_of.outhead_of_plain, tuple(args)),
        torch.bfloat16)
    assert r["ok"], r
    acc = torch.zeros((16, *ROW_ACC), device=device)
    r = kernel_check.run_case(kernel_check.Case(
        "tc outhead row offset", conv_of.outhead_row_of, conv_of.outhead_row_of_plain,
        (*args, ROW_STARTS, acc), inplace=10), torch.bfloat16)
    assert r["ok"], r
    assert conv_of.outhead_of.tc_launches == conv_of.outhead_row_of.tc_launches == 1


@pytest.mark.parametrize("c,k,dtype,tc", [
    (16, 16, torch.bfloat16, True), (32, 8, torch.bfloat16, True),
    (16, 16, torch.float32, False), (24, 16, torch.bfloat16, False),
    (16, 24, torch.bfloat16, False),
])
def test_outhead_routes_count_tc_launches(device, c, k, dtype, tc):
    """bf16 at the route's widths takes the tensor cores; fp32, C % 16 != 0
    and K_pad 24 keep the kernels of outhead_of.cu and outhead_row_of.cu."""
    g = torch.Generator().manual_seed(c + k)
    args = _head_args(g, device, 2, c, k, (4, 6, 10), dtype)
    conv_of.reset_launches()
    conv_of.outhead_of(*args)
    conv_of.outhead_row_of(*args, [(0, 0, 0), (1, 2, 5)], torch.zeros((k, 5, 8, 16), device=device))
    torch.cuda.synchronize()
    assert (conv_of.outhead_of.launches, conv_of.outhead_row_of.launches) == (1, 1)
    assert conv_of.outhead_of.tc_launches == conv_of.outhead_row_of.tc_launches == int(tc)


def test_wrapper_raises_instead_of_falling_back(device):
    x = torch.randn(1, 16, 8, 8, 8, device=device)
    w = torch.randn(16, 16, 3, 3, 3, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        conv_of.conv3x3x3_of(x.transpose(2, 3), w)
    with pytest.raises(ValueError, match="C_out"):
        conv_of.conv3x3x3_of(x, torch.randn(8, 16, 3, 3, 3, device=device))
    with pytest.raises(ValueError, match="dtype"):
        conv_of.conv3x3x3_of(x.half(), w.half())
    with pytest.raises(ValueError, match="C_out"):
        conv_of.conv3x3x3_wgrad_of(x, torch.randn(1, 8, 8, 8, 8, device=device))
    logits = torch.randn(1, 3, 8, 8, 8, device=device)
    labels = torch.zeros(1, 8, 8, 8, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="int32"):
        loss_of.dice_ce_sums(logits, labels.long())
    with pytest.raises(ValueError, match="contiguous"):
        loss_of.dice_ce_sums(logits.transpose(2, 3), labels)
    with pytest.raises(ValueError, match="dtype"):
        loss_of.dice_ce_sums(logits.half(), labels)
    with pytest.raises(ValueError, match="at most 16 classes"):
        loss_of.dice_ce_bwd(torch.randn(1, 17, 8, 8, 8, device=device), labels,
                            *(torch.zeros(1, 17, device=device),) * 2,
                            torch.ones(1, device=device))
    # K4: the accumulator's dtype, layout and extent are checked, never patched around
    z = torch.randn(2, 16, 8, 8, 8, device=device)
    aff = [torch.ones(2, 16, device=device)] * 4
    head = (torch.randn(8, 16, device=device), torch.zeros(8, device=device))
    scale = torch.rand(2, 1, 8, 8, 8, device=device)
    acc = torch.zeros(8, 8, 8, 16, device=device)
    args = (z, z, *aff, *head, scale, [(0, 0, 0), (0, 0, 8)])
    conv_of.outhead_row_of(*args, acc)  # the valid call launches
    with pytest.raises(ValueError, match="leaves the accumulator"):
        conv_of.outhead_row_of(z, z, *aff, *head, scale, [(0, 0, 0), (0, 0, 9)], acc)
    with pytest.raises(ValueError, match="accumulator dtype"):
        conv_of.outhead_row_of(*args, acc.half())
    with pytest.raises(ValueError, match="contiguous"):
        conv_of.outhead_row_of(*args, torch.zeros(8, 8, 16, 8, device=device).transpose(2, 3))
    with pytest.raises(ValueError, match="acc has shape"):
        conv_of.outhead_row_of(*args, torch.zeros(16, 8, 8, 16, device=device))
    with pytest.raises(ValueError, match="scale is on cpu"):
        conv_of.outhead_row_of(z, z, *aff, *head, scale.cpu(), args[-1], acc)


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


def test_fused_forward_accumulating_exit(device):
    """The accumulating exit (K4) adds what the logits exit (K3) returns,
    placed at the windows' starts."""
    from medseg_torch.kernels.unetr_of import fast_apply_v3, fused_weights
    from medseg_torch.models.unetr import UNETR, init_weights

    g = torch.Generator().manual_seed(1)
    model = UNETR(in_channels=1, out_channels=3, img_size=(32, 32, 32), feature_size=16,
                  hidden_size=24, mlp_dim=48, num_heads=4, num_layers=4)
    model = init_weights(model, g).to(device).eval()
    weights = fused_weights(model)
    x = torch.randn((4, 1, 32, 32, 32), generator=g).to(device)
    scale = torch.rand((4, 1, 32, 32, 32), generator=g).to(device)
    starts = [(0, 0, 0), (0, 16, 0), (0, 0, 16), (0, 16, 16)]
    acc = torch.zeros((8, 32, 48, 48), device=device)
    conv_of.reset_launches()
    assert fast_apply_v3(model, x, weights, out_scale=scale, starts=starts, acc=acc) is None
    assert conv_of.outhead_row_of.launches == 1 and conv_of.outhead_of.launches == 0
    logits = fast_apply_v3(model, x, weights, out_scale=scale).float()
    want = torch.zeros_like(acc)
    for (d, h, w), o in zip(starts, logits):
        want[:, d : d + 32, h : h + 32, w : w + 32] += o
    assert (acc - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("feature_size,wgrad_launches", [(8, 2), (24, 0)])
def test_widths_without_kernels_serve_and_train_through_the_library(device, feature_size,
                                                                    wgrad_launches):
    """A small UNETR at a feature size the kernels lack: the Validator serves
    it through the module forward (cuDNN), and in the training step only the
    convs whose widths the kernels have take them, the others the library
    conv; nothing raises. At feature size 8 those are decoder3's two convs
    at 24^3 (32 -> 16 and 16 -> 16): K6 once each, K1 three times each
    (forward, remat recompute, data gradient); at 24 none."""
    from medseg_torch.engine.evaluate import Validator
    from medseg_torch.engine.state import create_train_state
    from medseg_torch.engine.train import make_train_step
    from medseg_torch.kernels import conv3d
    from medseg_torch.models.unetr import UNETR, init_weights
    from medseg_torch.ops.sliding_window import SlidingWindowSpec, sliding_window_inference

    g = torch.Generator().manual_seed(feature_size)
    kw = dict(in_channels=1, out_channels=3, img_size=(48, 48, 48), feature_size=feature_size,
              hidden_size=24, mlp_dim=48, num_heads=4, num_layers=4, dtype=torch.bfloat16)
    model = init_weights(UNETR(**kw), g).to(device).eval()
    spec = SlidingWindowSpec(roi=(48, 48, 48), overlap=0.5, sw_batch=2, mode="gaussian")
    volume = torch.randn((64, 56, 72, 1), generator=g).numpy()
    conv_of.reset_launches()
    validator = Validator(model, 3, "ct", spec, device=device)
    assert not validator.use_fast_path
    got = validator.infer_volume(volume)
    with torch.no_grad():
        want = sliding_window_inference(
            volume, lambda w: model(w, return_encoder_features=False), 3, spec, device=device)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())

    model = UNETR(**{**kw, "remat": True})
    state = create_train_state(model, generator=g, learning_rate=1e-4, weight_decay=1e-5,
                               device=device)
    batch = {"image": torch.randn((2, 1, 48, 48, 48), generator=g).to(device),
             "label": torch.randint(0, 3, (2, 48, 48, 48), generator=g,
                                    dtype=torch.int32).to(device)}
    route_min_hw = conv3d.OF_MIN_HW
    conv3d.OF_MIN_HW = 16 * 16  # every conv at >= 16^2 asks the route
    try:
        state, loss = make_train_step(model, task="ct")(state, batch)
    finally:
        conv3d.OF_MIN_HW = route_min_hw
    torch.cuda.synchronize()
    assert torch.isfinite(loss).all()
    launched = {fn.__name__: fn.launches for fn in conv_of.KERNELS}
    assert launched == {"conv3x3x3_of": 3 * wgrad_launches, "conv3x3x3_of_cat2": 0,
                        "conv3x3x3_of_combine": 0, "outhead_of": 0, "outhead_row_of": 0,
                        "conv3x3x3_wgrad_of": wgrad_launches}, launched


@DTYPES
def test_mri_training_kernels_match_plain(device, dtype):
    """The BraTS step's C_in = 4 cases (K1 4->16 and K6 at C = 4, CUDA
    cores), cut to 16^3."""
    cases = kernel_check.mri_training_cases(device, dtype, batch=1, full=16)
    results = [kernel_check.run_case(case, dtype) for case in cases]
    bad = [r for r in results if not r["ok"]]
    assert not bad, bad


def _scipy_hausdorff(pred, target):
    """The host version: edges by binary erosion (outside the array is
    background), scipy's exact distance transform."""
    from scipy import ndimage

    cross = ndimage.generate_binary_structure(3, 1)
    edges = [m & ~ndimage.binary_erosion(m, cross, border_value=0) for m in (pred, target)]
    if not edges[0].any() or not edges[1].any():
        return float("nan")
    d_pt = ndimage.distance_transform_edt(~edges[1])[edges[0]]
    d_tp = ndimage.distance_transform_edt(~edges[0])[edges[1]]
    return float(max(d_pt.max(), d_tp.max()))


def test_device_hausdorff_matches_the_host_version(device):
    """The exact device search at 160^3: two overlapping blobs (a sphere and
    a box with scattered voxels), one touching the border."""
    from medseg_torch.ops.metrics import hausdorff_distance

    g = torch.Generator().manual_seed(0)
    z, y, x = torch.meshgrid(*(torch.arange(160),) * 3, indexing="ij")
    sphere = ((z - 70) ** 2 + (y - 80) ** 2 + (x - 90) ** 2) < 45**2
    box = torch.zeros((160, 160, 160), dtype=torch.bool)
    box[100:160, 30:120, 40:110] = True
    box |= torch.rand((160, 160, 160), generator=g) < 1e-4
    want = _scipy_hausdorff(sphere.numpy(), box.numpy())
    got = hausdorff_distance(sphere.to(device), box.to(device))
    assert got == pytest.approx(want, abs=1e-5)
    assert got == pytest.approx(hausdorff_distance(sphere, box), abs=0)


def test_augment_batch_on_the_card_equals_the_cpu_result(device):
    """The same decisions on the card and on the CPU give the same bits."""
    from medseg_torch.ops.augment import Decision, apply_decisions

    g = torch.Generator().manual_seed(1)
    image = torch.randn((4, 1, 24, 24, 20), generator=g)
    label = torch.randint(0, 14, (4, 1, 24, 24, 20), generator=g)
    decisions = [Decision(flips=(True, False, True), k=1, shift=0.07),
                 Decision(k=2), Decision(flips=(False, True, False), k=3, shift=-0.03),
                 Decision()]
    want_img, want_lab = apply_decisions(image, label, decisions)
    got_img, got_lab = apply_decisions(image.to(device), label.to(device), decisions)
    assert torch.equal(got_img.cpu(), want_img) and torch.equal(got_lab.cpu(), want_lab)
