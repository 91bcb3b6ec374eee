"""The blocks' instance norm (``medseg_torch.kernels.norm_of``, N1).

On the CPU: the plain forward is the unfused chain bit for bit (the affine
instance norm's equations, then the cast, the residual add and the leaky
ReLU as separate operations: alone, with the leaky ReLU, with the residual
add and the leaky ReLU), in fp32 and bf16; the closed-form plain backward
(dx, dresidual, dweight, dbias) against float64 autograd and ``gradcheck``;
``UnetResBlock`` and ``UnetBasicBlock`` outputs and gradients equal to the
unfused chain's; the kernels'
plane and chunk routes and an emulation of their chunk walk (every voxel
once, the moments merged without cancellation); one ``medseg.norm`` span a
norm, recompute included.

Marked ``cuda`` (skips without a card, where the kernels cannot run): the
kernels against the plain versions at the main path's shapes, a ragged plane
and an input off 16 bytes, fp32 and bf16, every epilogue, forward and
gradients; two calls bitwise equal; a capture and replay in a CUDA graph;
the ``launches`` counters. Run them on the card with

    python -m pytest tests/test_torch_norm_of.py --noconftest -q

This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from medseg_torch.kernels import kernel_check, norm_of
from medseg_torch.models import blocks
from medseg_torch.models import unetr as tunetr

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
# (leaky, residual) of the blocks' three calls: norm3, norm1, norm2
EPILOGUES = {"none": (False, False), "leaky": (True, False), "residual+leaky": (True, True)}
EPILOGUE = pytest.mark.parametrize("epilogue", sorted(EPILOGUES))


def _randn(g, *shape, scale=1.0, shift=0.0, dtype=torch.float32, device="cpu"):
    return (torch.randn(shape, generator=g) * scale + shift).to(device=device, dtype=dtype)


def _affine(g, c, device="cpu"):
    return ((torch.rand((c,), generator=g) + 0.5).to(device),
            _randn(g, c, scale=0.5, device=device))


def _unfused_norm(x, weight, bias, eps=blocks.NORM_EPS):
    """The affine instance norm alone, statistics in fp32, cast to x's dtype."""
    xf = x.float()
    dims = tuple(range(2, x.ndim))
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = y * weight.float().view(shape) + bias.float().view(shape)
    return y.to(x.dtype)


def _unfused_epilogue(x, weight, bias, leaky, residual):
    y = _unfused_norm(x, weight, bias)
    if residual is not None:
        y = y + residual
    return blocks.leaky_relu(y) if leaky else y


# ---------------------------------------------------------------------------
# CPU: the plain versions
# ---------------------------------------------------------------------------

@DTYPES
@EPILOGUE
def test_plain_forward_is_the_unfused_chain(dtype, epilogue):
    g = torch.Generator().manual_seed(1)
    leaky, res = EPILOGUES[epilogue]
    x = _randn(g, 2, 5, 6, 7, 5, scale=3.0, shift=1.5, dtype=dtype)
    r = _randn(g, *x.shape, dtype=dtype) if res else None
    norm = blocks.InstanceNorm(5)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(5, generator=g) + 0.5)
        norm.bias.copy_(torch.randn(5, generator=g))
    want = _unfused_epilogue(x, norm.weight, norm.bias, leaky, r)
    got = norm(x, leaky=leaky, residual=r)
    assert got.dtype == dtype and torch.equal(got, want)
    y, mean, rstd = norm_of.instance_norm_fwd(x, norm.weight, norm.bias, r, leaky)
    assert torch.equal(y, want) and mean.shape == rstd.shape == (2, 5)
    assert torch.equal(mean, x.float().mean(dim=(2, 3, 4)))


@EPILOGUE
def test_plain_backward_matches_float64_autograd(epilogue):
    g = torch.Generator().manual_seed(2)
    leaky, res = EPILOGUES[epilogue]
    f64 = torch.float64
    x = _randn(g, 2, 3, 4, 5, 3, scale=2.0, shift=0.5, dtype=f64).requires_grad_()
    r = _randn(g, *x.shape, dtype=f64).requires_grad_() if res else None
    w = (torch.rand(3, generator=g, dtype=f64) + 0.5).requires_grad_()
    b = torch.randn(3, generator=g, dtype=f64).requires_grad_()
    dy = torch.randn(x.shape, generator=g, dtype=f64)
    y, mean, rstd = norm_of.instance_norm_fwd_plain(x, w, b, r, leaky)
    inputs = [x, w, b] + ([r] if res else [])
    want = torch.autograd.grad(y, inputs, dy)
    dx, dr, dw, db = norm_of.instance_norm_bwd_plain(dy, x.detach(), None if r is None else
                                                     r.detach(), mean.detach(), rstd.detach(),
                                                     w.detach(), b.detach(), leaky)
    got = [dx, dw, db] + ([dr] if res else [])
    for name, a, e in zip(("dx", "dweight", "dbias", "dresidual"), got, want):
        assert a.dtype == f64 and a.shape == e.shape, name
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-12, msg=name)
    # the autograd Function on the CPU runs the plain forward and backward
    assert torch.autograd.gradcheck(
        lambda *t: norm_of.InstanceNormFn.apply(t[0], t[1], t[2], t[3] if res else None, leaky,
                                                blocks.NORM_EPS), tuple(inputs))


def _block(kind: str, dtype):
    g = torch.Generator().manual_seed(3)
    in_ch = 3 if kind == "res-down" else 4
    block = (blocks.UnetBasicBlock if kind == "basic" else blocks.UnetResBlock)(in_ch, 4, dtype)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.5 if p.ndim > 1 else 1.0))
    return block, torch.randn((2, in_ch, 6, 5, 7), generator=g)


def _unfused_block(block, x):
    n = lambda m, t: _unfused_norm(t, m.weight, m.bias)  # noqa: E731
    if isinstance(block, blocks.UnetBasicBlock):
        y = blocks.leaky_relu(n(block.norm1, block.conv1(x)))
        return blocks.leaky_relu(n(block.norm2, block.conv2(y)))
    y = blocks.leaky_relu(n(block.norm1, block.conv1(x)))
    y = n(block.norm2, block.conv2(y))
    r = n(block.norm3, block.conv3(x)) if block.downsample else x
    return blocks.leaky_relu(y + r)


@DTYPES
@pytest.mark.parametrize("kind", ["res-down", "res-same", "basic"])
def test_blocks_match_the_unfused_chain_on_the_cpu(kind, dtype):
    """Bitwise, gradients of the input and every weight included; bf16
    compute in ``res-same`` adds the fp32 input as its residual, which
    promotes the output to fp32 as before."""
    block, x = _block(kind, dtype)
    dy = torch.randn((2, 4, 6, 5, 7), generator=torch.Generator().manual_seed(4))
    outs, grads = [], []
    for fn in (block, lambda t: _unfused_block(block, t)):
        block.zero_grad()
        xi = x.clone().requires_grad_()
        out = fn(xi)
        out.backward(dy.to(out.dtype))
        outs.append(out)
        grads.append([xi.grad] + [p.grad.clone() for p in block.parameters()])
    want_dtype = torch.float32 if kind == "res-same" else dtype
    assert outs[0].dtype == want_dtype and torch.equal(outs[0], outs[1])
    for a, e in zip(*grads):
        assert torch.equal(a, e)


# ---------------------------------------------------------------------------
# CPU: the kernels' routes and chunk walk
# ---------------------------------------------------------------------------

def test_routes_by_plane_size():
    bf16, f32 = torch.bfloat16, torch.float32
    # one pass up to 64 KB a plane: the serving and BraTS decoder's <= 32^3 planes in bf16
    for edge, plane in ((3, True), (12, True), (24, True), (32, True), (48, False),
                        (96, False), (128, False)):
        assert norm_of.plane_route(edge**3, bf16) is plane
    assert norm_of.plane_route(24**3, f32) and not norm_of.plane_route(32**3, f32)
    assert [norm_of.plane_threads(e**3, bf16) for e in (3, 6, 12, 16, 24, 32)] == [
        32, 32, 64, 128, 512, 512]
    assert norm_of.chunk_elems(bf16) == 8192 and norm_of.chunk_elems(f32) == 4096
    assert [norm_of.n_chunks(e**3, bf16) for e in (12, 48, 96, 128)] == [1, 14, 108, 256]
    x = torch.zeros(2 * 16 * 8 + 8, dtype=bf16)
    assert norm_of.vector_route(128, bf16, x[:256]) and not norm_of.vector_route(
        128, bf16, x[1:257])
    assert not norm_of.vector_route(27, bf16, x) and norm_of.vector_route(28, f32, x.float()[4:])


def _chunk_voxels(n_vox: int, dtype, vec: bool) -> np.ndarray:
    """The voxel of every (chunk, thread, slot) as ``csrc/instnorm.cu``'s
    ``Chunk::voxel`` maps it, -1 past the chunk's end."""
    n, nt = norm_of.vec_of(dtype), norm_of.THREADS
    elems = norm_of.chunk_elems(dtype)
    c0 = np.arange(norm_of.n_chunks(n_vox, dtype))[:, None, None] * elems
    t = np.arange(nt)[None, :, None]
    k = np.arange(norm_of.WORDS * n)[None, None, :]
    at = c0 + ((k // n) * nt + t) * n + k % n if vec else c0 + k * nt + t
    return np.where(at < np.minimum(c0 + elems, n_vox), at, -1)


@DTYPES
@pytest.mark.parametrize("n_vox", [27, 216, 8192 + 5, 8192 * 3, 48**3, 97**3])
def test_chunk_walk_takes_every_voxel_once(n_vox, dtype):
    for vec in (False, True) if n_vox % norm_of.vec_of(dtype) == 0 else (False,):
        at = _chunk_voxels(n_vox, dtype, vec)
        np.testing.assert_array_equal(np.sort(at[at >= 0]), np.arange(n_vox))


def test_chunk_moments_merge_without_cancellation():
    """Each chunk's exact centred (mean, M2), merged as the apply and
    backward kernels merge them, against float64, on planes far from 0
    where ss / n - mean^2 loses the variance."""
    rng = np.random.default_rng(5)
    dtype = torch.float32
    for n_vox, shift in ((48**3, 300.0), (8192 * 2 + 77, -50.0)):
        x = (rng.normal(size=n_vox) * 0.5 + shift).astype(np.float32)
        at = _chunk_voxels(n_vox, dtype, False)
        n_k, mean_k, m2_k = [], [], []
        for chunk in at:
            v = x[chunk[chunk >= 0]]
            m = np.float32(v.sum(dtype=np.float32) / np.float32(v.size))
            n_k.append(np.float32(v.size))
            mean_k.append(m)
            m2_k.append(((v - m) ** 2).sum(dtype=np.float32))
        n_k, mean_k, m2_k = map(np.array, (n_k, mean_k, m2_k))
        mean = (n_k * mean_k).sum(dtype=np.float32) / np.float32(n_vox)
        m2 = (m2_k + n_k * (mean_k - mean) ** 2).sum(dtype=np.float32)
        exact = x.astype(np.float64)
        assert abs(mean - exact.mean()) <= 1e-6 * abs(shift)
        assert abs(m2 / n_vox - exact.var()) <= 1e-4 * exact.var()
        naive = (x * x).sum(dtype=np.float32) / n_vox - np.float32(x.mean()) ** 2
        assert abs(naive - exact.var()) > 100 * abs(m2 / n_vox - exact.var())


# ---------------------------------------------------------------------------
# CPU: the spans
# ---------------------------------------------------------------------------

def _norm_spans(prof) -> int:
    return sum(1 for e in prof.events() if e.name == "medseg.norm")


@pytest.mark.parametrize("remat", [False, "all"])
def test_one_norm_span_a_norm_recompute_included(remat):
    """A tiny UNETR: encoder1 and decoder5..decoder2 are residual blocks with
    a projection, three norms each: 15 spans a forward, and 15 more in the
    backward's recompute under remat."""
    model = tunetr.init_weights(
        tunetr.UNETR(in_channels=1, out_channels=2, img_size=(32,) * 3, feature_size=4,
                     hidden_size=24, mlp_dim=24, num_heads=4, num_layers=2, remat=remat),
        torch.Generator().manual_seed(6))
    x = torch.randn((1, 1, 32, 32, 32), generator=torch.Generator().manual_seed(7))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x, return_encoder_features=False).square().mean().backward()
    assert _norm_spans(prof) == (30 if remat else 15)


# ---------------------------------------------------------------------------
# card: the kernels against the plain versions
# ---------------------------------------------------------------------------

# (B, C, edge) of the main path: BraTS's, CT's and Swin's full resolution,
# CT's decoder3, the serving decoder5 and decoder4 (6 windows)
CUDA_SHAPES = [(4, 16, 128), (4, 16, 96), (4, 48, 96), (4, 32, 48), (4, 128, 12), (6, 64, 24)]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item() / max(1.0, ref.float().abs().max().item())


def _inputs(device, dtype, shape, res: bool, seed: int = 0, offset: int = 0):
    """x (conv-output-like: a per-channel offset and scale), its residual,
    weight, bias and a cotangent; ``offset`` elements into a fresh buffer
    (contiguous, off 16 bytes for an odd offset)."""
    g = torch.Generator().manual_seed(seed)
    b, c = shape[:2]

    def tensor(scale, shift):
        t = _randn(g, *shape, scale=scale, dtype=dtype) + shift
        buf = torch.empty(t.numel() + offset, dtype=dtype, device=device)
        out = buf[offset:].view(shape)
        out.copy_(t)
        return out

    shift = _randn(g, 1, c, *([1] * (len(shape) - 2)), scale=2.0)
    x = tensor(1.5, shift.to(dtype))
    r = tensor(1.0, 0.0) if res else None
    w, bias = _affine(g, c, device)
    return x, r, w, bias, tensor(1.0, 0.0)


def _check_pair(device, dtype, shape, epilogue, offset=0):
    leaky, res = EPILOGUES[epilogue]
    x, r, w, b, dy = _inputs(device, dtype, shape, res, offset=offset)
    tol = kernel_check.OUT_TOL[dtype]
    y, mean, rstd = norm_of.instance_norm_fwd(x, w, b, r, leaky)
    y_p, mean_p, rstd_p = norm_of.instance_norm_fwd_plain(x, w, b, r, leaky)
    assert y.dtype == dtype and mean.dtype == torch.float32
    assert _rel(y, y_p) <= tol, "y"
    assert _rel(mean, mean_p) <= kernel_check.STATS_TOL, "mean"
    assert (rstd / rstd_p - 1).abs().max().item() <= kernel_check.STATS_TOL, "rstd"
    got = norm_of.instance_norm_bwd(dy, x, r, mean, rstd, w, b, leaky)
    want = norm_of.instance_norm_bwd_plain(dy, x, r, mean, rstd, w, b, leaky)
    for name, a, e in zip(("dx", "dresidual", "dweight", "dbias"), got, want):
        if e is None:
            assert a is None, name
            continue
        assert a.dtype == e.dtype, name
        assert _rel(a, e) <= (tol if a.ndim > 1 else kernel_check.STATS_TOL), name


@pytest.mark.cuda
@DTYPES
@EPILOGUE
@pytest.mark.parametrize("shape", CUDA_SHAPES, ids=lambda s: "{}x{}x{}^3".format(*s))
def test_kernels_match_plain_at_the_main_path_shapes(device, dtype, epilogue, shape):
    b, c, e = shape
    _check_pair(device, dtype, (b, c, e, e, e), epilogue)


@pytest.mark.cuda
@DTYPES
@EPILOGUE
@pytest.mark.parametrize("shape,offset", [((2, 3, 7, 9, 11), 0), ((2, 4, 97, 97, 97), 0),
                                          ((2, 5, 12, 12, 12), 1), ((1, 3, 48, 48, 48), 3)],
                         ids=["ragged-plane", "ragged-chunks", "unaligned-plane",
                              "unaligned-chunks"])
def test_kernels_match_plain_off_the_vector_route(device, dtype, epilogue, shape, offset):
    n_vox = shape[2] * shape[3] * shape[4]
    assert offset or n_vox % norm_of.vec_of(dtype)  # a case of the one-voxel route
    _check_pair(device, dtype, shape, epilogue, offset)


@pytest.mark.cuda
def test_autograd_matches_the_plain_chain(device):
    """``instance_norm`` through ``InstanceNormFn`` against the plain
    forward's autograd, in fp32 on a small tensor, where a pre-activation
    within rounding of 0 (the leaky ReLU's slope taken on the other side) is
    improbable; in bf16 the plain chain rounds before the activation, so the
    gradients are compared from the same statistics above."""
    dtype = torch.float32
    x, r, w, b, dy = _inputs(device, dtype, (2, 3, 10, 10, 10), True, seed=1)
    outs = []
    for fn in (norm_of.instance_norm, lambda *a, **k: norm_of.instance_norm_fwd_plain(
            a[0], a[1], a[2], k["residual"], k["leaky"])[0]):
        xi, ri = x.clone().requires_grad_(), r.clone().requires_grad_()
        wi, bi = w.clone().requires_grad_(), b.clone().requires_grad_()
        out = fn(xi, wi, bi, leaky=True, residual=ri)
        out.backward(dy)
        outs.append([out, xi.grad, ri.grad, wi.grad, bi.grad])
    tol = kernel_check.OUT_TOL[dtype]
    for name, a, e in zip(("y", "dx", "dresidual", "dweight", "dbias"), *outs):
        assert _rel(a, e) <= (tol if a.ndim > 1 else kernel_check.STATS_TOL), name


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [24, 96], ids=["plane", "chunks"])
def test_two_calls_are_bitwise_equal(device, edge):
    x, r, w, b, dy = _inputs(device, torch.bfloat16, (2, 8, edge, edge, edge), True, seed=2)
    first = norm_of.instance_norm_fwd(x, w, b, r, True)
    first_b = norm_of.instance_norm_bwd(dy, x, r, first[1], first[2], w, b, True)
    second = norm_of.instance_norm_fwd(x, w, b, r, True)
    second_b = norm_of.instance_norm_bwd(dy, x, r, second[1], second[2], w, b, True)
    for a, e in zip(first + first_b, second + second_b):
        assert torch.equal(a, e)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [24, 48], ids=["plane", "chunks"])
def test_capture_and_replay_in_a_cuda_graph(device, edge):
    """The forward and backward capture (scratch from torch.empty on the
    capture stream, no synchronisation) and a replay on new inputs gives the
    eager results bit for bit."""
    x, r, w, b, dy = _inputs(device, torch.bfloat16, (2, 8, edge, edge, edge), True, seed=3)
    sx, sr, sdy = x.clone(), r.clone(), dy.clone()

    def run():
        y, mean, rstd = norm_of.instance_norm_fwd(sx, w, b, sr, True)
        return (y, mean, rstd) + norm_of.instance_norm_bwd(sdy, sx, sr, mean, rstd, w, b, True)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm: the library is built and loaded before the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run()
    x2, r2, _, _, dy2 = _inputs(device, torch.bfloat16, (2, 8, edge, edge, edge), True, seed=4)
    sx.copy_(x2)
    sr.copy_(r2)
    sdy.copy_(dy2)
    graph.replay()
    torch.cuda.synchronize()
    eager = norm_of.instance_norm_fwd(x2, w, b, r2, True)
    eager = eager + norm_of.instance_norm_bwd(dy2, x2, r2, eager[1], eager[2], w, b, True)
    for a, e in zip(static, eager):
        assert torch.equal(a, e)


@pytest.mark.cuda
def test_launches_count_the_wrappers_calls(device):
    norm_of.reset_launches()
    x, r, w, b, dy = _inputs(device, torch.bfloat16, (2, 4, 16, 16, 16), True, seed=5)
    xi = x.clone().requires_grad_()
    norm_of.instance_norm(xi, w, b, leaky=True, residual=r).backward(dy)
    with torch.no_grad():
        norm_of.instance_norm(x, w, b)
    assert (norm_of.instance_norm_fwd.launches, norm_of.instance_norm_bwd.launches) == (2, 1)
    with pytest.raises(ValueError, match="dtype"):
        norm_of.instance_norm(x.half(), w, b)
    assert norm_of.instance_norm_fwd.launches == 2


@pytest.mark.cuda
def test_a_residual_of_another_dtype_promotes_as_the_blocks_add(device):
    x, r, w, b, _ = _inputs(device, torch.bfloat16, (2, 4, 8, 8, 8), True, seed=6)
    r32 = r.float()
    got = norm_of.instance_norm(x, w, b, leaky=True, residual=r32)
    want = F.leaky_relu(norm_of.instance_norm_fwd(x, w, b)[0] + r32, blocks.LEAKY_SLOPE)
    assert got.dtype == torch.float32 and torch.equal(got, want)
