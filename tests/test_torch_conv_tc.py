"""The tensor-core routes of K1, K2, K5 and K6 (``medseg_torch/kernels/csrc/
conv_tc.cu`` and ``wgrad_tc.cu``) on the CPU, where no CUDA kernel runs.

- The route predicates (``conv_of.tc_route`` in each mode,
  ``conv_of.wgrad_tc_route``), checked exactly over a table of (C_in, C_out,
  dtype).
- A numpy emulation of each kernel's GEMM order, built from what the wrapper
  hands the kernel (``pack_tc_weight``, ``pack_tc_wres``, ``TC_TILE``,
  ``wgrad_tc_groups``) and a channels-last halo: for the conv, the staged
  input slice by slice (K5: the slices of xa, then those of xb; K2: those of
  up, then those of y through the COMBINE prologue with the same channels of
  x, or its one channel), then per voxel tile the sums over 16-channel
  slices and the 27 taps of (256 voxel rows x 16) @ (16 x C_out) products,
  the residual tap on the centre tap's rows; for K6, per slice and tile
  group, the (tap, ci) columns summed over x-rows of 16 voxels, then the
  groups' partials in group order. All are held to the JAX package's Pallas
  kernels in interpret mode on the same seeded numpy inputs, in fp32:
  relative 1e-4 of the largest reference value (only the order of the sums
  differs).

Volumes are ragged against the 2x8x16 (z, y, x) tile. The conv runs at
5x9x12; the JAX wgrad kernel takes compact rows only (H*W a multiple of
128), so K6 runs at 5x16x8 (W below the tile's 16, D odd). The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels.conv3d import weight_matrix
from medseg.kernels.conv_of import (
    conv3x3x3_of,
    conv3x3x3_of_cat2,
    conv3x3x3_of_combine,
    conv3x3x3_wgrad_of,
    from_output_form,
    res_weight,
    to_output_form,
    wgrad_to_kernel,
)
from medseg_torch.kernels import conv_of as tconv
from medseg_torch.models.blocks import LEAKY_SLOPE

TZ, TY, TX = tconv.TC_TILE
SL = tconv.TC_SLICE
TOL = 1e-4
BF, F32 = torch.bfloat16, torch.float32

ROUTES = [  # (C_in, C_out, dtype, tensor cores)
    (16, 16, BF, True), (32, 16, BF, True), (16, 32, BF, True), (32, 32, BF, True),
    (64, 32, BF, True), (32, 64, BF, True), (64, 64, BF, True), (48, 16, BF, True),
    (16, 16, F32, False), (32, 64, F32, False), (16, 16, torch.float16, False),
    (1, 16, BF, False), (4, 16, BF, False), (8, 16, BF, False), (24, 32, BF, False),
    (80, 32, BF, False), (128, 64, BF, False), (16, 8, BF, False), (16, 48, BF, False),
    (16, 128, BF, False),
]


@pytest.mark.parametrize("c_in,c_out,dtype,tc", ROUTES)
def test_route_predicates(c_in, c_out, dtype, tc):
    assert tconv.tc_route(c_in, c_out, dtype) is tc
    assert tconv.wgrad_tc_route(c_in, c_out, dtype) is tc


TWO_STREAM_ROUTES = [  # (mode, C = both halves, C_out, dtype, tensor cores)
    ("cat2", 64, 32, BF, True),  # K5 at feature size 16
    ("combine", 32, 16, BF, True), ("combine", 64, 32, BF, True),  # K2 at 16 and 32
    ("cat2", 64, 32, F32, False), ("combine", 32, 16, F32, False),
    ("cat2", 128, 64, BF, False),  # K5 at feature size 32: C above TC_MAX_C
    ("combine", 128, 64, BF, False),
    ("cat2", 32, 16, BF, False), ("cat2", 64, 64, BF, False),  # C_out not instantiated
    ("combine", 64, 16, BF, True), ("combine", 32, 64, BF, False),
    ("cat2", 48, 32, BF, False), ("combine", 48, 24, BF, False),  # halves of 24
    ("combine", 16, 16, BF, False),  # halves of 8
    ("combine", 32, 16, torch.float16, False),
]


@pytest.mark.parametrize("mode,c,c_out,dtype,tc", TWO_STREAM_ROUTES)
def test_two_stream_route_predicates(mode, c, c_out, dtype, tc):
    """K5 and K2 take the tensor cores in bf16 where both halves of their
    input are whole 16-channel slices (C <= 64) and C_out is instantiated;
    the CUDA-core kernel still has every such width but C_out 48 or 128."""
    assert tconv.tc_route(c, c_out, dtype, mode) is tc
    has = dtype in (F32, BF) and (tc or c_out in (16, 32, 64))
    assert tconv.conv_has_kernel(mode, c, c_out, dtype) is has


def _t(x):
    """NDHWC numpy -> NCDHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _tw(k):
    """flax conv kernel (kd, kh, kw, in, out) -> torch (out, in, kd, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2))))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()))


def _tiles(d, h, w):
    return -(-d // TZ), -(-h // TY), -(-w // TX)


def _halo(xt):
    """(B, C, D, H, W) -> channels-last (B, nz*TZ + 2, ny*TY + 2, nx*TX + 2,
    C): one voxel of zeros around the volume (the same-pad taps) and the
    ragged edge padded out to whole tiles, as the kernels stage it."""
    bsz, c, d, h, w = xt.shape
    nz, ny, nx = _tiles(d, h, w)
    halo = np.zeros((bsz, nz * TZ + 2, ny * TY + 2, nx * TX + 2, c))
    halo[:, 1 : d + 1, 1 : h + 1, 1 : w + 1] = xt.transpose(0, 2, 3, 4, 1)
    return halo


def _tap(t):
    return t // 9, t // 3 % 3, t % 3


def _bc(t):
    """(B, C) per-channel tensor -> (B, C, 1, 1, 1) float64 array."""
    return t.double().numpy()[..., None, None, None]


def _leaky(v):
    return np.where(v >= 0, v, LEAKY_SLOPE * v)


def emulate_conv_tc(x, weight, a=None, b=None, wres=None):
    """K1's tensor-core GEMM order (``_emulate_gemm``) on x, through the
    AFFINE prologue where ``a`` is given."""
    xt = x.double().numpy()
    if a is not None:  # the prologue, applied once per staged value
        xt = _leaky(xt * _bc(a) + _bc(b))
    return _emulate_gemm(xt, weight, wres)


def stage_two_streams(first, second, x=None, ay=None, by=None, ax=None, bx=None):
    """The staged input of K5 (``x`` None) or K2, slice by slice as the
    kernel loads it: slice s of C/16 from ``first`` (xa, up) for s < C/32,
    else from ``second`` (xb, y) at channel 16 s - C/2; K2's second-stream
    values through leaky(ay*y + by + ax*x + bx) with x's same 16 channels
    or its one channel, broadcast."""
    first, second = first.double().numpy(), second.double().numpy()
    half = first.shape[1]
    ns = 2 * half // SL
    slices = []
    for s in range(ns):
        if s < ns // 2:
            slices.append(first[:, SL * s : SL * (s + 1)])
            continue
        ch = slice(SL * s - half, SL * (s + 1) - half)
        v = second[:, ch]
        if x is not None:
            xv = x.double().numpy()
            xv = xv[:, :1] if xv.shape[1] == 1 else xv[:, ch]
            v = _leaky(v * _bc(ay[:, ch]) + _bc(by[:, ch]) + xv * _bc(ax[:, ch]) + _bc(bx[:, ch]))
        slices.append(v)
    return np.concatenate(slices, axis=1)


def _emulate_gemm(xt, weight, wres=None):
    """The tensor-core conv's GEMM order on the staged input ``xt`` (B, C,
    D, H, W): per (b, tile), the A rows of tap t are the tile's 256 voxels
    shifted by t in the slice's staged halo (0 outside the volume, after any
    prologue); B is the packed weight of (slice, tap). Returns (out, s,
    ss[, res, rs, rss])."""
    bsz, c, d, h, w = xt.shape
    c_out = weight.shape[0]
    packed = tconv.pack_tc_weight(weight).double().numpy()  # (C/16, 27, CO, 16)
    packed_res = None if wres is None else tconv.pack_tc_wres(wres).double().numpy()
    halo = _halo(xt)
    nz, ny, nx = _tiles(d, h, w)
    n_out = 1 if wres is None else 2  # the conv, and the residual tap's
    outs = [np.zeros((bsz, c_out, nz * TZ, ny * TY, nx * TX)) for _ in range(n_out)]
    for bb, tz, ty, tx in itertools.product(range(bsz), range(nz), range(ny), range(nx)):
        z0, y0, x0 = tz * TZ, ty * TY, tx * TX
        box = halo[bb, z0 : z0 + TZ + 2, y0 : y0 + TY + 2, x0 : x0 + TX + 2]
        accs = [np.zeros((TZ * TY * TX, c_out)) for _ in outs]
        for s in range(c // SL):
            staged = box[..., s * SL : (s + 1) * SL]
            for t in range(27):
                kz, ky, kx = _tap(t)
                rows = staged[kz : kz + TZ, ky : ky + TY, kx : kx + TX].reshape(-1, SL)
                accs[0] += rows @ packed[s, t].T
                if packed_res is not None and t == 13:  # the centre tap's A rows
                    accs[1] += rows @ packed_res[s].T
        for out, acc in zip(outs, accs):
            out[bb, :, z0 : z0 + TZ, y0 : y0 + TY, x0 : x0 + TX] = (
                acc.reshape(TZ, TY, TX, c_out).transpose(3, 0, 1, 2))
    result = []
    for out in outs:  # the epilogue masks the ragged edge out of the sums
        out = out[:, :, :d, :h, :w]
        result += [out, out.sum((2, 3, 4)), np.square(out).sum((2, 3, 4))]
    return tuple(result)


def emulate_wgrad_tc(x, g, groups):
    """K6's tensor-core GEMM order: per 16-channel slice and tile group (tiles
    k, k + groups, ... in the kernel's order, x fastest), one k16 step per
    x-row of 16 voxels: (CO x 16 cotangent rows) @ (16 x 16 x-halo rows of
    each tap); the groups' partials summed in group order."""
    xt, gt = x.double().numpy(), g.double().numpy()
    bsz, c, d, h, w = xt.shape
    c_out = gt.shape[1]
    nz, ny, nx = _tiles(d, h, w)
    halo = _halo(xt)
    gpad = np.zeros((bsz, nz * TZ, ny * TY, nx * TX, c_out))  # voxels past the edge add 0
    gpad[:, :d, :h, :w] = gt.transpose(0, 2, 3, 4, 1)
    ntiles = bsz * nz * ny * nx
    partial = np.zeros((groups, c_out, c, 27))
    for s, grp in itertools.product(range(c // SL), range(groups)):
        acc = np.zeros((c_out, 27, SL))
        for tile in range(grp, ntiles, groups):
            r, tx = divmod(tile, nx)
            r, ty = divmod(r, ny)
            bb, tz = divmod(r, nz)
            z0, y0, x0 = tz * TZ, ty * TY, tx * TX
            xs = halo[bb, z0 : z0 + TZ + 2, y0 : y0 + TY + 2, x0 : x0 + TX + 2,
                      s * SL : (s + 1) * SL]
            gs = gpad[bb, z0 : z0 + TZ, y0 : y0 + TY, x0 : x0 + TX]
            for rz, ry in itertools.product(range(TZ), range(TY)):
                for t in range(27):
                    kz, ky, kx = _tap(t)
                    acc[:, t] += gs[rz, ry].T @ xs[rz + kz, ry + ky, kx : kx + TX]
        partial[grp, :, s * SL : (s + 1) * SL] = acc.transpose(0, 2, 1)
    dw = np.zeros((c_out, c, 27))
    for grp in range(groups):
        dw += partial[grp]
    return dw.reshape(c_out, c, 3, 3, 3)


@pytest.mark.parametrize("c_in,c_out,act,residual", [
    (16, 16, "affine_leaky", False), (16, 32, "none", False), (32, 16, "none", True),
    (32, 32, "affine_leaky", True), (16, 64, "none", False),
])
def test_conv_tc_order_matches_pallas(c_in, c_out, act, residual):
    """K1's tensor-core GEMM order against ``conv3x3x3_of`` (interpret)."""
    rng = np.random.default_rng(c_in * 100 + c_out)
    d, h, w = 5, 9, 12
    x = rng.normal(size=(1, d, h, w, c_in)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, c_in, c_out)) * (27 * c_in) ** -0.5).astype(np.float32)
    k3 = (rng.normal(size=(1, 1, 1, c_in, c_out)) * c_in**-0.5).astype(np.float32)
    a = (rng.random((1, c_in, 1)) + 0.5).astype(np.float32)
    b = (0.5 * rng.normal(size=(1, c_in, 1))).astype(np.float32)
    ref = conv3x3x3_of(
        to_output_form(jnp.asarray(x)), weight_matrix(jnp.asarray(k), jnp.float32),
        jnp.asarray(a), jnp.asarray(b),
        res_weight(jnp.asarray(k3), jnp.float32) if residual else None,
        h=h, w=w, input_act=act, residual=residual, out_dtype=jnp.float32, interpret=True,
    )
    affine = ((torch.from_numpy(a[..., 0]), torch.from_numpy(b[..., 0]))
              if act == "affine_leaky" else (None, None))
    got = emulate_conv_tc(_t(x), _tw(k), *affine, wres=_tw(k3) if residual else None)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if i % 3 == 0:
            _close(g.transpose(0, 2, 3, 4, 1), from_output_form(r, h, w))
        else:
            _close(g, np.asarray(r)[..., 0])


def _check_conv_outputs(got, ref, h, w):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if i % 3 == 0:
            _close(g.transpose(0, 2, 3, 4, 1), from_output_form(r, h, w))
        else:
            _close(g, np.asarray(r)[..., 0])


def _two_stream_inputs(rng, c, c_out, bsz=2, d=5, h=9, w=12):
    half = c // 2
    xa, xb = (rng.normal(size=(bsz, d, h, w, half)).astype(np.float32) for _ in range(2))
    k = (rng.normal(size=(3, 3, 3, c, c_out)) * (27 * c) ** -0.5).astype(np.float32)
    k3 = (rng.normal(size=(1, 1, 1, c, c_out)) * c**-0.5).astype(np.float32)
    return xa, xb, k, k3


@pytest.mark.parametrize("c,c_out", [(64, 32), (32, 16)])
def test_cat2_tc_order_matches_pallas(c, c_out):
    """K5's tensor-core staging (the slices of xa, then of xb) and GEMM order
    against ``conv3x3x3_of_cat2`` (interpret), two batch elements."""
    rng = np.random.default_rng(c * 10 + c_out)
    xa, xb, k, k3 = _two_stream_inputs(rng, c, c_out)
    h, w = xa.shape[2:4]
    ref = conv3x3x3_of_cat2(
        to_output_form(jnp.asarray(xa)), to_output_form(jnp.asarray(xb)),
        weight_matrix(jnp.asarray(k), jnp.float32), res_weight(jnp.asarray(k3), jnp.float32),
        h=h, w=w, out_dtype=jnp.float32, interpret=True,
    )
    got = _emulate_gemm(stage_two_streams(_t(xa), _t(xb)), _tw(k), _tw(k3))
    _check_conv_outputs(got, ref, h, w)


@pytest.mark.parametrize("c,c_out,x_channels", [(32, 16, 1), (32, 16, 16), (64, 32, 1),
                                                (64, 32, 32)])
def test_combine_tc_order_matches_pallas(c, c_out, x_channels):
    """K2's tensor-core staging (the slices of up, then those of y through
    the COMBINE prologue with x's channels, or its one channel broadcast)
    and GEMM order against ``conv3x3x3_of_combine`` (interpret)."""
    rng = np.random.default_rng(c * 10 + c_out + x_channels)
    up, y, k, k3 = _two_stream_inputs(rng, c, c_out)
    bsz, _, h, w, half = up.shape
    x1 = rng.normal(size=up.shape[:4] + (x_channels,)).astype(np.float32)
    aff = [(rng.random((bsz, half, 1)) + 0.5).astype(np.float32) if i % 2 == 0
           else (0.5 * rng.normal(size=(bsz, half, 1))).astype(np.float32) for i in range(4)]
    ref = conv3x3x3_of_combine(
        to_output_form(jnp.asarray(up)), to_output_form(jnp.asarray(y)),
        to_output_form(jnp.asarray(x1)), *map(jnp.asarray, aff),
        weight_matrix(jnp.asarray(k), jnp.float32), res_weight(jnp.asarray(k3), jnp.float32),
        h=h, w=w, out_dtype=jnp.float32, interpret=True,
    )
    staged = stage_two_streams(_t(up), _t(y), _t(x1),
                               *(torch.from_numpy(a[..., 0]) for a in aff))
    _check_conv_outputs(_emulate_gemm(staged, _tw(k), _tw(k3)), ref, h, w)


@pytest.mark.parametrize("c,c_out,groups", [(16, 16, 1), (32, 16, 3), (16, 32, 4), (32, 64, 2)])
def test_wgrad_tc_order_matches_pallas(c, c_out, groups):
    """K6's tensor-core GEMM order, tiles split over ``groups`` partials,
    against ``conv3x3x3_wgrad_of`` (interpret)."""
    rng = np.random.default_rng(c * 100 + c_out)
    bsz, d, h, w = 2, 5, 16, 8
    x = rng.normal(size=(bsz, d, h, w, c)).astype(np.float32)
    g = rng.normal(size=(bsz, d, h, w, c_out)).astype(np.float32)
    x_of = to_output_form(jnp.asarray(x), dtype=jnp.float32)
    g_of = jnp.asarray(g).transpose(0, 1, 4, 2, 3).reshape(bsz, d, c_out, h * w)
    dk = wgrad_to_kernel(conv3x3x3_wgrad_of(x_of, g_of, h=h, w=w, interpret=True), c, c_out)
    assert groups <= tconv.tc_tiles((bsz, c, d, h, w))
    _close(emulate_wgrad_tc(_t(x), _t(g), groups), _tw(dk).numpy())


def test_wgrad_tc_groups():
    """Blocks per slice: about two per SM in all, never more than the tiles."""
    assert tconv.tc_tiles((4, 16, 96, 96, 96)) == 4 * 48 * 12 * 6
    assert tconv.wgrad_tc_groups((4, 16, 96, 96, 96), 132) == 264
    assert tconv.wgrad_tc_groups((4, 64, 48, 48, 48), 132) == 66
    assert tconv.wgrad_tc_groups((1, 32, 5, 16, 8), 132) == tconv.tc_tiles((1, 32, 5, 16, 8)) == 6


def test_packed_weights_are_the_kernels_b_rows():
    """Row (slice, tap, co) of ``pack_tc_weight`` holds the slice's 16 input
    channels of ``weight[co, :, kz, ky, kx]``; ``pack_tc_wres`` the same of
    the 1x1x1 tap."""
    g = torch.Generator().manual_seed(0)
    weight = torch.randn((32, 48, 3, 3, 3), generator=g)
    wres = torch.randn((32, 48, 1, 1, 1), generator=g)
    packed, packed_res = tconv.pack_tc_weight(weight), tconv.pack_tc_wres(wres)
    assert packed.shape == (3, 27, 32, 16) and packed.is_contiguous()
    assert packed_res.shape == (3, 32, 16) and packed_res.is_contiguous()
    for s, t, co in itertools.product(range(3), range(27), (0, 7, 31)):
        kz, ky, kx = _tap(t)
        assert torch.equal(packed[s, t, co], weight[co, 16 * s : 16 * s + 16, kz, ky, kx])
        assert torch.equal(packed_res[s, co], wres[co, 16 * s : 16 * s + 16, 0, 0, 0])
