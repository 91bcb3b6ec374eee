"""The tensor-core routes of K1, K2, K5, K6 and K9 (``medseg_torch/kernels/
csrc/conv_tc.cu`` and ``wgrad_tc.cu``) on the CPU, where no CUDA kernel runs.

- The route predicates (``conv_of.tc_route`` in each mode,
  ``conv_of.wgrad_tc_route``, ``conv_of.tc_staging``), checked exactly over
  a table of (C_in, C_out, dtype) and widths.
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

- The asynchronous (cp.async) staging of the no-prologue modes (K5's CAT2
  and K9's FLAT, W a multiple of 8): the box the copies land (per channel
  and z-y row of the 16 x 4 x 10 halo, the x-row's two aligned 16-byte
  pieces and the 4-byte pairs at x0 - 2 and x0 + 16, zero-filled outside
  the volume, in 48-byte rows) and the shared-to-shared pass that writes it
  as swizzled channels-last rows (``tc_common.cuh`` ``box_to_rows``: its
  items, word addresses and byte permutes), checked voxel by voxel at
  negative starts and ragged edges; then the whole kernel walk of groups,
  tiles, slices, weight buffers (resident, or streamed a step ahead through
  two buffers, at 8 slices) and the statistics' flushes, at K5 (64+64)->64
  and (32+32)->32 and K9 128->64 and 32->16, held to ``conv3x3x3_of_cat2``
  and ``medseg.kernels.conv3d._pallas_conv`` in interpret mode as above;
  and the shared-memory layout of each instantiation within the H100's
  232,448 bytes per block.

Volumes are ragged against the 2x8x16 (z, y, x) tile. The conv runs at
5x9x12 (the asynchronous staging at 5x9x24: W a multiple of 8, a ragged
last x tile); the JAX wgrad kernel takes compact rows only (H*W a multiple of
128), so K6 runs at 5x16x8 (W below the tile's 16, D odd). The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels.conv3d import _pallas_conv, weight_matrix
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
    ("cat2", 128, 64, BF, True),  # K5 at feature size 32: TC_MAX_C["cat2"] is 128
    ("combine", 128, 64, BF, False),  # K2 stays at 64
    ("cat2", 32, 16, BF, False), ("cat2", 64, 64, BF, True),  # C_out 64: the (64+64) build
    ("cat2", 128, 32, BF, True), ("cat2", 256, 128, BF, False), ("cat2", 160, 64, BF, False),
    ("combine", 64, 16, BF, True), ("combine", 32, 64, BF, False),
    ("cat2", 48, 32, BF, False), ("combine", 48, 24, BF, False),  # halves of 24
    ("combine", 16, 16, BF, False),  # halves of 8
    ("combine", 32, 16, torch.float16, False),
]


@pytest.mark.parametrize("mode,c,c_out,dtype,tc", TWO_STREAM_ROUTES)
def test_two_stream_route_predicates(mode, c, c_out, dtype, tc):
    """K5 and K2 take the tensor cores in bf16 where both halves of their
    input are whole 16-channel slices (K5: C <= 128; K2: C <= 64) and C_out
    is instantiated; the CUDA-core kernel still has every such width but
    C_out 48 or 128."""
    assert tconv.tc_route(c, c_out, dtype, mode) is tc
    has = dtype in (F32, BF) and (tc or c_out in (16, 32, 64))
    assert tconv.conv_has_kernel(mode, c, c_out, dtype) is has


FLAT_ROUTES = [  # (C, C_out, dtype, tensor cores): K9's route (conv_of.tc_route, mode flat)
    (128, 64, BF, True), (32, 16, BF, True), (64, 32, BF, True), (16, 16, BF, True),
    (128, 16, BF, True), (128, 64, F32, False), (32, 16, F32, False), (136, 64, BF, False),
    (24, 16, BF, False), (128, 128, BF, False), (128, 48, BF, False), (144, 64, BF, False),
    (8, 16, BF, False),
]


@pytest.mark.parametrize("c,c_out,dtype,tc", FLAT_ROUTES)
def test_flat_route_predicates(c, c_out, dtype, tc):
    """K9 takes the tensor cores in bf16 with C a multiple of 16 up to 128
    and C_out 16, 32 or 64; the modes whose kernels were not widened (K1's
    plain and affine, K2, K6) still stop at C = 64."""
    assert tconv.tc_route(c, c_out, dtype, "flat") is tc
    for mode in ("plain", "affine_leaky"):
        assert tconv.tc_route(c, c_out, dtype, mode) is (tc and c <= 64)
    assert tconv.wgrad_tc_route(c, c_out, dtype) is (tc and c <= 64)
    assert tconv.tc_route(c, c_out, dtype, "combine") is (
        tc and c <= 64 and c % 32 == 0 and c_out in (16, 32))


@pytest.mark.parametrize("mode,w,staging", [
    ("cat2", 48, 1), ("cat2", 96, 1), ("cat2", 24, 1), ("cat2", 18, 0), ("cat2", 33, 0),
    ("flat", 48, 1), ("flat", 64, 1), ("flat", 12, 0), ("plain", 48, 0), ("affine_leaky", 96, 0),
    ("combine", 96, 0),
])
def test_staging_predicate(mode, w, staging):
    """Asynchronous staging for the no-prologue modes (CAT2, FLAT) where W
    is a multiple of 8; registers for the rest (the prologue needs the
    values)."""
    assert tconv.tc_staging(mode, w) == staging


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


@pytest.mark.parametrize("c,c_out", [(64, 32), (32, 16), (128, 64)])
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


@pytest.mark.parametrize("c,c_out", [(128, 64), (32, 16)])
def test_flat_register_order_matches_pallas(c, c_out):
    """K9's tensor-core route with the register staging (W % 8 != 0): the
    PLAIN GEMM order, fp32 out, against ``_pallas_conv`` (interpret)."""
    rng = np.random.default_rng(c + c_out)
    x = rng.normal(size=(2, 5, 9, 12, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, c, c_out)) * (27 * c) ** -0.5).astype(np.float32)
    want = np.asarray(_pallas_conv(jnp.asarray(x), jnp.asarray(k), interpret=True))
    assert tconv.tc_staging("flat", x.shape[3]) == 0
    _close(_emulate_gemm(_t(x).double().numpy(), _tw(k))[0].transpose(0, 2, 3, 4, 1), want)


# ---------------------------------------------------------------------------
# The asynchronous staging of K5 (CAT2) and K9 (FLAT): csrc/conv_tc.cu
# conv_tc_async_kernel, on the CPU
# ---------------------------------------------------------------------------

HZ, HY, HX = TZ + 2, TY + 2, TX + 2
NROWS = HZ * HY * HX  # channels-last rows of a staged box
BOX_ROWS = SL * HZ * HY  # (channel, z, y) rows of a box
# csrc/conv_tc.cu: per box row PITCH bf16, halo voxel vx (x = x0 - 1 + vx)
# at element OFF + vx (BOX_PITCH, BOX_OFF); the stage's bytes (BOX_BYTES)
PITCH, OFF = 24, 7
BOX_BYTES = -(-(BOX_ROWS * PITCH * 2 + 16) // 128) * 128
# groups of 8 warps per block and stages per group, by C_out (Async<MODE,
# CO>::NG, ::R): two groups where the weights sit once per block for both
GROUPS, STAGES = {16: 2, 32: 2, 64: 1}, {16: 1, 32: 1, 64: 2}
SMEM_OPTIN = 232_448  # bytes of shared memory one block may use on the H100


def swz32(v, c):
    """``tc::swz<32>``: byte offset of 16-byte chunk c of 32-byte row v."""
    return v * 32 + ((c ^ ((v & 7) >> 2)) << 4)


def staged_box(x, b, c, z0, y0, x0):
    """``issue_box``'s copies of tile (z0, y0, x0) of the (B, C, D, H, W)
    stream ``x`` at batch element b and channels c .. c + 15, as the stage
    holds them (bf16 elements, one per entry): 4 pieces per (channel, z, y)
    row of the halo (z0 - 1 + zi, y0 - 1 + yi), each copied whole or zero
    filled (src-size 0) outside the volume: the pair at x0 - 2 (4 bytes, at
    byte 12 of the row), the two 16-byte halves at x0 and x0 + 8 (bytes 16
    and 32), the pair at x0 + 16 (byte 48: the next row's first bytes).
    Returns the stage and a mask of the elements written."""
    _, _, d, h, w = x.shape
    assert w % tconv.TC_ASYNC_W_ALIGN == 0 and x0 % TX == 0
    stage = np.full(BOX_BYTES // 2, np.nan)
    written = np.zeros(BOX_BYTES // 2, dtype=bool)
    for j in range(4 * BOX_ROWS):
        piece, row = divmod(j, BOX_ROWS)
        ci, zy = divmod(row, HZ * HY)
        z, y = z0 - 1 + zy // HY, y0 - 1 + zy % HY
        xs = x0 + {0: -2, 1: 0, 2: 8, 3: 16}[piece]
        n = 2 if piece in (0, 3) else 8
        inside = 0 <= z < d and 0 <= y < h and 0 <= xs < w
        assert inside == (0 <= z < d and 0 <= y < h and 0 <= xs + n - 1 < w)  # whole pieces
        dst = (row * PITCH * 2 + (12 if piece == 0 else 16 * piece)) // 2
        assert not written[dst : dst + n].any()
        stage[dst : dst + n] = x[b, c + ci, z, y, xs : xs + n] if inside else 0.0
        written[dst : dst + n] = True
    return stage, written


@functools.lru_cache(maxsize=None)
def _box_row_index():
    """``tc::box_to_rows<4, 10, 18, PITCH, OFF>`` as an index: item p of
    (8-channel chunk c, z-y row zy), p = 0 .. 9, reads the 32-bit word of
    each of its channels j at ((8c + j) * 40 + zy) * PITCH / 2 + OFF // 2 +
    p of the stage (elements OFF - 1 + 2p, low half: voxel 2p - 1; OFF + 2p,
    high half: voxel 2p) and stores the low halves as chunk c of row zy * 18
    + 2p - 1 (p > 0), the high halves as chunk c of row zy * 18 + 2p (p <
    9), each at its swizzled offset. Returns, for each (row, channel) as the
    mainloop's ldmatrix reads it (``swz32``), the stage element it holds;
    checks that every 16-byte chunk of the rows is written exactly once."""
    words, zrows = HX // 2 + 1, HZ * HY
    rows = {}
    for i in range(2 * zrows * words):
        c, r = divmod(i, zrows * words)
        zy, p = divmod(r, words)
        elems = [2 * (((8 * c + j) * zrows + zy) * (PITCH // 2) + OFF // 2 + p) for j in range(8)]
        v = zy * HX + 2 * p
        for row, half, ok in ((v - 1, 0, p > 0), (v, 1, p < HX // 2)):
            if ok:
                off = swz32(row, c)
                assert off not in rows and 0 <= off < NROWS * 32
                rows[off] = [e + half for e in elems]
    assert len(rows) == 2 * NROWS
    return np.array([rows[swz32(v, 0)] + rows[swz32(v, 1)] for v in range(NROWS)])


def box_to_rows(stage):
    """The staged channels-last rows (4*10*18, 16) of a landed box."""
    return stage[_box_row_index()]


def test_async_box_fits_its_stage():
    """48-byte rows hold the 18 halo voxels with the 16-byte pieces aligned:
    halo voxel 0 (x0 - 1) at element OFF, voxel 17 (x0 + 16) in the next
    row's first element; the stage is 30,848 bytes (640 rows, 128-aligned)."""
    assert PITCH * 2 == 48 and (OFF + 1) * 2 == 16 and OFF + HX - 1 == PITCH
    assert BOX_BYTES == 30_848


@pytest.mark.parametrize("b,c,z0,y0,x0", [
    (0, 0, 0, 0, 0),  # negative box starts on every axis
    (1, 16, 2, 8, 16),  # ragged right edge in y and x (H = 9, W = 24)
    (0, 0, 4, 0, 0),  # past the last plane in z (D = 5)
    (1, 16, 2, 0, 16),
])
def test_async_staging_holds_each_voxel(b, c, z0, y0, x0):
    """Each staged element holds the voxel and channel of its row (the tile
    origin minus one plus the row's offset in the 4x10x18 halo), and 0
    outside the volume; every element the rows read was written."""
    d, h, w = 5, 9, 24
    x = np.arange(1, 2 * 32 * d * h * w + 1, dtype=np.float64).reshape(2, 32, d, h, w)
    stage, written = staged_box(x, b, c, z0, y0, x0)
    assert written[_box_row_index()].all()
    rows = box_to_rows(stage)
    want = np.zeros((NROWS, SL))
    for v in range(NROWS):
        vz, r = divmod(v, HY * HX)
        vy, vx = divmod(r, HX)
        gz, gy, gx = z0 - 1 + vz, y0 - 1 + vy, x0 - 1 + vx
        if 0 <= gz < d and 0 <= gy < h and 0 <= gx < w:
            want[v] = x[b, c : c + SL, gz, gy, gx]
    np.testing.assert_array_equal(rows, want)


def async_plan(mode, c, c_out):
    """``Async<MODE, CO>`` of csrc/conv_tc.cu: groups per block, stages per
    group, whether every slice's weights stay in shared memory, and the
    block's shared memory ([stages][rows][statistics] per group, then the
    weights: all slices, or two buffers per group)."""
    groups, stages = GROUPS[c_out], STAGES[c_out]
    cat2 = mode == "cat2"  # the residual tap and the statistics
    group = stages * BOX_BYTES + NROWS * 32 + (cat2 * 2 * 2 * 8 * c_out * 4)
    base = groups * group
    w_slice = 27 * c_out * 32 + cat2 * c_out * 32
    resident = base + (c // SL) * w_slice <= SMEM_OPTIN
    return groups, stages, resident, base + (c // SL if resident else 2 * groups) * w_slice


@pytest.mark.parametrize("mode,c,c_out,resident", [
    ("cat2", 64, 32, True), ("cat2", 128, 64, False), ("cat2", 128, 32, False),
    ("cat2", 64, 64, False), ("flat", 128, 64, False), ("flat", 32, 16, True),
    ("flat", 64, 32, True), ("flat", 128, 32, False), ("flat", 128, 16, True),
    ("flat", 32, 64, True),
])
def test_async_layout_fits_a_block(mode, c, c_out, resident):
    """Every width the routes send fits one block; K5 at feature size 16
    keeps its 4 slices' weights once for its two groups, the 8-slice convs
    at C_out 64 stream them."""
    assert tconv.tc_route(c, c_out, BF, mode)
    _, _, res, smem = async_plan(mode, c, c_out)
    assert res is resident and smem <= SMEM_OPTIN


def emulate_async(mode, streams, weight, wres=None, blocks=3):
    """``conv_tc_async_kernel``'s walk: ``blocks`` blocks of ``async_plan``'s
    groups; group g takes tiles g, g + gstride, ... (gstride = blocks x
    groups); its step k is (tile k // ns, slice k % ns), whose box
    ``issue_box`` copies from the slice's stream (K5: the first for s < ns /
    2, at channel 16 s, else the second at 16 s - C/2) and ``box_to_rows``
    stages; the
    slice's weights come from the resident slices or from buffer k % 2 of
    two, which step k - 1 filled with slice k % ns (the prologue buffer 0
    with slice 0); at a tile's last slice the output is written and its sums
    (voxels inside the volume) added into the group's shared slots, which
    are stored into the group's own slot of the partial sums after the
    group's last tile of each batch element (at most once per group and
    batch element; a group whose tiles skip a batch element leaves that slot
    unwritten); ``stats_finish`` then adds each (sum, b, c)'s written slots
    in slot order (``finish_stats``). Returns (out, s, ss[, res, rs, rss])
    as ``_emulate_gemm``, FLAT ``(out,)``."""
    xs = [t.double().numpy() for t in streams]
    bsz, _, d, h, w = xs[0].shape
    c = sum(x.shape[1] for x in xs)
    c_out, ns = weight.shape[0], c // SL
    groups, _, resident, _ = async_plan(mode, c, c_out)
    packed = tconv.pack_tc_weight(weight).double().numpy()
    packed_res = None if wres is None else tconv.pack_tc_wres(wres).double().numpy()
    nz, ny, nx = _tiles(d, h, w)
    ntiles, gstride = bsz * nz * ny * nx, blocks * groups
    n_out = 1 if wres is None else 2
    outs = [np.zeros((bsz, c_out, nz * TZ, ny * TY, nx * TX)) for _ in range(n_out)]
    part = np.full((2 * n_out, bsz, c_out, gstride), np.nan)  # csrc/common.cuh's layout
    stored = np.zeros((gstride, bsz), bool)
    mask = np.zeros((nz * TZ, ny * TY, nx * TX))
    mask[:d, :h, :w] = 1.0

    def tile_at(t):
        t, tx = divmod(t, nx)
        t, ty = divmod(t, ny)
        bb, tz = divmod(t, nz)
        return bb, tz * TZ, ty * TY, tx * TX

    done = []
    for gid in range(gstride):
        nsteps = -(-(ntiles - gid) // gstride) * ns if gid < ntiles else 0
        wbuf = [0, None]  # the slice each weight buffer holds
        slots = [np.zeros((2, c_out)) for _ in range(n_out)]
        accs = [np.zeros((TZ * TY * TX, c_out)) for _ in range(n_out)]
        for k in range(nsteps):
            s = k % ns
            bb, z0, y0, x0 = tile_at(gid + k // ns * gstride)
            second = mode == "cat2" and 2 * s >= ns
            ch = SL * s - (c // 2 if second else 0)
            rows = box_to_rows(staged_box(xs[second], bb, ch, z0, y0, x0)[0])
            rows = rows.reshape(HZ, HY, HX, SL)
            ws = s if resident else wbuf[k % 2]
            assert ws == s, (k, ws, s)
            if not resident and k + 1 < nsteps:
                wbuf[(k + 1) % 2] = (k + 1) % ns
            for t in range(27):
                kz, ky, kx = _tap(t)
                a = rows[kz : kz + TZ, ky : ky + TY, kx : kx + TX].reshape(-1, SL)
                accs[0] += a @ packed[ws, t].T
                if packed_res is not None and t == 13:
                    accs[1] += a @ packed_res[ws].T
            if s < ns - 1:
                continue
            done.append(gid + k // ns * gstride)
            last_of_b = k + 1 == nsteps or tile_at(gid + (k // ns + 1) * gstride)[0] != bb
            if last_of_b:
                assert not stored[gid, bb], (gid, bb)  # one store per group and b
                stored[gid, bb] = True
            for i, (out, acc, slot) in enumerate(zip(outs, accs, slots)):
                tile = acc.reshape(TZ, TY, TX, c_out).transpose(3, 0, 1, 2)
                out[bb, :, z0 : z0 + TZ, y0 : y0 + TY, x0 : x0 + TX] = tile
                inside = tile * mask[z0 : z0 + TZ, y0 : y0 + TY, x0 : x0 + TX]
                slot += [inside.sum((1, 2, 3)), np.square(inside).sum((1, 2, 3))]
                if last_of_b:
                    part[2 * i : 2 * i + 2, bb, :, gid] = slot
                    slot[:] = 0.0
                acc[:] = 0.0
    assert sorted(done) == list(range(ntiles))  # every tile once
    if mode == "flat":
        return (outs[0][:, :, :d, :h, :w],)
    written = np.array([[slot_written(g, bb, gstride, nz * ny * nx, ntiles)
                         for g in range(gstride)] for bb in range(bsz)])
    np.testing.assert_array_equal(written, stored.T)  # the finish reads what was written
    sums = finish_stats(part, written)
    result = []
    for i, out in enumerate(outs):
        result += [out[:, :, :d, :h, :w], sums[2 * i], sums[2 * i + 1]]
    return tuple(result)


FINISH_THREADS = 128  # csrc/conv_of.cu stats_finish_kernel


def slot_written(g, b, nslots, tiles_per_b, ntiles):
    """``stats_finish``'s test: whether group g (tiles g, g + nslots, ...
    below ntiles) took one of batch element b's tiles."""
    lo, hi = b * tiles_per_b, min((b + 1) * tiles_per_b, ntiles)
    first = g if g >= lo else g + -(-(lo - g) // nslots) * nslots
    return first < hi


def finish_stats(part, written):
    """``stats_finish``'s order: per (sum, b, c), thread t adds the written
    slots among t, t + 128, ... in turn, the 32 lanes of a warp combine by
    the xor shuffle tree (offsets 16, 8, 4, 2, 1; lane 0's value), then the
    four warps' sums in warp order. No NaN (the sentinel of an unwritten
    slot) may survive."""
    nslots = part.shape[-1]
    lanes = np.zeros(part.shape[:-1] + (FINISH_THREADS,))
    for j in range(nslots):
        for b in range(part.shape[1]):
            if written[b, j]:
                lanes[:, b, :, j % FINISH_THREADS] += part[:, b, :, j]
    warps = lanes.reshape(part.shape[:-1] + (FINISH_THREADS // 32, 32))
    for offset in (16, 8, 4, 2, 1):
        warps = warps + warps[..., np.arange(32) ^ offset]
    total = np.zeros(part.shape[:-1])
    for w in range(FINISH_THREADS // 32):
        total += warps[..., w, 0]
    assert np.isfinite(total).all()
    return total


@pytest.mark.parametrize("c,c_out", [(128, 64), (64, 32)])
def test_cat2_async_walk_matches_pallas(c, c_out):
    """K5's asynchronous staging, (64+64)->64 (8 slices, weights streamed) and
    (32+32)->32 (resident, two groups), against ``conv3x3x3_of_cat2``
    (interpret): outputs, residual tap and statistics."""
    rng = np.random.default_rng(c * 3 + c_out)
    xa, xb, k, k3 = _two_stream_inputs(rng, c, c_out, w=24)
    h, w = xa.shape[2:4]
    assert tconv.tc_staging("cat2", w) == 1
    ref = conv3x3x3_of_cat2(
        to_output_form(jnp.asarray(xa)), to_output_form(jnp.asarray(xb)),
        weight_matrix(jnp.asarray(k), jnp.float32), res_weight(jnp.asarray(k3), jnp.float32),
        h=h, w=w, out_dtype=jnp.float32, interpret=True,
    )
    _check_conv_outputs(emulate_async("cat2", (_t(xa), _t(xb)), _tw(k), _tw(k3)), ref, h, w)


def test_cat2_async_walk_with_groups_that_skip_a_batch_element():
    """More tile groups than one batch element's tiles (10 blocks of two
    groups against 12 tiles per element): groups skip elements, whose slots
    they never write; the finish reads only the written ones (the NaN
    sentinel of the others never reaches the sums) and the statistics still
    match ``conv3x3x3_of_cat2`` (interpret)."""
    rng = np.random.default_rng(5)
    xa, xb, k, k3 = _two_stream_inputs(rng, 64, 32, w=24)
    h, w = xa.shape[2:4]
    ref = conv3x3x3_of_cat2(
        to_output_form(jnp.asarray(xa)), to_output_form(jnp.asarray(xb)),
        weight_matrix(jnp.asarray(k), jnp.float32), res_weight(jnp.asarray(k3), jnp.float32),
        h=h, w=w, out_dtype=jnp.float32, interpret=True,
    )
    got = emulate_async("cat2", (_t(xa), _t(xb)), _tw(k), _tw(k3), blocks=10)
    _check_conv_outputs(got, ref, h, w)


@pytest.mark.parametrize("c,c_out", [(128, 64), (32, 16)])
def test_flat_async_walk_matches_pallas(c, c_out):
    """K9's asynchronous staging (mode FLAT: fp32 out, no statistics), 128->64 (8
    slices streamed, one group) and 32->16 (resident, two groups), against
    ``_pallas_conv`` (interpret)."""
    rng = np.random.default_rng(c * 7 + c_out)
    x = rng.normal(size=(2, 5, 9, 24, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, c, c_out)) * (27 * c) ** -0.5).astype(np.float32)
    want = np.asarray(_pallas_conv(jnp.asarray(x), jnp.asarray(k), interpret=True))
    (got,) = emulate_async("flat", (_t(x),), _tw(k))
    _close(got.transpose(0, 2, 3, 4, 1), want)
