"""The narrow-input tensor-core route of K1 and K6 (``medseg_torch/kernels/
csrc/conv_narrow_tc.cu``: encoder1.conv1 at C_in 1 on CT and 4 on BraTS) on
the CPU, where no CUDA kernel runs.

- The route predicates (``conv_of.narrow_tc_route``,
  ``wgrad_narrow_tc_route``) over a table of widths, dtypes and modes, and
  the packers (``pack_narrow_weight``, ``pack_narrow_wres``) against the
  (CO, C, 3, 3, 3) weights in the K order of ``narrow_columns`` (re-derived
  here: k = tap * CP + ci at CP = ``narrow_cp(C)`` 1 and 2, 4 consecutive
  channels of one tap per lane's B registers at CP 4 and 8), zero in the
  padding channels and the padded k (K = 32 at C = 1, 112 at C = 4); the
  residual tap at the centre tap's columns only.
- A numpy emulation of each kernel's walk, built from what the wrapper
  hands the kernel: persistent blocks taking tiles g, g + G, ... of 2x4x64
  voxels (``NARROW_TILE``), one 64-voxel x-row per warp; for the forward,
  per row the (C_out x K) packed weights times the (K x 64) columns gathered
  from a channels-last halo of CP channels (a padded k reads the row's own
  voxel, times zero weights), the residual tap from the k-step holding tap
  13 only, the statistics of the valid voxels summed per block and batch
  element into the block's slot when its walk leaves the element, and the
  finish adding the written slots in slot order (``stats_finish``'s
  ``slot_written``, checked against the slots the walk wrote); for the
  filter gradient, per block the (C_out x 16 voxels) cotangent times the (16
  x N) (tap, ci) columns of each k-step, the blocks' (CO, C, 27) partials
  summed in block order. Both are held to the JAX package's Pallas kernels
  in interpret mode (``conv3x3x3_of`` at C_in 1 and 4 without and with the
  tap, ``conv3x3x3_wgrad_of`` at C 1 and 4) with 1 and 3 blocks, in fp32 on
  seeded numpy inputs: relative 1e-4 of the largest reference value (only
  the order of the sums differs), and to the plain versions on a volume
  two x-tiles wide.
- The staging, element by element in numpy: each tile's raw x box as the
  cp.async pieces (and the one-value path) land it, K1's channels-last
  transpose and K6's copy one element to the left by byte permutes, read
  through every lane's offsets (the K order of ``narrow_columns``; 8-byte
  reads at CP 4 and 8), hold each B fragment's (tap, ci) at its voxels,
  with every wide read aligned and no read of unwritten shared memory.
- The kernels' 4 x 4 transpose of 32-bit words within a quad of lanes
  (``quad_transpose``: the K1 exit, 16-byte NCDHW stores), its
  shuffles emulated lane by lane.
- The plain filter gradient against the JAX kernel at C = 1 and 4.

The kernels themselves are held to their plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels.conv3d import weight_matrix
from medseg.kernels.conv_of import (
    conv3x3x3_of,
    conv3x3x3_wgrad_of,
    from_output_form,
    res_weight,
    to_output_form,
    wgrad_to_kernel,
)
from medseg_torch.kernels import conv_of as tconv

TZ, TY, TX = tconv.NARROW_TILE
TOL = 1e-4
BF, F32 = torch.bfloat16, torch.float32

ROUTES = [  # (C_in, C_out, dtype, mode, narrow route)
    (1, 16, BF, "plain", True), (2, 16, BF, "plain", True), (4, 16, BF, "plain", True),
    (8, 16, BF, "plain", True), (1, 32, BF, "plain", True), (4, 32, BF, "plain", True),
    (8, 32, BF, "plain", True), (3, 16, BF, "plain", True), (5, 32, BF, "plain", True),
    (1, 16, F32, "plain", False), (4, 16, F32, "plain", False),
    (1, 16, BF, "affine_leaky", False), (4, 16, BF, "affine_leaky", False),
    (16, 16, BF, "plain", False), (9, 16, BF, "plain", False), (15, 32, BF, "plain", False),
    (1, 64, BF, "plain", False), (4, 64, BF, "plain", False), (4, 8, BF, "plain", False),
    (1, 16, torch.float16, "plain", False), (4, 32, BF, "cat2", False),
]


@pytest.mark.parametrize("c_in,c_out,dtype,mode,narrow", ROUTES)
def test_narrow_route_predicates(c_in, c_out, dtype, mode, narrow):
    """bf16 with no prologue, 1 <= C_in <= 8, C_out 16 or 32; never where the
    16-channel-slice route runs; the width table is unchanged."""
    assert tconv.narrow_tc_route(c_in, c_out, dtype, mode) is narrow
    assert tconv.wgrad_narrow_tc_route(c_in, c_out, dtype) is (
        dtype == BF and 1 <= c_in <= 8 and c_out in (16, 32))
    assert not (narrow and tconv.tc_route(c_in, c_out, dtype, mode))
    if narrow:
        assert tconv.conv_has_kernel(mode, c_in, c_out, dtype)
        assert tconv.wgrad_has_kernel(c_in, c_out, dtype)


@pytest.mark.parametrize("c,cp,k", [(1, 1, 32), (2, 2, 64), (3, 4, 112), (4, 4, 112),
                                    (5, 8, 224), (8, 8, 224)])
def test_narrow_widths(c, cp, k):
    assert tconv.narrow_cp(c) == cp and tconv.narrow_k(c) == k


def _k_of(tap, ci, cp):
    """The packed column of (tap, ci): k = tap * CP + ci at CP 1 and 2; at CP
    4 and 8, 16 / CP taps per k16 step, lane tig's B registers (k = 16 ks + 2
    tig + e, + 8) holding 4 consecutive channels of one tap."""
    if cp <= 2:
        return tap * cp + ci
    tps, lpt = 16 // cp, cp // 4
    tig = tap % tps * lpt + ci // 4
    return 16 * (tap // tps) + 8 * (ci % 4 // 2) + 2 * tig + ci % 2


def _k_source(k, cp):
    """The (tap, ci) a lane's gather reads for column k: its own, or for a
    padded k (zero weights) the voxel's tap (0, 0, 0) at offset 0 (channel
    0 at CP = 1; the 32-bit pair at CP = 2, the 8-byte quad at CP 4 and 8)."""
    if cp <= 2:
        return divmod(k, cp) if k < 27 * cp else (0, k % cp)
    ks, r = divmod(k, 16)
    h, r = divmod(r, 8)
    tig, e = divmod(r, 2)
    tap, ci = 16 // cp * ks + tig // (cp // 4), 4 * (tig % (cp // 4)) + 2 * h + e
    return (tap, ci) if tap < 27 else (0, 2 * h + e)


def test_narrow_k_order_is_pinned():
    """The centre tap's columns, where the residual tap runs: at C = 1 k 13,
    at C = 4 k 50, 51, 58, 59 (k-step 3), at C = 8 k 100-103, 108-111
    (k-step 6)."""
    assert [k for k, tap, _ in tconv.narrow_columns(1) if tap == 13] == [13]
    assert [k for k, tap, _ in tconv.narrow_columns(4) if tap == 13] == [50, 51, 58, 59]
    assert [k for k, tap, _ in tconv.narrow_columns(8) if tap == 13] == [
        100, 101, 102, 103, 108, 109, 110, 111]
    for c in range(1, 9):
        cp = tconv.narrow_cp(c)
        assert tconv.narrow_columns(c) == tuple(sorted(
            (_k_of(tap, ci, cp), tap, ci) for tap in range(27) for ci in range(c)))
        assert all(_k_source(k, cp) == (tap, ci) for k, tap, ci in tconv.narrow_columns(c))


@pytest.mark.parametrize("c,c_out", [(1, 16), (4, 16), (3, 32), (8, 32)])
def test_narrow_packers_are_the_kernels_rows(c, c_out):
    """Column ``_k_of(tap, ci)`` of ``pack_narrow_weight`` holds ``weight[co,
    ci, kz, ky, kx]`` (tap = 9 kz + 3 ky + kx), 0 elsewhere;
    ``pack_narrow_wres`` holds the 1x1x1 tap at tap 13's columns."""
    g = torch.Generator().manual_seed(c + c_out)
    weight = torch.randn((c_out, c, 3, 3, 3), generator=g)
    wres = torch.randn((c_out, c, 1, 1, 1), generator=g)
    packed, packed_res = tconv.pack_narrow_weight(weight), tconv.pack_narrow_wres(wres)
    cp, kp = tconv.narrow_cp(c), tconv.narrow_k(c)
    assert packed.shape == packed_res.shape == (c_out, kp) and packed.is_contiguous()
    want = torch.zeros((c_out, kp))
    want_res = torch.zeros((c_out, kp))
    for tap, ci in itertools.product(range(27), range(c)):
        kz, ky, kx = _tap(tap)
        want[:, _k_of(tap, ci, cp)] = weight[:, ci, kz, ky, kx]
        if tap == 13:
            want_res[:, _k_of(tap, ci, cp)] = wres[:, ci, 0, 0, 0]
    assert torch.equal(packed, want) and torch.equal(packed_res, want_res)


def _tap(t):
    return t // 9, t // 3 % 3, t % 3


def _t(x):
    """NDHWC numpy -> NCDHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _tw(k):
    """flax conv kernel (kd, kh, kw, in, out) -> torch (out, in, kd, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2))))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()))


def _grid(d, h, w):
    return -(-d // TZ), -(-h // TY), -(-w // TX)


def _halo(xt, cp):
    """(B, C, D, H, W) -> channels-last (B, nz*TZ + 2, ny*TY + 2, nx*TX + 2,
    CP): zeros around the volume (the same-pad taps), past its ragged edge
    and in the padding channels, as the kernels stage it."""
    bsz, c, d, h, w = xt.shape
    nz, ny, nx = _grid(d, h, w)
    halo = np.zeros((bsz, nz * TZ + 2, ny * TY + 2, nx * TX + 2, cp))
    halo[:, 1 : d + 1, 1 : h + 1, 1 : w + 1, :c] = xt.transpose(0, 2, 3, 4, 1)
    return halo


def _columns(halo_row, cp, n_cols, forward=True):
    """The (tap, ci) columns k < ``n_cols`` of a tile row's 64 voxels,
    ``halo_row`` its (3, 3, 66, CP) halo: the forward's in the order of
    ``narrow_columns`` (``_k_source``), the filter gradient's k = tap * CP +
    ci; a padded k reads the voxel's own tap (0, 0, 0) at offset 0."""
    cols = np.empty((n_cols, TX))
    for k in range(n_cols):
        tap, ci = _k_source(k, cp) if forward else (
            divmod(k, cp) if k < 27 * cp else (0, k % min(cp, 2)))
        kz, ky, kx = _tap(tap)
        cols[k] = halo_row[kz, ky, kx : kx + TX, ci]
    return cols


def _walk(bsz, d, h, w, blocks):
    """Each block's tiles (g, g + blocks, ...), as (b, z0, y0, x0)."""
    nz, ny, nx = _grid(d, h, w)
    ntiles = bsz * nz * ny * nx
    for blk in range(blocks):
        tiles = []
        for t in range(blk, ntiles, blocks):
            r, tx = divmod(t, nx)
            r, ty = divmod(r, ny)
            b, tz = divmod(r, nz)
            tiles.append((b, tz * TZ, ty * TY, tx * TX))
        yield blk, tiles


def slot_written(g, b, nslots, tiles_per_b, ntiles):
    """``csrc/conv_of.cu`` ``slot_written``: whether block g took a tile of b."""
    lo = b * tiles_per_b
    hi = min(lo + tiles_per_b, ntiles)
    first = g if g >= lo else g + (lo - g + nslots - 1) // nslots * nslots
    return first < hi


def emulate_conv_narrow(x, weight, wres, blocks):
    """K1's narrow walk (module docstring); returns (out, s, ss[, res, rs,
    rss]) in float64."""
    xt = x.double().numpy()
    bsz, c, d, h, w = xt.shape
    c_out = weight.shape[0]
    cp, kp = tconv.narrow_cp(c), tconv.narrow_k(c)
    packed = tconv.pack_narrow_weight(weight).double().numpy()
    k13 = 13 * cp // 16  # the k-step holding the centre tap's channels
    packed_res = None if wres is None else tconv.pack_narrow_wres(wres).double().numpy()
    halo = _halo(xt, cp)
    nout = 1 if wres is None else 2
    nz, ny, nx = _grid(d, h, w)
    outs = [np.zeros((bsz, c_out, nz * TZ, ny * TY, nx * TX)) for _ in range(nout)]
    part = np.zeros((2 * nout, bsz, c_out, blocks))
    written = set()
    for blk, tiles in _walk(bsz, d, h, w, blocks):
        sums = np.zeros((2 * nout, c_out))
        for i, (b, z0, y0, x0) in enumerate(tiles):
            for z, y in itertools.product(range(TZ), range(TY)):
                if z0 + z >= d or y0 + y >= h:
                    continue
                cols = _columns(halo[b, z0 + z : z0 + z + 3, y0 + y : y0 + y + 3, x0 : x0 + TX + 2],
                                cp, kp)
                rows = [packed @ cols]
                if packed_res is not None:
                    ks = slice(16 * k13, 16 * k13 + 16)
                    rows.append(packed_res[:, ks] @ cols[ks])
                valid = np.arange(x0, x0 + TX) < w
                for o, row in enumerate(rows):
                    outs[o][b, :, z0 + z, y0 + y, x0 : x0 + TX] = row
                    sums[2 * o] += row[:, valid].sum(1)
                    sums[2 * o + 1] += np.square(row[:, valid]).sum(1)
            if i + 1 == len(tiles) or tiles[i + 1][0] != b:  # the walk leaves b
                part[:, b, :, blk] = sums
                written.add((blk, b))
                sums = np.zeros((2 * nout, c_out))
    ntiles, per_b = bsz * nz * ny * nx, nz * ny * nx
    assert written == {(g, b) for g in range(blocks) for b in range(bsz)
                       if slot_written(g, b, blocks, per_b, ntiles)}
    result = []
    for o, out in enumerate(outs):
        result.append(out[:, :, :d, :h, :w])
        for k in (2 * o, 2 * o + 1):  # the finish: the written slots in slot order
            total = np.zeros((bsz, c_out))
            for b, g in itertools.product(range(bsz), range(blocks)):
                if slot_written(g, b, blocks, per_b, ntiles):
                    total[b] += part[k, b, :, g]
            result.append(total)
    return tuple(result)


def emulate_wgrad_narrow(x, g, blocks):
    """K6's narrow walk: per block, (CO x 16 voxels) @ (16 x N) per k-step of
    each tile row, the partials (CO, C, 27) summed in block order."""
    xt, gt = x.double().numpy(), g.double().numpy()
    bsz, c, d, h, w = xt.shape
    c_out = gt.shape[1]
    cp = tconv.narrow_cp(c)
    n_cols = -(-27 * cp // 8) * 8
    halo = _halo(xt, cp)
    nz, ny, nx = _grid(d, h, w)
    gpad = np.zeros((bsz, c_out, nz * TZ, ny * TY, nx * TX))  # voxels past the edge add 0
    gpad[:, :, :d, :h, :w] = gt
    dw = np.zeros((c_out, c, 27))
    for _, tiles in _walk(bsz, d, h, w, blocks):
        acc = np.zeros((c_out, n_cols))
        for b, z0, y0, x0 in tiles:
            for z, y in itertools.product(range(TZ), range(TY)):
                if z0 + z >= d or y0 + y >= h:
                    continue
                cols = _columns(halo[b, z0 + z : z0 + z + 3, y0 + y : y0 + y + 3, x0 : x0 + TX + 2],
                                cp, n_cols, forward=False)
                cot = gpad[b, :, z0 + z, y0 + y, x0 : x0 + TX]
                for s in range(TX // 16):
                    acc += cot[:, 16 * s : 16 * s + 16] @ cols[:, 16 * s : 16 * s + 16].T
        taps = acc[:, : 27 * cp].reshape(c_out, 27, cp)[:, :, :c]
        dw += taps.transpose(0, 2, 1)  # the block's partial, added in block order
    return dw.reshape(c_out, c, 3, 3, 3)


def _inputs(c, c_out, bsz=2, d=5, h=9, w=12, seed=0):
    rng = np.random.default_rng(seed + 10 * c + c_out)
    x = rng.normal(size=(bsz, d, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, c, c_out)) * (27 * c) ** -0.5).astype(np.float32)
    k3 = (rng.normal(size=(1, 1, 1, c, c_out)) * c**-0.5).astype(np.float32)
    return x, k, k3


@functools.lru_cache(maxsize=None)
def _pallas_conv(c, c_out, residual):
    x, k, k3 = _inputs(c, c_out)
    h, w = x.shape[2:4]
    ref = conv3x3x3_of(
        to_output_form(jnp.asarray(x)), weight_matrix(jnp.asarray(k), jnp.float32), None, None,
        res_weight(jnp.asarray(k3), jnp.float32) if residual else None,
        h=h, w=w, input_act="none", residual=residual, out_dtype=jnp.float32, interpret=True,
    )
    return tuple(from_output_form(r, h, w) if i % 3 == 0 else np.asarray(r)[..., 0]
                 for i, r in enumerate(ref))


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
@pytest.mark.parametrize("c", [1, 4])
def test_conv_narrow_order_matches_pallas(c, residual, blocks):
    """K1's narrow GEMM order and statistics' slots against ``conv3x3x3_of``
    (interpret), two batch elements of 5x9x12 (9 tiles each; with 3 blocks
    each block's walk crosses both)."""
    c_out = 16
    x, k, k3 = _inputs(c, c_out)
    got = emulate_conv_narrow(_t(x), _tw(k), _tw(k3) if residual else None, blocks)
    ref = _pallas_conv(c, c_out, residual)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g.transpose(0, 2, 3, 4, 1) if i % 3 == 0 else g, r)


@functools.lru_cache(maxsize=None)
def _pallas_wgrad(c, c_out):
    rng = np.random.default_rng(100 + c)
    bsz, d, h, w = 2, 5, 16, 8  # the JAX kernel takes compact rows (H*W % 128 == 0)
    x = rng.normal(size=(bsz, d, h, w, c)).astype(np.float32)
    g = rng.normal(size=(bsz, d, h, w, c_out)).astype(np.float32)
    x_of = to_output_form(jnp.asarray(x), dtype=jnp.float32)
    g_of = jnp.asarray(g).transpose(0, 1, 4, 2, 3).reshape(bsz, d, c_out, h * w)
    dk = wgrad_to_kernel(conv3x3x3_wgrad_of(x_of, g_of, h=h, w=w, interpret=True), c, c_out)
    return x, g, _tw(dk).numpy()


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("c", [1, 4])
def test_wgrad_narrow_order_matches_pallas(c, blocks):
    """K6's narrow GEMM order, the tiles split over ``blocks`` partials,
    against ``conv3x3x3_wgrad_of`` (interpret)."""
    x, g, ref = _pallas_wgrad(c, 16)
    _close(emulate_wgrad_narrow(_t(x), _t(g), blocks), ref)


@pytest.mark.parametrize("c", [1, 4])
def test_plain_wgrad_matches_pallas(c):
    """The plain filter gradient (the CPU's K6) at the narrow widths."""
    x, g, ref = _pallas_wgrad(c, 16)
    got = tconv.conv3x3x3_wgrad_of(_t(x), _t(g))
    assert got.shape == (16, c, 3, 3, 3) and got.dtype == torch.float32
    _close(got.numpy(), ref)


@pytest.mark.parametrize("c,c_out,residual", [(1, 16, False), (3, 32, True), (8, 16, True)])
def test_narrow_walks_match_plain_over_two_x_tiles(c, c_out, residual):
    """Both emulations against the plain versions (fp32) on 3 x 3x5x70: two
    x tiles, the second ragged, 5 blocks; C = 3 stages a padding channel."""
    g = torch.Generator().manual_seed(c + c_out)
    x = torch.randn((3, c, 3, 5, 70), generator=g)
    w = torch.randn((c_out, c, 3, 3, 3), generator=g) * (27 * c) ** -0.5
    wres = torch.randn((c_out, c, 1, 1, 1), generator=g) if residual else None
    cot = torch.randn((3, c_out, 3, 5, 70), generator=g)
    got = emulate_conv_narrow(x, w, wres, 5)
    want = tconv.conv3x3x3_of(x, w, wres=wres)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b.numpy())
    _close(emulate_wgrad_narrow(x, cot, 5), tconv.conv3x3x3_wgrad_of(x, cot).numpy())


def quad_transpose(words):
    """``csrc/conv_narrow_tc.cu`` ``quad_transpose`` on the 4 lanes of a quad:
    ``words[t]`` lane t's 4 registers; the shuffles (__shfl_xor_sync) read
    the partner lane's value of the same expression."""
    def x0(t): return words[t][1] if t & 1 else words[t][0]
    def x1(t): return words[t][3] if t & 1 else words[t][2]
    def s0(t): return words[t][0] if t & 1 else words[t][1]
    def s1(t): return words[t][2] if t & 1 else words[t][3]

    out = []
    for t in range(4):
        l, h = t & 1, t & 2
        r0, r1 = s0(t ^ 1), s1(t ^ 1)  # __shfl_xor_sync(..., 1)

        def r0_of(u): return s0(u ^ 1)
        def r1_of(u): return s1(u ^ 1)

        k0, k1 = (x1(t), r1) if h else (x0(t), r0)
        u = t ^ 2  # __shfl_xor_sync(..., 2): lane u's value of its expression
        q0 = x0(u) if u & 2 else x1(u)
        q1 = r0_of(u) if u & 2 else r1_of(u)
        e0, e1 = (k1, k0) if l else (k0, k1)
        f0, f1 = (q1, q0) if l else (q0, q1)
        out.append([f0, f1, e0, e1] if h else [e0, e1, f0, f1])
    return out


def test_quad_transpose_is_the_transpose():
    words = [[f"lane{t} word{j}" for j in range(4)] for t in range(4)]
    got = quad_transpose(words)
    assert got == [[words[i][t] for i in range(4)] for t in range(4)]
    assert quad_transpose(got) == words


def test_narrow_tiles():
    assert tconv.narrow_tiles((4, 1, 96, 96, 96)) == 4 * 48 * 24 * 2
    assert tconv.narrow_tiles((4, 4, 128, 128, 128)) == 4 * 64 * 32 * 2
    assert tconv.narrow_tiles((3, 8, 9, 13, 70)) == 3 * 5 * 4 * 2


# The shared-memory layouts of csrc/conv_narrow_tc.cu (its constants): raw
# rows of RW words, halo voxel hx at element XOFF + hx, a channel every CPW
# words; K1's channels-last halo pitch HP per CP; K6's E: the raw rows one
# element to the left, voxel hx at element EO + hx
RW, XOFF, EO = 40, 7, 6
RWE, ROWS = 2 * RW, (TZ + 2) * (TY + 2)
CPW = ROWS * RW + 4
HP = {1: RWE, 2: 80, 4: 88, 8: 84}
HX0 = {1: XOFF, 2: 1, 4: 1, 8: 1}  # the halo's position of voxel hx: HX0 + hx
GARBAGE = 0xFFFF  # shared memory the staging never writes (a bf16 NaN pattern)


def _raw_box(x16, t, cp, vectorized):
    """``issue_raw``: the tile's raw box as uint16 elements, by the async
    path's pieces (2 x 4 bytes and 8 x 16 bytes per row) or the one-value
    path (halo voxels -1 .. 66)."""
    b, z0, y0, x0 = t
    _, c_in, d, h, w = x16.shape
    raw = np.full(cp * CPW * 2, GARBAGE, np.uint16)

    def value(c, gz, gy, gx):
        ok = c < c_in and 0 <= gz < d and 0 <= gy < h and 0 <= gx < w
        return x16[b, c, gz, gy, gx] if ok else 0

    for c, r in itertools.product(range(cp), range(ROWS)):
        gz, gy = z0 - 1 + r // (TY + 2), y0 - 1 + r % (TY + 2)
        base = 2 * (c * CPW + r * RW)
        in_row = c < c_in and 0 <= gz < d and 0 <= gy < h
        if vectorized:
            pieces = [(6, x0 - 2, 2, in_row and x0 >= 2), (72, x0 + 64, 2, in_row and x0 + 64 < w)]
            pieces += [(8 + 8 * p, x0 + 8 * p, 8, in_row and x0 + 8 * p < w) for p in range(8)]
            for e, gx, n, ok in pieces:
                for i in range(n):
                    raw[base + e + i] = value(c, gz, gy, gx + i) if ok else 0
        else:
            for hx in range(-1, TX + 3):
                raw[base + XOFF + hx] = value(c, gz, gy, x0 - 1 + hx)
    return raw


def _word(a, i):
    """The 32-bit word at element i (i even: an aligned 4-byte load)."""
    assert i % 2 == 0
    return int(a[i]) | int(a[i + 1]) << 16


def _halves(word):
    return word & 0xFFFF, word >> 16


def _raw_to_halo(raw, cp):
    """``raw_to_halo``: per (row, quad of raw words) the CP channels' 16
    bytes, each word's two voxels written as one channels-last pair at
    positions 8q - 6 + 2k (halo voxel hx at HX0 + hx)."""
    halo = np.full(ROWS * HP[cp] * cp, GARBAGE, np.uint16)
    for r, q in itertools.product(range(ROWS), range(RW // 4)):
        for k in range(4):
            pos = 8 * q - 6 + 2 * k
            if not 0 <= pos <= TX + 2:
                continue
            for c in range(cp):
                lo, hi = _halves(_word(raw, 2 * (c * CPW + r * RW + 4 * q + k)))
                halo[(r * HP[cp] + pos) * cp + c] = lo
                halo[(r * HP[cp] + pos + 1) * cp + c] = hi
    return halo


def _logical(x16, t, c, hz, hy, hx):
    b, z0, y0, x0 = t
    _, c_in, d, h, w = x16.shape
    gz, gy, gx = z0 - 1 + hz, y0 - 1 + hy, x0 - 1 + hx
    ok = c < c_in and 0 <= gz < d and 0 <= gy < h and 0 <= gx < w
    return x16[b, c, gz, gy, gx] if ok else 0


def _tap_offset(tap, ci, cp):
    """``tap_offset``."""
    if tap >= 27:
        return 0
    kz, ky, kx = _tap(tap)
    return ((kz * (TY + 2) + ky) * HP[cp] + kx) * cp + ci


def _lane_reads(halo, v, ks, tig, cp):
    """The four halves of a lane's B registers (columns 16 ks + 2 tig + {0,
    1, 8, 9}) as the kernel loads them at voxel offset v."""
    k = 16 * ks + 2 * tig
    if cp == 1:
        return [halo[v + _tap_offset(kk, 0, 1) if kk < 27 else v] for kk in (k, k + 1, k + 8, k + 9)]
    if cp == 2:
        return [half for kk in (k, k + 8)
                for half in _halves(_word(halo, v + _tap_offset(*divmod(kk, 2), 2) if kk < 54 else v))]
    lpt = cp // 4
    o = v + _tap_offset(16 // cp * ks + tig // lpt, 4 * (tig % lpt), cp)
    assert o % 4 == 0  # an aligned 8-byte load
    return [halo[o + i] for i in range(4)]


@pytest.mark.parametrize("vectorized", [True, False], ids=["cp.async", "one value"])
@pytest.mark.parametrize("cp", [1, 2, 4, 8])
def test_k1_staging_gathers_the_halo(cp, vectorized):
    """K1's staged box (the raw rows, at CP >= 2 transposed channels-last)
    read through each lane's offsets: every B fragment register of every
    k-step and n8 tile of every row holds the (tap, ci) columns (k, k + 1) of
    its voxel, as ``_columns`` defines them, and no read lands on memory the
    staging left unwritten; on a 2 x (C) x 5x7x72 volume (x tiles at 0 and
    64, the second 8 voxels wide) with C = CP - 1 where CP > 2 (a padding
    channel)."""
    c_in = cp - 1 if cp > 2 else cp
    rng = np.random.default_rng(cp)
    x16 = rng.integers(1, 0x7F00, size=(2, c_in, 5, 7, 72), dtype=np.uint16)
    kp = tconv.narrow_k(c_in)
    hx0 = HX0[cp]
    for t in [(1, 4, 4, 64), (0, 0, 0, 0)]:
        raw = _raw_box(x16, t, cp, vectorized)
        halo = raw if cp == 1 else _raw_to_halo(raw, cp)
        for z, y, xv in itertools.product(range(TZ), range(TY), range(TX)):
            g = xv % 8
            v = ((z * (TY + 2) + y) * HP[cp] + hx0 + xv) * cp
            assert v == ((z * (TY + 2) + y) * HP[cp] + hx0 + 8 * (xv // 8) + g) * cp
            for ks, tig in itertools.product(range(kp // 16), range(4)):
                k = 16 * ks + 2 * tig
                got = _lane_reads(halo, v, ks, tig, cp)
                for kk, value in zip((k, k + 1, k + 8, k + 9), got):
                    tap, ci = _k_source(kk, cp)
                    kz, ky, kx = _tap(tap)
                    assert value == _logical(x16, t, ci, z + kz, y + ky, xv + kx), (t, kk)


@pytest.mark.parametrize("vectorized", [True, False], ids=["cp.async", "one value"])
@pytest.mark.parametrize("cp", [1, 4, 8])
def test_k6_staging_gathers_the_halo(cp, vectorized):
    """K6's staged x (the raw box for the taps with kx odd, and E: its rows
    one element to the left by byte permutes, for kx even) read through each
    lane's column offsets: both registers of a column's B fragment hold its
    (tap, ci) at the x-pairs (2 tig, 2 tig + 1) and (+ 8, + 9) of each
    k-step, every 32-bit read aligned."""
    c_in = cp - 1 if cp > 2 else cp
    rng = np.random.default_rng(10 + cp)
    x16 = rng.integers(1, 0x7F00, size=(2, c_in, 5, 7, 72), dtype=np.uint16)
    for t in [(1, 4, 4, 64), (0, 0, 0, 0)]:
        raw = _raw_box(x16, t, cp, vectorized)
        e = np.full_like(raw, GARBAGE)
        for c, r, q in itertools.product(range(cp), range(ROWS), range((EO + TX + 2 + 7) // 8)):
            w = c * CPW + r * RW + 4 * q  # 4 words from 5 of the raw row
            for i in range(4):
                word = _word(raw, 2 * (w + i)) >> 16 | (_word(raw, 2 * (w + i + 1)) & 0xFFFF) << 16
                e[2 * (w + i) : 2 * (w + i) + 2] = _halves(word)
        for n in range(27 * cp):
            tap, ci = divmod(n, cp)
            kz, ky, kx = _tap(tap)
            off = (XOFF if kx % 2 else EO) + 2 * ci * CPW + (kz * (TY + 2) + ky) * RWE + kx
            box = raw if kx % 2 else e
            for z, y, s, tig in itertools.product(range(TZ), range(TY), range(TX // 16), range(4)):
                v = (z * (TY + 2) + y) * RWE + 16 * s + 2 * tig
                for dx in (0, 8):
                    got = _halves(_word(box, v + off + dx))
                    xv = 16 * s + 2 * tig + dx
                    want = [_logical(x16, t, ci, z + kz, y + ky, xv + e_ + kx) for e_ in (0, 1)]
                    assert list(got) == want, (t, n, z, y, xv)
