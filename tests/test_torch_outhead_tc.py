"""K3 and K4 on the tensor cores (``medseg_torch/kernels/csrc/outhead_tc.cu``)
on the CPU, where no CUDA kernel runs.

- The route predicate ``conv_of.outhead_tc_route``, checked exactly over a
  table of (C, K_pad, dtype).
- The lane-level maps of the kernel, walked as the PTX defines them: the
  swizzled channel-major staging of a 32-voxel segment and the
  ``ldmatrix.x4.trans`` addresses give every element of the m16n8k16 A
  fragment (voxels x channels) exactly once; the head's B fragments and
  the D fragment's (voxel, class) map; the exit's fp32 rows; and the bank
  of every shared-memory access of a quarter-warp or warp, conflict-free.
- The copies of a pass (``issue``: per channel row, the run's aligned
  16-byte chunks, each copied only where it holds a covered voxel, never
  outside the tensor; what the others hold never reaches an unmasked
  value) and ``align8``: every item's 8 voxels at any element offset and
  coverage. The warps' segment walks (``Digits``) visit every segment once.
- A numpy emulation of both kernels, built from those maps: per warp
  segment and pass (K4: the windows that cover the segment's row, in window
  order), the copies, the items shifted into place, the combine with its
  one bf16 rounding, the staged segment, the MMA through the fragment
  maps, the fp32 epilogue in fragment registers (K4: the sum across
  windows), the exit through the fp32 rows (K3: one bf16 rounding, 16-byte
  vectors where aligned; K4: a voxel per lane, its accumulator values from
  the slot copied with the segment's first pass, one rounding to the
  accumulator's dtype, one write per class),
  every output or accumulator element written by one warp only; and each
  instantiation's shared memory (the ring of copy stages, the staged
  segment, K4's accumulator slots) against the H100's. The ring's depth orders the copies in
  time, not what they hold. It is held
  to the plain versions at C 16/32/48/64 and K_pad 8/16/32, at volumes and
  window widths that are not multiples of 8, window x-starts that differ
  mod 8 and a batch of 18 windows, which the wrapper splits (16 + 2), and
  to the JAX package's ``outhead_of`` and ``outhead_row_of`` in interpret
  mode.

Tolerances: against the plain versions, 8e-3 of the largest value for bf16
results (one bf16 rounding of fp32 sums taken in another order: at most one
ulp) and 1e-5 for an fp32 accumulator; against the JAX kernels 1e-2 (they
compute the combine in fp32 and, K4, sum a row in bf16). The kernels
themselves are held to the plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels import conv_of as jconv
from medseg_torch.kernels import conv_of as tconv
from medseg_torch.models.blocks import LEAKY_SLOPE

SEG, WARPS, EPI_PITCH, ROW_CHUNKS = 32, 8, 36, 5  # csrc/outhead_tc.cu
MAXB = tconv.OUTHEAD_ROW_MAX_B
BF, F32 = torch.bfloat16, torch.float32
BLOCK_SMEM, SM_SMEM = 232448, 233472  # H100: shared memory of a block (opt-in), of an SM

ROUTES = [  # (C, K_pad, dtype, tensor cores)
    (16, 8, BF, True), (16, 16, BF, True), (32, 16, BF, True), (48, 8, BF, True),
    (64, 32, BF, True), (16, 32, BF, True),
    (16, 16, F32, False), (16, 24, BF, False), (16, 40, BF, False), (8, 8, BF, False),
    (24, 16, BF, False), (80, 16, BF, False), (16, 16, torch.float16, False),
]


@pytest.mark.parametrize("c,k_pad,dtype,tc", ROUTES)
def test_outhead_tc_route(c, k_pad, dtype, tc):
    assert tconv.outhead_tc_route(c, k_pad, dtype) == tc


def ncm_of(c):
    """The kernel's C slots (16-channel slices) for C: 1, 2, or 4 (48 and 64)."""
    return 1 if c <= 16 else (2 if c <= 32 else 4)


STAGES = 2  # the copy ring's depth


def acc_chunks(acc):
    """Aligned 16-byte chunks holding a run of 32 accumulator values of
    ``acc`` bytes at any alignment."""
    return -(-(32 * acc + 16 - acc) // 16)


def cfg(ncm, nk, acc=0):
    """``Cfg<NCM, NK, ACC>``: a stage's bytes (z and res chunk rows, the
    blend weights), a K4 slot's (the accumulator rows of a segment, ACC
    bytes per value; none for K3), a warp's and a block's bytes."""
    stage_bytes = 2 * 16 * ncm * ROW_CHUNKS * 16 + SEG * 4
    slot_bytes = nk * 8 * acc_chunks(acc) * 16 if acc else 0
    a_bytes, e_bytes = ncm * 16 * SEG * 2, nk * 8 * EPI_PITCH * 4
    warp = STAGES * (stage_bytes + slot_bytes) + max(a_bytes, e_bytes)
    return stage_bytes, slot_bytes, warp, WARPS * warp


@pytest.mark.parametrize("ncm,nk,acc", [(ncm, nk, 0) for ncm in (1, 2, 4) for nk in (1, 2, 4)]
                         + [(ncm, nk, acc) for ncm in (1, 2) for nk in (1, 2, 4) for acc in (2, 4)])
def test_shared_memory_of_each_instantiation(ncm, nk, acc):
    """A warp's ring of stages, its staged segment and, in the same bytes,
    the exit's rows, and K4's ring of accumulator slots, all on 16-byte
    boundaries; a block of 8 warps fits the H100, two of them at the main
    path's widths (C = 16, K_pad 8 or 16)."""
    stage_bytes, slot_bytes, warp, block = cfg(ncm, nk, acc)
    assert stage_bytes % 16 == 0 and slot_bytes % 16 == 0 and warp % 16 == 0
    assert (2 * 16 * ncm * ROW_CHUNKS) % 32 == 0 and (EPI_PITCH * 4) % 16 == 0
    assert acc_chunks(2) == 5 and acc_chunks(4) == 9
    assert block <= BLOCK_SMEM
    if ncm == 1 and nk <= 2:
        assert 2 * block <= SM_SMEM


# ---------------------------------------------------------------------------
# the lane-level maps
# ---------------------------------------------------------------------------

def swz64(c, q):
    """Byte offset of 16-byte chunk q (voxels 8q..8q+7) of channel row c
    (``tc::swz<64>``)."""
    return c * 64 + ((q ^ ((c & 7) >> 1)) << 4)


def a_operand_map(mt, ks):
    """src[row, k]: the bf16 element of the warp's staged segment that the
    lanes' ``ldmatrix.x4.trans`` put at A[row, k] of m16 tile ``mt``, slice
    ``ks``. Lanes 8j..8j+7 give the addresses of matrix j's 8 stored rows;
    with .trans lane l receives stored rows 2(l%4), 2(l%4)+1 at column l/4;
    register j of the A fragment is (row g + 8(j&1), columns 2t + 8(j>>1),
    +1), g = l/4, t = l%4."""
    rows = {}
    for lane in range(32):
        j = lane >> 3
        rows[j, lane & 7] = swz64(16 * ks + (lane & 7) + 8 * (j >> 1), 2 * mt + (j & 1))
    src = np.full((16, 16), -1)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j, h in itertools.product(range(4), range(2)):
            r, k = g + 8 * (j & 1), 2 * t + 8 * (j >> 1) + h
            assert src[r, k] == -1
            src[r, k] = rows[j, 2 * t + h] // 2 + g
    assert (src >= 0).all()
    return src


def b_operand_map(nt, ks):
    """(class, channel) of B[k, n] as the lanes' head registers hold it: b0
    = (rows 2t, 2t+1; column g), b1 = (rows 2t+8, 2t+9; column g), loaded
    as kout[8 nt + g, 16 ks + 8 h + 2 t (+1)]."""
    src = np.full((16, 8, 2), -1)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for h, e in itertools.product(range(2), range(2)):
            k = 2 * t + 8 * h + e
            assert src[k, g, 0] == -1
            src[k, g] = (8 * nt + g, 16 * ks + 8 * h + 2 * t + e)
    return src


def d_fragment_map():
    """(lane, register) -> (row = voxel of the m16 tile, column = class of
    the n8 tile) of the m16n8k16 D fragment."""
    return {(lane, i): ((lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1))
            for lane in range(32) for i in range(4)}


def exit_offset(lane, mt, nt, i):
    """``stage_exit``: the float offset of fragment value i of (mt, nt)."""
    g, t = lane >> 2, lane & 3
    return (8 * nt + 2 * t + (i & 1)) * EPI_PITCH + 16 * mt + g + 8 * (i >> 1)


@pytest.mark.parametrize("mt,ks", list(itertools.product(range(2), range(4))))
def test_ldmatrix_reads_the_staged_segment(mt, ks):
    """A[row, k] = the combined value of voxel 16 mt + row, channel 16 ks +
    k, where the staging stored it (channel row, chunk (voxel)/8 swizzled)."""
    src = a_operand_map(mt, ks)
    for row, k in itertools.product(range(16), range(16)):
        v = 16 * mt + row
        assert src[row, k] == swz64(16 * ks + k, v // 8) // 2 + v % 8


def test_head_and_sum_fragments():
    for nt, ks in itertools.product(range(4), range(4)):
        src = b_operand_map(nt, ks)
        for k, n in itertools.product(range(16), range(8)):
            assert tuple(src[k, n]) == (8 * nt + n, 16 * ks + k)
    d = d_fragment_map()
    assert len(set(d.values())) == 16 * 8
    for mt, nt in itertools.product(range(2), range(4)):
        offs = {exit_offset(lane, mt, nt, i): (16 * mt + d[lane, i][0], 8 * nt + d[lane, i][1])
                for lane in range(32) for i in range(4)}
        assert len(offs) == 128
        for off, (v, n) in offs.items():
            assert off == n * EPI_PITCH + v


def _banks(byte_addrs):
    return [(a // 4) % 32 for a in byte_addrs]


def test_shared_memory_accesses_are_conflict_free():
    # ldmatrix: each matrix's 8 row addresses fall in 8 distinct 16-byte bank groups
    for mt, ks, j in itertools.product(range(2), range(4), range(4)):
        groups = {(swz64(16 * ks + r + 8 * (j >> 1), 2 * mt + (j & 1)) // 16) % 8
                  for r in range(8)}
        assert len(groups) == 8
    # the staging's 16-byte stores, a quarter-warp (8 lanes) at a time
    for k, quarter in itertools.product(range(8), range(4)):
        items = [32 * k + 8 * quarter + x for x in range(8)]
        assert len({(swz64(i >> 2, i & 3) // 16) % 8 for i in items}) == 8
    # the exit's fragment writes: one register of the 32 lanes, 32 banks
    for mt, nt, i in itertools.product(range(2), range(4), range(4)):
        assert len(set(_banks(4 * exit_offset(lane, mt, nt, i) for lane in range(32)))) == 32
    # the exit's 16-byte reads (item: class i >> 2, chunk i & 3), a quarter-warp at a time
    for m, quarter, h in itertools.product(range(4), range(4), range(2)):
        items = [32 * m + 8 * quarter + x for x in range(8)]
        assert len({((i >> 2) * EPI_PITCH + 8 * (i & 3) + 4 * h) // 4 % 8 for i in items}) == 8


# ---------------------------------------------------------------------------
# load8 + align8
# ---------------------------------------------------------------------------

def bf16_bits(x):
    """fp32 -> bf16 bits, round to nearest even (as ``__float2bfloat16``)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_float(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def chunk_voxels(j, s):
    """The run's voxels that aligned chunk j of a channel row holds, the run
    starting s elements into chunk 0 (``chunk_voxels``)."""
    lo = 8 * j - s
    return sum(1 << v for v in range(max(lo, 0), min(lo + 8, SEG)))


STALE = 0x7FC1  # a bf16 NaN: what a stage holds where no copy landed in this pass


def copy_rows(flat, plane, first, c, bm):
    """One tensor's cp.async copies of a pass (``issue``): per channel row
    (element ``c * plane + first`` of ``flat``, bf16 bits of a tensor that
    starts on 16 bytes) its ROW_CHUNKS aligned 16-byte chunks, each copied
    only where it holds a voxel of ``bm``; the others keep what an earlier
    pass left (NaN here, which no unmasked read may see). Returns the rows
    (16 NCM, ROW_CHUNKS, 8), each row's offset s in its first chunk, and the
    number of chunks read."""
    rows = np.full((16 * ncm_of(c), ROW_CHUNKS, 8), STALE, np.uint16)
    shift = np.zeros(16 * ncm_of(c), np.int64)
    n = 0
    for ch in range(c):
        off = ch * plane + first
        s = off & 7
        shift[ch] = s
        for j in range(ROW_CHUNKS):
            if bm & chunk_voxels(j, s):
                a = off - s + 8 * j
                assert 0 <= a and a + 8 <= flat.size  # a chunk read lies inside the tensor
                rows[ch, j] = flat[a : a + 8]
                n += 1
    return rows, shift, n


def align8(lo, hi, s, vm):
    """The kernel's ``align8``, vectorized over items: the 8 elements from
    element s of (lo, hi) (bits, (items, 8) each), those whose bit is clear
    in vm set to 0, by a word shift and a half-word funnel shift."""
    lo, hi = lo.astype(np.uint32), hi.astype(np.uint32)
    s, vm = np.asarray(s, np.int64), np.asarray(vm, np.int64)
    whole = (s == 0) & (vm == 0xFF)  # an aligned, whole item: lo itself
    w = [lo[..., 2 * j] | (lo[..., 2 * j + 1] << 16) for j in range(4)]
    w += [hi[..., 2 * j] | (hi[..., 2 * j + 1] << 16) for j in range(4)]
    # the word shift by s/2: two conditional moves
    w = [np.where(s & 4, w[j + 2], w[j]) if j < 6 else w[j] for j in range(8)]
    w = [np.where(s & 2, w[j + 1], w[j]) if j < 5 else w[j] for j in range(8)]
    out = np.zeros(s.shape + (8,), np.uint16)
    for j in range(4):  # funnel shift by a half word when s is odd, then the mask
        r = np.where(s & 1, ((w[j] >> 16) | (w[j + 1] << 16)) & 0xFFFFFFFF, w[j])
        for e in range(2):
            keep = (vm >> (2 * j + e)) & 1
            out[..., 2 * j + e] = np.where(keep, (r >> (16 * e)) & 0xFFFF, 0)
    return np.where(whole[..., None], lo, out).astype(np.uint16)


def item_values(rows, shift, c, bm):
    """The items (channel, 8-voxel chunk u) = lane + 32 k of a pass: chunks
    u and u + 1 of the channel's row, aligned; returns (items, 8) bits."""
    items = np.arange(ncm_of(c) * 64)
    ch, u = items >> 2, items & 3
    vm = np.where(ch < c, (bm >> (8 * u)) & 0xFF, 0)
    return align8(rows[ch, u], rows[ch, u + 1], shift[ch], vm)


class Digits:
    """The kernel's ``Digits``: segment indices seg, seg + stride, ... as
    mixed-radix digits (fastest first), advanced with carries."""

    def __init__(self, seg, stride, r0, r1):
        self.r0, self.r1 = r0, r1
        self.v = [seg % r0, seg // r0 % r1, seg // r0 // r1]
        self.s = [stride % r0, stride // r0 % r1, stride // r0 // r1]

    def advance(self):
        v0 = self.v[0] + self.s[0]
        c0 = int(v0 >= self.r0)
        v1 = self.v[1] + self.s[1] + c0
        c1 = int(v1 >= self.r1)
        self.v = [v0 - c0 * self.r0, v1 - c1 * self.r1, self.v[2] + self.s[2] + c1]


@pytest.mark.parametrize("r0,r1,warps", [(5, 144, 132 * 16), (6, 192, 7), (1, 3, 2), (4, 1, 5),
                                         (3, 1 << 30, 11)])
def test_digits_walk_each_segment_once(r0, r1, warps):
    """The warps' strided walks, digit by digit, visit every segment of the
    box once, each at its (x, y, z) digits (K4: x-segment, box row y, box
    row z; K3: run, batch element with r1 unbounded)."""
    nseg = r0 * min(r1, 7) * 3
    seen = []
    for w in range(warps):
        d, seg = Digits(w, warps, r0, r1), w
        while seg < nseg:
            assert d.v == [seg % r0, seg // r0 % r1, seg // r0 // r1]
            seen.append(seg)
            seg += warps
            d.advance()
    assert sorted(seen) == list(range(nseg))


def test_rows_and_items_take_the_run_at_any_offset():
    """Every item holds its 8 voxels where the window covers them (0
    elsewhere) at every element offset of the run and coverage; chunks read:
    only those holding a covered voxel (4 for an aligned whole run, 5
    otherwise)."""
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 2**16, size=16 * 96, dtype=np.uint16)
    for first, bm in itertools.product((0, 1, 6, 7, 9, 40, -5, -31), (0xFFFFFFFF, 0x0000FFFF,
                                                                     0xFFFF0000, 0x00FFFF00,
                                                                     0x80000001)):
        # a run left of the tensor's start covers only voxels at element >= 0
        bm &= sum(1 << v for v in range(SEG) if first + v >= 0)
        rows, shift, n = copy_rows(flat, 96, first, 16, bm)
        got = item_values(rows, shift, 16, bm)
        for i, row in enumerate(got):
            ch, u = i >> 2, i & 3
            want = [flat[ch * 96 + first + 8 * u + e] if (bm >> (8 * u + e)) & 1 else 0
                    for e in range(8)]
            assert list(row) == want, (first, bm, i)
        if bm == 0xFFFFFFFF:
            assert n == 16 * (4 if first % 8 == 0 else 5)


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def leaky(t):
    return np.where(t >= 0, t, np.float32(LEAKY_SLOPE) * t).astype(np.float32)


class Head:
    """The warp's head registers, as the (k, n) operand matrices they form:
    B (C_pad, K) bf16 values, bias (K,)."""

    def __init__(self, kout_bits, bias, c, k):
        ncm, nk = ncm_of(c), k // 8
        self.b = np.zeros((16 * ncm, k), np.float32)
        kout = bf16_float(kout_bits)
        for nt, ks in itertools.product(range(nk), range(ncm)):
            if 16 * ks >= c:
                continue  # the kernel loads 0 there and runs no k-step
            src = b_operand_map(nt, ks)
            self.b[16 * ks : 16 * ks + 16, 8 * nt : 8 * nt + 8] = kout[src[..., 0], src[..., 1]]
        self.bias = np.asarray(bias, np.float32)
        self.c, self.nk, self.ncm = c, nk, ncm
        self.a_src = [[a_operand_map(mt, ks) for ks in range(ncm)] for mt in range(2)]

    def mma(self, smem):
        """d[mt][lane, reg, nt] of the segment staged in ``smem`` (bf16
        bits of the warp's A bytes): sum over the k-steps 16 ks < C."""
        d = np.zeros((2, 32, 4, self.nk), np.float32)
        fmap = d_fragment_map()
        for mt in range(2):
            nc = -(-self.c // 16)
            a = np.concatenate([bf16_float(smem[self.a_src[mt][ks]]) for ks in range(nc)], 1)
            dm = a @ self.b[: 16 * nc]  # (16 voxels, K) fp32
            for (lane, i), (row, col) in fmap.items():
                d[mt, lane, i] = dm[row, col::8][: self.nk]
        return d


def stage(z, r, plane, first, coef, c, bm):
    """One pass of the warp's segment: the copies of z and r (bf16 bits,
    tensors from a 16-byte boundary), the items shifted into place, the
    combine with coefficients ``coef`` (4, C) of the pass's window, one bf16
    rounding, stored at ``swz64``. Returns the A bytes as bf16 bits."""
    ncm = ncm_of(c)
    items = np.arange(ncm * 64)
    ch, q = items >> 2, items & 3
    zb = item_values(*copy_rows(z, plane, first, c, bm)[:2], c, bm)
    rb = item_values(*copy_rows(r, plane, first, c, bm)[:2], c, bm)
    cc = np.minimum(ch, c - 1)[:, None]
    az, bz, ar, br = (coef[i][cc] for i in range(4))
    t = bf16_float(zb) * az + bz + bf16_float(rb) * ar + br
    comb = bf16_bits(leaky(t.astype(np.float32)))
    smem = np.zeros(ncm * 16 * SEG, np.uint16)
    for i in items[ch < c]:
        base = swz64(int(ch[i]), int(q[i])) // 2
        smem[base : base + 8] = comb[i]
    return smem


def lane_weights(scale, sfirst, bm):
    """Each lane's blend weight (one 4-byte load where the window covers
    its voxel, 0 elsewhere; 1 without a weight)."""
    lanes = np.arange(SEG)
    if scale is None:
        return np.ones(SEG, np.float32)
    cov = (bm >> lanes) & 1
    return np.where(cov, scale[np.where(cov, sfirst + lanes, 0)], 0).astype(np.float32)


def exit_rows(frag, nk):
    """``stage_exit``: the fragment values (2, 32, 4, NK) as the exit's fp32
    rows (NK * 8 classes x 36)."""
    e = np.full(nk * 8 * EPI_PITCH, np.nan, np.float32)
    for mt, lane, i, nt in itertools.product(range(2), range(32), range(4), range(nk)):
        e[exit_offset(lane, mt, nt, i)] = frag[mt, lane, i, nt]
    return e


def _voxel_class(lane, i, mt, nt):
    row, col = d_fragment_map()[lane, i]
    return 16 * mt + row, 8 * nt + col


def _inputs(z, res, az, bz, ar, br, kout):
    bits = [bf16_bits(t.float().numpy()).reshape(-1) for t in (z, res)]
    coef = np.stack([t.float().numpy() for t in (az, bz, ar, br)])  # (4, B, C)
    return bits, coef, bf16_bits(kout.float().numpy())


def emulate_outhead_tc(z, res, az, bz, ar, br, kout, bias, scale=None):
    """K3's kernel on CPU tensors: (B, K_pad, D, H, W) bf16 logits, and the
    numbers of exit items stored as one 16-byte vector and value by value."""
    bsz, c, *vol = z.shape
    k = kout.shape[0]
    v_n = int(np.prod(vol))
    (zf, rf), coef, kbits = _inputs(z, res, az, bz, ar, br, kout)
    head = Head(kbits, bias.numpy(), c, k)
    sflat = None if scale is None else scale.numpy().reshape(-1)
    out = np.zeros(bsz * k * v_n, np.uint16)
    written = np.zeros(out.size, np.int64)
    paths = {"vector": 0, "values": 0}
    nvs = -(-v_n // SEG)
    for seg in range(bsz * nvs):  # the warps' segments, in any order
        b, v0 = seg // nvs, (seg % nvs) * SEG
        n = min(SEG, v_n - v0)
        bm = (1 << n) - 1
        smem = stage(zf, rf, v_n, b * c * v_n + v0, coef[:, b], c, bm)
        d = head.mma(smem)
        sc = lane_weights(sflat, b * v_n + v0, bm)
        frag = np.zeros_like(d)
        for mt, lane, i in itertools.product(range(2), range(32), range(4)):
            v, _ = _voxel_class(lane, i, mt, 0)
            bias_i = head.bias[[8 * nt + 2 * (lane & 3) + (i & 1) for nt in range(head.nk)]]
            frag[mt, lane, i] = ((d[mt, lane, i] + bias_i) * sc[v]).astype(np.float32)
        e = exit_rows(frag, head.nk)
        for item in range(head.nk * 32):
            cls, j = item >> 2, item & 3
            vm = (bm >> (8 * j)) & 0xFF
            if not vm:
                continue
            vals = e[cls * EPI_PITCH + 8 * j : cls * EPI_PITCH + 8 * j + 8]
            o = (b * k + cls) * v_n + v0 + 8 * j
            paths["vector" if vm == 0xFF and o % 8 == 0 else "values"] += 1
            for x in range(8):
                if (vm >> x) & 1:
                    out[o + x] = bf16_bits(vals[x : x + 1])[0]
                    written[o + x] += 1
    assert (written == 1).all()  # every logit stored once
    logits = torch.from_numpy(bf16_float(out).reshape(bsz, k, *vol)).to(BF)
    return logits, paths


def acc_slot(a, row, va, k, n_in, acc):
    """K4's slot of a segment (``issued``): per class, the aligned 16-byte
    chunks of its accumulator row (element ``row`` of class plane cls, values
    of ``acc`` bytes, the tensor starting on 16 bytes) that hold a voxel of
    the row (x < Wp: the first ``n_in`` of the segment); then each lane's
    value read at s + lane. Returns (K, 32) values (NaN where no chunk
    landed)."""
    epc = 16 // acc
    in_row = (1 << min(n_in, SEG)) - 1
    out = np.full((k, SEG), np.nan, np.float32)
    for cls in range(k):
        off = cls * va + row
        s = off % epc
        chunks = np.full((acc_chunks(acc), epc), np.nan, np.float32)
        for j in range(acc_chunks(acc)):
            lo = epc * j - s
            held = sum(1 << v for v in range(max(lo, 0), min(lo + epc, SEG)))
            if in_row & held:
                base = off - s + epc * j
                assert 0 <= base and base + epc <= a.size  # inside the accumulator
                chunks[j] = a[base : base + epc]
        out[cls] = chunks.reshape(-1)[s : s + SEG]
    return out


def emulate_outhead_row_tc(z, res, az, bz, ar, br, kout, bias, scale, starts, acc):
    """K4 on CPU tensors, launch by launch as the wrapper splits the batch
    (16 windows at most): updates ``acc`` in place; returns the numbers of
    passes (segment, window) and segment exits."""
    bsz, c, rd, rh, rw = z.shape
    k = kout.shape[0]
    v_n = rd * rh * rw
    _, dp, hp, wp = acc.shape
    va = dp * hp * wp
    (zf, rf), coef, kbits = _inputs(z, res, az, bz, ar, br, kout)
    head = Head(kbits, bias.numpy(), c, k)
    sflat = scale.numpy().reshape(-1)
    a = acc.float().numpy().reshape(-1).copy()
    rows = [tuple(int(v) for v in s) for s in starts]
    paths = {"exits": 0, "passes": 0}
    for i0 in range(0, bsz, MAXB):
        part = rows[i0 : i0 + MAXB]
        lo, ext = tconv._window_box(part, (rd, rh, rw))
        xa = lo[2] - (lo[2] & 7)
        nsx = -(-(lo[2] + ext[2] - xa) // SEG)
        # the launch's tensors start at window i0: a multiple of 16 bytes (C % 16 == 0)
        zl, rl = zf[i0 * c * v_n :], rf[i0 * c * v_n :]
        written = np.zeros(a.size, np.int64)
        for seg in range(ext[0] * ext[1] * nsx):
            rowi, sx = divmod(seg, nsx)
            gd, gh = lo[0] + rowi // ext[1], lo[1] + rowi % ext[1]
            gx0 = xa + SEG * sx
            acc_frag = np.zeros((2, 32, 4, head.nk), np.float32)
            cov = 0
            for b, (sd, sh, sw) in enumerate(part):  # in window order
                ld, lh, lw0 = gd - sd, gh - sh, gx0 - sw
                x_lo, x_hi = max(-lw0, 0), min(rw - lw0, SEG)
                if not (0 <= ld < rd and 0 <= lh < rh and x_lo < x_hi):
                    continue
                bm = ((1 << (x_hi - x_lo)) - 1) << x_lo
                cov |= bm
                row = (ld * rh + lh) * rw + lw0
                paths["passes"] += 1
                smem = stage(zl, rl, v_n, b * c * v_n + row, coef[:, i0 + b], c, bm)
                d = head.mma(smem)
                sc = lane_weights(sflat[i0 * v_n :], b * v_n + row, bm)
                for mt, lane, i in itertools.product(range(2), range(32), range(4)):
                    v, _ = _voxel_class(lane, i, mt, 0)
                    if (bm >> v) & 1:
                        bias_i = head.bias[[8 * nt + 2 * (lane & 3) + (i & 1)
                                            for nt in range(head.nk)]]
                        acc_frag[mt, lane, i] = (acc_frag[mt, lane, i]
                                                 + (d[mt, lane, i] + bias_i) * sc[v])
            if not cov:
                continue
            # the exit: one voxel per lane, its value of every class from the
            # slot copied with the segment's first pass (no window writes acc
            # in between), one rounding, one write
            e = exit_rows(acc_frag, head.nk)
            slot = acc_slot(a, (gd * hp + gh) * wp + gx0, va, k, wp - gx0, acc.element_size())
            paths["exits"] += 1
            for lane in range(SEG):
                if not (cov >> lane) & 1:
                    continue
                at = (gd * hp + gh) * wp + gx0 + lane
                assert gx0 + lane < wp  # a covered voxel lies inside the accumulator's row
                for cls in range(k):
                    assert slot[cls][lane] == a[cls * va + at]
                    s = np.float32(slot[cls][lane]) + e[cls * EPI_PITCH + lane]
                    a[cls * va + at] = bf16_float(bf16_bits(np.float32([s])))[0] if acc.dtype == BF else s
                    written[cls * va + at] += 1
        assert written.max() <= 1  # one warp owns each accumulator voxel
    acc.copy_(torch.from_numpy(a.reshape(acc.shape)).to(acc.dtype))
    return paths


def head_inputs(rng, bsz, c, k, vol, n_classes=None):
    """bf16 z, res, head; fp32 affines, bias and weight (B, 1, *vol) in
    [0.2, 1)."""
    def bf(*shape, s=1.0):
        return torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32)).to(BF)

    n_classes = k if n_classes is None else n_classes
    kout = bf(k, c, s=c**-0.5)
    kout[n_classes:] = 0
    aff = [torch.from_numpy(rng.uniform(0.5, 1.5, size=(bsz, c)).astype(np.float32)),
           torch.from_numpy((0.5 * rng.normal(size=(bsz, c))).astype(np.float32)),
           torch.from_numpy(rng.uniform(0.5, 1.5, size=(bsz, c)).astype(np.float32)),
           torch.from_numpy((0.5 * rng.normal(size=(bsz, c))).astype(np.float32))]
    bias = torch.from_numpy((0.1 * rng.normal(size=k)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.2, 1.0, size=(bsz, 1, *vol)).astype(np.float32))
    return bf(bsz, c, *vol), bf(bsz, c, *vol), aff, kout, bias, scale


def _close(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("c,k,vol,scaled", [
    (16, 8, (3, 5, 9), True),     # V = 135: ragged last segment, planes off 16 bytes
    (16, 16, (2, 4, 8), False),   # V = 64: aligned, no weight
    (32, 32, (3, 3, 7), True),
    (48, 16, (2, 3, 11), True),   # 3 of the 4 C slots
    (64, 32, (2, 2, 8), True),
])
def test_outhead_tc_emulation_matches_plain(c, k, vol, scaled):
    rng = np.random.default_rng(c + k)
    z, r, aff, kout, bias, scale = head_inputs(rng, 2, c, k, vol)
    scale = scale if scaled else None
    got, paths = emulate_outhead_tc(z, r, *aff, kout, bias, scale)
    want = tconv.outhead_of_plain(z, r, *aff, kout, bias, scale)
    _close(got, want, 8e-3)
    assert paths["vector"] > 0
    assert (paths["values"] > 0) == (int(np.prod(vol)) % 8 != 0)


@pytest.mark.parametrize("c,k,acc_dtype,roi,starts", [
    # x-starts 0, 7, 19, 32 (mod 8: 0, 7, 3, 0), roi 13 wide, Wp 45
    (16, 16, BF, (3, 4, 13), [(0, 0, 0), (0, 2, 7), (1, 0, 19), (2, 3, 32)]),
    (16, 8, F32, (3, 4, 13), [(0, 0, 0), (0, 2, 7), (1, 0, 19), (2, 3, 32)]),
    (32, 32, BF, (2, 3, 10), [(0, 0, 2), (0, 0, 30), (1, 1, 12)]),
    (32, 16, F32, (2, 3, 10), [(1, 1, 5), (0, 0, 0), (0, 2, 33)]),
])
def test_outhead_row_tc_emulation_matches_plain(c, k, acc_dtype, roi, starts):
    rng = np.random.default_rng(c + k + len(starts))
    z, r, aff, kout, bias, scale = head_inputs(rng, len(starts), c, k, roi)
    init = torch.from_numpy(rng.normal(size=(k, 5, 8, 45)).astype(np.float32)).to(acc_dtype)
    got, want = init.clone(), init.clone()
    paths = emulate_outhead_row_tc(z, r, *aff, kout, bias, scale, starts, got)
    tconv.outhead_row_of_plain(z, r, *aff, kout, bias, scale, starts, want)
    _close(got, want, 1e-5 if acc_dtype == F32 else 8e-3)
    covered = torch.zeros(init.shape[1:], dtype=torch.bool)
    for d, h, w in starts:
        covered[d : d + roi[0], h : h + roi[1], w : w + roi[2]] = True
    assert torch.equal(got[:, ~covered], init[:, ~covered])  # untouched
    assert paths["passes"] > paths["exits"] > 0  # segments that several windows cover


def test_outhead_row_tc_emulation_splits_large_batches():
    """18 windows along one z-row (x-starts 0, 2, ..., 34, all offsets mod
    8): the wrapper's launches of 16 and 2, each rounded once into a bf16
    accumulator, within one rounding per launch of the plain version."""
    rng = np.random.default_rng(18)
    roi = (2, 2, 9)
    starts = [(0, 0, 2 * i) for i in range(18)]
    z, r, aff, kout, bias, scale = head_inputs(rng, 18, 16, 8, roi)
    init = torch.zeros((8, 2, 2, 48), dtype=BF)
    got, want = init.clone(), init.clone()
    paths = emulate_outhead_row_tc(z, r, *aff, kout, bias, scale, starts, got)
    tconv.outhead_row_of_plain(z, r, *aff, kout, bias, scale, starts, want)
    _close(got, want, 2 * 8e-3)  # two launches: two roundings of the running value
    # per (z, y) row of 4: the first launch's 16 windows over its first x-segment and
    # windows 12-15 over its second (x >= 32); the second launch's 2 over its one
    assert paths["passes"] == 4 * (16 + 4) + 4 * 2


def test_outhead_tc_emulation_matches_pallas():
    """K3's emulation against the JAX ``outhead_of`` (interpret mode, the
    non-transposed form) at 2 x 3x6x10 (V = 180, not a multiple of 8),
    C = 16, 3 classes padded to 8, weighted."""
    rng = np.random.default_rng(3)
    vol = (3, 6, 10)
    z, r, aff, kout, bias, scale = head_inputs(rng, 2, 16, 8, vol, n_classes=3)
    bias[3:] = 0
    got, _ = emulate_outhead_tc(z, r, *aff, kout, bias, scale)

    def ndhwc(t):
        return jnp.asarray(t.float().numpy().transpose(0, 2, 3, 4, 1))

    ref = jconv.outhead_of(
        jconv.to_output_form(ndhwc(z)), jconv.to_output_form(ndhwc(r)),
        *(jnp.asarray(a.numpy())[..., None] for a in aff), jnp.asarray(kout.float().numpy()),
        jnp.asarray(bias.numpy())[:, None], jconv.to_output_form(ndhwc(scale)),
        out_dtype=jnp.float32, interpret=True, transposed=False,
    )
    ref = np.array(jconv.from_output_form(ref, vol[1], vol[2], dpad=0))  # (B, D, H, W, K)
    _close(got.permute(0, 2, 3, 4, 1), torch.from_numpy(ref), 1e-2)


def test_outhead_row_tc_emulation_matches_pallas():
    """K4's emulation against the JAX ``outhead_row_of`` (interpret mode) on
    two rows of two 16x20x20 windows at x-starts 0 and 10 of a 30-wide row
    (neither the roi nor Wp a multiple of 8), C = 16, 3 classes padded to 8
    (zpack 16), as ``tests/test_torch_swi_zrow.py`` unpacks the JAX row."""
    rng = np.random.default_rng(4)
    n_w, g, d, s, k = 2, 2, 16, 20, 8
    w_starts2, wp_half = (0, 5), 15
    z, r, aff, kout, bias, scale = head_inputs(rng, n_w * g, 16, k, (d, s, s), n_classes=3)
    bias[3:] = 0

    def ndhwc(t):
        return jnp.asarray(t.float().numpy().transpose(0, 2, 3, 4, 1))

    row = jconv.outhead_row_of(
        jconv.to_pp(ndhwc(z), jnp.float32), jconv.to_pp(ndhwc(r), jnp.float32),
        *(jnp.asarray(a.numpy())[..., None] for a in aff), jnp.asarray(kout.float().numpy()),
        jnp.asarray(bias.numpy())[:, None], jconv.to_pp(ndhwc(scale), jnp.float32), n_w=n_w,
        w_starts2=w_starts2, wp_half=wp_half, rh2=s // 2, rw2=s // 2, zpack=16, interpret=True,
    )
    want = np.asarray(row, np.float32).reshape(g, 1, 2, 2, s // 2, wp_half, 16, k)
    want = want.transpose(0, 1, 6, 4, 2, 5, 3, 7).reshape(g, d, s, 2 * wp_half, k)
    acc = torch.zeros((k, d, g * s, 2 * wp_half))
    starts = [(0, gg * s, 2 * w_starts2[wi]) for wi in range(n_w) for gg in range(g)]
    emulate_outhead_row_tc(z, r, *aff, kout, bias, scale, starts, acc)
    got = acc.numpy().reshape(k, d, g, s, 2 * wp_half).transpose(2, 1, 3, 4, 0)
    _close(torch.from_numpy(got), torch.from_numpy(want), 1e-2)
