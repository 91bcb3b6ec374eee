"""K7 and K8 as ``medseg_torch/kernels/csrc/loss_of.cu`` computes them, on
the CPU, where no CUDA kernel runs: a numpy emulation of the kernels' walk.

- The route: 16-byte words of ``VEC`` voxels (8 in bf16, 4 in fp32) where
  ``V % VEC == 0`` (``loss_of.vector_route``), else one voxel per unit; a
  grid-stride walk of each batch element's units by ``blocks`` blocks of
  256 threads, each thread's units in order and, in a group, its voxels
  in order.
- K7 per voxel: the softmax in base 2 (``ex2`` of log2e-scaled logits less
  their maximum, one reciprocal of z), CE as ``log z + m - l_y``, P and
  CE in the thread's registers, I and G in its own shared-memory column keyed by the label; then the
  block's fixed-order reduction (P and CE: the lanes by xor shuffles, then
  the warps in order; I and G: each lane its 8 columns in order, then the
  lanes), one row of 3K + 1 partials per block, and the finish (a lane per
  32 blocks, in block order, then the lanes), written into the wrapper's
  one buffer and split as the wrapper splits it.
- K8 per voxel: ``dl_k = p_k*(cb_k + cec - pu) + [k == y]*(p_y*ca_y - cec)``
  with ``pu = sum_k p_k*cb_k + p_y*ca_y``, rounded once to the logits'
  dtype (bf16: to nearest even).
- Every logit and label is read once by each kernel and every dlogit
  written once.

Held to ``dice_ce_sums_plain`` / ``dice_ce_bwd_plain`` and, for the loss and
its gradient, to the JAX package's ``_sums`` and ``dice_ce_fused`` in
interpret mode, at ragged shapes: V % 8 in {0, 3, 4, 7}, V smaller than one
block's share, B in {1, 3}, K in {1, 2, 14, 16}, one to three blocks.
Tolerances: the sums 1e-5 relative with a 1e-5 floor (fp32 sums in
another order; G is a count and must be exact); CE 1e-5 relative with a
floor of 1e-6 per voxel (the kernels' exp takes ``fma(l, log2e, -m*log2e)``,
whose rounding leaves about 1e-7 in ``log z`` even where p[label] is 1, as
at K = 1); dlogits 1e-5 of max(1, their largest value) in fp32 (``dl =
p*(cb + cec - pu) + corr`` cancels, so its errors are absolute, not
relative) and 8e-3 in bf16 (one bf16 rounding of fp32 values that differ
in the last bits: at most one ulp); the loss against JAX 1e-5 and its
gradient 1e-5 of its largest value. The
kernels themselves are held to the plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg.kernels import loss_of as jlo
from medseg_torch.kernels import loss_of as tlo

T = tlo.THREADS
WARPS = T // 32
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
F32 = np.float32

# (B, K, (D, H, W), dtype, blocks per batch element)
CASES = [
    (1, 14, (4, 8, 8), torch.bfloat16, 1),  # V % 8 == 0, V below one block's share
    (3, 2, (3, 3, 3), torch.float32, 1),  # V % 8 == 3: one voxel per unit
    (3, 16, (5, 5, 7), torch.bfloat16, 2),  # V % 8 == 7
    (1, 1, (4, 9, 10), torch.float32, 1),  # V % 8 == 0, fp32 words of 4 voxels
    (1, 2, (3, 4, 11), torch.float32, 1),  # V % 8 == 4: words in fp32...
    (1, 2, (3, 4, 11), torch.bfloat16, 1),  # ...one voxel per unit in bf16
    (3, 14, (16, 16, 20), torch.bfloat16, 2),  # grid-stride walk over 2 blocks
    (3, 14, (16, 16, 20), torch.float32, 3),
]
IDS = [f"B{b}-K{k}-{'x'.join(map(str, s))}-{str(dt)[6:]}-{n}blk" for b, k, s, dt, n in CASES]


def _fma(a, b, c):
    """fmaf: one rounding of the exact product plus c (float32 operands)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _butterfly(v):
    """warp_sum over the last axis (32 lanes): lane 0's xor-shuffle sum."""
    v = v.astype(F32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v[..., 0]


def _walk(n_vox, dtype, blocks):
    """Per (block, iteration): the voxels (threads x VEC) of each thread's
    unit, -1 where the thread has none; the kernel's grid-stride order."""
    vec = tlo.vec_of(dtype) if n_vox % tlo.vec_of(dtype) == 0 else 1
    units = n_vox // vec
    steps = []
    for bx in range(blocks):
        its = []
        u = bx * T + np.arange(T)
        while (u < units).any():
            vox = u[:, None] * vec + np.arange(vec)[None, :]
            its.append(np.where((u < units)[:, None], vox, -1))
            u = u + blocks * T
        steps.append(its)
    return vec, steps


def _softmax2(l):
    """(threads, K) logits -> e (threads, K), m, mz, z, 1/z as the kernel
    takes them."""
    m = l.max(axis=1)
    mz = (m * LOG2E).astype(F32)
    e = np.exp2(_fma(l, LOG2E, -mz[:, None]))
    z = np.zeros(len(l), F32)
    for k in range(l.shape[1]):
        z = (z + e[:, k]).astype(F32)
    return e, m, mz, z, (F32(1) / z).astype(F32)


def emulate_sums(logits, labels, dtype, blocks):
    """K7 then its finish: the wrapper's (ce, inter, pred, ground), and the
    read counts of logits and labels."""
    bsz, k, n_vox = logits.shape
    n = 3 * k + 1
    _, steps = _walk(n_vox, dtype, blocks)
    reads, label_reads = np.zeros(logits.shape, int), np.zeros(labels.shape, int)
    partial = np.zeros((bsz, blocks, n), F32)
    tids = np.arange(T)
    for b in range(bsz):
        for bx, its in enumerate(steps):
            sp, sce = np.zeros((T, k), F32), np.zeros(T, F32)
            s_i, s_g = np.zeros((k, T), F32), np.zeros((k, T), F32)
            for vox in its:
                for j in range(vox.shape[1]):
                    act = vox[:, j] >= 0
                    v = vox[act, j]
                    reads[b, :, v] += 1
                    label_reads[b, v] += 1
                    l, y = logits[b][:, v].T, labels[b, v]
                    e, m, mz, z, rz = _softmax2(l)
                    sp[act] = _fma(e, rz[:, None], sp[act])
                    ly = l[np.arange(len(v)), y]
                    sce[act] = (sce[act] + _fma(np.log2(z), LN2, (m - ly).astype(F32))).astype(F32)
                    py = (np.exp2(_fma(ly, LOG2E, -mz)) * rz).astype(F32)
                    t = tids[act]
                    s_i[y, t] = (s_i[y, t] + py).astype(F32)
                    s_g[y, t] += 1
            row = partial[b, bx]
            sp_w = _butterfly(sp.T.reshape(k, WARPS, 32))  # (K, warps)
            ce_w = _butterfly(sce.reshape(WARPS, 32))
            for kk in range(k):
                for comp, cols in ((0, s_i), (2, s_g)):
                    lanes = np.zeros(32, F32)
                    for i in range(WARPS):
                        lanes = (lanes + cols[kk, 32 * i:32 * i + 32]).astype(F32)
                    row[comp * k + kk] = _butterfly(lanes)
                acc = F32(0)
                for w in range(WARPS):
                    acc = F32(acc + sp_w[kk, w])
                row[k + kk] = acc
            acc = F32(0)
            for w in range(WARPS):
                acc = F32(acc + ce_w[w])
            row[3 * k] = acc
    # the finish into the wrapper's buffer: ce (B,), inter, pred, ground (B, K)
    buf = np.full(bsz * n * (1 + blocks), np.nan, F32)
    for b in range(bsz):
        for j in range(n):
            lanes = np.zeros(32, F32)
            for bx in range(blocks):
                lanes[bx % 32] = F32(lanes[bx % 32] + partial[b, bx, j])
            s = _butterfly(lanes)
            if j == 3 * k:
                buf[b] = s
            else:
                buf[bsz + (j // k) * bsz * k + b * k + j % k] = s
    out = torch.from_numpy(buf)
    ce = out[:bsz]
    inter, pred, ground = out[bsz:bsz * n].view(3, bsz, k).unbind(0)
    return (ce, inter, pred, ground), reads, label_reads


def emulate_bwd(logits, labels, ca, cb, cec, dtype, blocks):
    """K8: dlogits (in fp32 holding the dtype's values) and the read and
    write counts."""
    bsz, k, n_vox = logits.shape
    _, steps = _walk(n_vox, dtype, blocks)
    reads, label_reads = np.zeros(logits.shape, int), np.zeros(labels.shape, int)
    writes = np.zeros(logits.shape, int)
    dl = np.full(logits.shape, np.nan, F32)
    for b in range(bsz):
        for its in steps:
            for vox in its:
                for j in range(vox.shape[1]):
                    v = vox[vox[:, j] >= 0, j]
                    reads[b, :, v] += 1
                    label_reads[b, v] += 1
                    l, y = logits[b][:, v].T, labels[b, v]
                    e, _, mz, z, rz = _softmax2(l)
                    p = (e * rz[:, None]).astype(F32)
                    pu = np.zeros(len(v), F32)
                    for kk in range(k):
                        pu = _fma(p[:, kk], cb[b, kk], pu)
                    ty = _fma(l[np.arange(len(v)), y], LOG2E, -mz)
                    py = (np.exp2(ty) * rz).astype(F32)
                    ay = ca[b, y]
                    pu = _fma(py, ay, pu)
                    t = (cec[b] - pu).astype(F32)
                    corr = _fma(py, ay, -cec[b])
                    onehot = np.arange(k)[None, :] == y[:, None]
                    d = _fma(p, (cb[b][None, :] + t[:, None]).astype(F32),
                             np.where(onehot, corr[:, None], F32(0)))
                    dl[b][:, v] = d.T
                    writes[b, :, v] += 1
    out = torch.from_numpy(dl).to(dtype).float().numpy()  # one rounding to the dtype
    return out, reads, label_reads, writes


def _data(rng, bsz, k, shape, dtype):
    logits = torch.from_numpy((3.0 * rng.normal(size=(bsz, k, *shape))).astype(np.float32))
    logits = logits.to(dtype)  # the values the kernel reads
    labels = rng.integers(0, k, size=(bsz, *shape)).astype(np.int32)
    return logits, torch.from_numpy(labels)


def _coefs(rng, bsz, k):
    ca = rng.normal(size=(bsz, k)).astype(np.float32)
    cb = rng.normal(size=(bsz, k)).astype(np.float32)
    cec = rng.uniform(0.5, 1.5, size=(bsz,)).astype(np.float32)
    return ca, cb, cec


def _flat(logits, labels):
    bsz, k = logits.shape[:2]
    return logits.float().reshape(bsz, k, -1).numpy(), labels.reshape(bsz, -1).numpy()


@pytest.mark.parametrize("bsz,k,shape,dtype,blocks", CASES, ids=IDS)
def test_emulated_sums_match_plain(rng, bsz, k, shape, dtype, blocks):
    logits, labels = _data(rng, bsz, k, shape, dtype)
    lg, lab = _flat(logits, labels)
    got, reads, label_reads = emulate_sums(lg, lab, dtype, blocks)
    assert (reads == 1).all() and (label_reads == 1).all()
    want = tlo.dice_ce_sums_plain(logits, labels)
    n_vox = labels[0].numel()
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6 * n_vox)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())


@pytest.mark.parametrize("bsz,k,shape,dtype,blocks", CASES, ids=IDS)
def test_emulated_bwd_matches_plain(rng, bsz, k, shape, dtype, blocks):
    logits, labels = _data(rng, bsz, k, shape, dtype)
    ca, cb, cec = _coefs(rng, bsz, k)
    lg, lab = _flat(logits, labels)
    got, reads, label_reads, writes = emulate_bwd(lg, lab, ca, cb, cec, dtype, blocks)
    assert (reads == 1).all() and (label_reads == 1).all() and (writes == 1).all()
    want = tlo.dice_ce_bwd_plain(logits, labels, *map(torch.from_numpy, (ca, cb, cec)))
    want = want.float().reshape(bsz, k, -1).numpy()
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def test_vector_route_follows_v_and_alignment():
    x = torch.zeros(64, dtype=torch.float32)
    assert tlo.vector_route(360, torch.float32, x) and tlo.vector_route(360, torch.bfloat16, x)
    assert tlo.vector_route(132, torch.float32, x) and not tlo.vector_route(132, torch.bfloat16, x)
    assert not tlo.vector_route(27, torch.float32, x)
    assert not tlo.vector_route(360, torch.float32, x[1:])  # a start off 16 bytes
    assert (tlo.vec_of(torch.bfloat16), tlo.vec_of(torch.float32)) == (8, 4)


def _of_form(logits):
    """(B, K, D, H, W) -> the JAX kernels' (B, D, CO_pad, H*W)."""
    bsz, k, d, h, w = logits.shape
    co = max(8, -(-k // 8) * 8)
    lg = jnp.asarray(logits.numpy()).transpose(0, 2, 1, 3, 4).reshape(bsz, d, k, h * w)
    return jnp.pad(lg, ((0, 0), (0, 0), (0, co - k), (0, 0)))


# fp32 cases: the JAX kernels compute in fp32 from the same values
JAX_CASES = [c for c in CASES if c[3] == torch.float32] + [(1, 14, (4, 8, 8), torch.float32, 1)]


@pytest.mark.parametrize("bsz,k,shape,dtype,blocks", JAX_CASES,
                         ids=[IDS[CASES.index(c)] if c in CASES else "B1-K14-4x8x8-float32-1blk"
                              for c in JAX_CASES])
def test_emulated_sums_match_pallas(rng, bsz, k, shape, dtype, blocks):
    logits, labels = _data(rng, bsz, k, shape, dtype)
    got, _, _ = emulate_sums(*_flat(logits, labels), dtype, blocks)
    d, h, w = shape
    want = jlo._sums(_of_form(logits), jnp.asarray(labels.numpy()).reshape(bsz, d, h * w), k, True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6 * d * h * w)
    for g, wt in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt)[:, :k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bsz,k,shape", [(3, 2, (3, 3, 3)), (1, 14, (4, 8, 8))],
                         ids=["B3-K2-3x3x3", "B1-K14-4x8x8"])
def test_emulated_loss_and_gradient_match_pallas(rng, bsz, k, shape):
    """The loss assembled as ``DiceCEFn`` assembles it from the emulated K7,
    its gradient through the emulated K8 on ``DiceCEFn.backward``'s
    coefficients, against the JAX fused loss's value and gradient."""
    logits, labels = _data(rng, bsz, k, shape, torch.float32)
    lg, lab = _flat(logits, labels)
    (ce, inter, pred, ground), _, _ = emulate_sums(lg, lab, torch.float32, 1)
    denom = ground + pred + tlo._DR
    loss = (1.0 - (2.0 * inter + tlo._NR) / denom).mean() + ce.sum() / labels.numel()
    inv_bc = 1.0 / (bsz * k)
    ca = -2.0 * inv_bc / denom
    cb = inv_bc * (2.0 * inter + tlo._NR) / denom.square()
    cec = torch.full((bsz,), 1.0 / labels.numel())
    grad, _, _, _ = emulate_bwd(lg, lab, ca.numpy(), cb.numpy(), cec.numpy(), torch.float32, 1)
    nd = jnp.asarray(np.moveaxis(logits.numpy(), 1, -1))
    want, g_want = jax.value_and_grad(
        lambda x: jlo.dice_ce_fused(x, jnp.asarray(labels.numpy()), interpret=True))(nd)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    g_want = np.asarray(g_want)
    err = np.abs(np.moveaxis(grad.reshape(logits.shape), 1, -1) - g_want).max()
    assert err <= 1e-5 * np.abs(g_want).max()
