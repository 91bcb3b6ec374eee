"""The affine instance norm of the conv blocks (N1), with the leaky ReLU and
the residual add that follow it folded in.

``instance_norm(x, weight, bias, eps, leaky=..., residual=...)`` is what
``models.blocks.InstanceNorm`` calls: per (b, c) plane of an NCDHW tensor,
``act(weight * (x - mean) * rstd + bias [+ residual])``, statistics in fp32
whatever x's dtype, the output in x's dtype, ``act`` the blocks' leaky ReLU
(slope 0.01) or none.

- On a CPU tensor it runs the plain version, ``instance_norm_fwd_plain``:
  separate PyTorch operations in the blocks' order (an fp32 norm, the cast
  to x's dtype, ``+ residual``, the leaky ReLU), through autograd;
- on a CUDA tensor in fp32 or bf16, ``InstanceNormFn``: its forward is
  ``instance_norm_fwd`` and its backward ``instance_norm_bwd``, each a pair
  of kernels of ``csrc/instnorm.cu`` (one kernel for a plane that fits 64 KB
  of shared memory); any other dtype raises. The kernels compute
  ``weight * xhat + bias + residual`` in fp32 and round once; the backward
  keeps x, the residual and the per-plane mean and rstd (fp32, (B, C)), and
  recomputes the forward's pre-activation bit for bit to take the leaky
  ReLU's slope. A residual of another dtype than x (the promoting add of
  the blocks) takes the kernel without residual or activation, then the add
  and the leaky ReLU in PyTorch.

``instance_norm_fwd`` / ``instance_norm_bwd`` run their plain versions on a
CPU tensor (``instance_norm_fwd_plain``, ``instance_norm_bwd_plain``: the
backward in closed form, ``dx = weight * rstd * (dz - mean(dz) - xhat *
mean(dz * xhat))``) and launch on a CUDA one. Which kernels run is decided by
the plane size V alone: ``plane_route`` (one pass, the plane in shared
memory, ``plane_threads`` threads) or ``n_chunks`` chunks of
``chunk_elems`` voxels (a statistics pass, then the apply pass; the
backward always by chunks). 16-byte accesses where ``vector_route``
allows them, one voxel at a time otherwise. ``launches`` on each wrapper
counts its calls that launched (each one or two device kernels).
"""

from __future__ import annotations

import torch

# conv_of's helpers, used at call time: conv_of imports models.blocks, which
# imports this module
from medseg_torch.kernels import _build, conv_of
from medseg_torch.models.blocks import LEAKY_SLOPE, NORM_EPS

_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256  # NT of csrc/instnorm.cu: threads of the chunked kernels
WORDS = 4  # WORDS of csrc/instnorm.cu: 16-byte words a thread takes in a chunk
PLANE_MAX_BYTES = 64 * 1024  # PLANE_MAX_BYTES: the largest plane of the one-pass forward
PLANE_MAX_THREADS = 512


def vec_of(dtype: torch.dtype) -> int:
    """Voxels of one 16-byte word."""
    return 128 // torch.finfo(dtype).bits


def vector_route(n_vox: int, dtype: torch.dtype, *tensors: torch.Tensor) -> bool:
    """Whether the kernels take 16-byte words (else one voxel at a time):
    every plane starts on 16 bytes when V % ``vec_of`` == 0 and the tensors
    do (``loss_of.vector_route``'s rule)."""
    return n_vox % vec_of(dtype) == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def chunk_elems(dtype: torch.dtype) -> int:
    """Voxels of one chunk of the chunked kernels."""
    return THREADS * WORDS * vec_of(dtype)


def n_chunks(n_vox: int, dtype: torch.dtype) -> int:
    return -(-n_vox // chunk_elems(dtype))


def plane_route(n_vox: int, dtype: torch.dtype) -> bool:
    """Whether the forward holds a whole plane in one block's shared memory
    (one pass) rather than taking it in chunks (two)."""
    return n_vox * torch.finfo(dtype).bits // 8 <= PLANE_MAX_BYTES


def plane_threads(n_vox: int, dtype: torch.dtype) -> int:
    """Threads of the one-pass forward: about four 16-byte words each, a
    power of two from 32 to 512."""
    words = -(-n_vox // vec_of(dtype))
    threads = 32
    while threads < PLANE_MAX_THREADS and 4 * threads < words:
        threads *= 2
    return threads


def _shape(t: torch.Tensor) -> tuple:
    return (1, -1) + (1,) * (t.ndim - 2)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def instance_norm_fwd_plain(x, weight, bias, residual=None, leaky=False, eps=NORM_EPS):
    """-> (y in x's dtype, mean (B, C), rstd (B, C)): the blocks' norm,
    cast, residual add and leaky ReLU as separate PyTorch operations, in
    fp32 (float64 for a float64 x)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    dims = tuple(range(2, x.ndim))
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    y = y * weight.to(acc).view(_shape(x)) + bias.to(acc).view(_shape(x))
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    if leaky:
        y = torch.nn.functional.leaky_relu(y, LEAKY_SLOPE)
    return y, mean.flatten(1), rstd.flatten(1)


def instance_norm_bwd_plain(dy, x, residual, mean, rstd, weight, bias, leaky=False):
    """-> (dx in x's dtype, dresidual in its dtype or None, dweight, dbias
    (C,) in the statistics' dtype). The leaky ReLU's slope is taken where
    ``xhat * weight + bias [+ residual]``, each operation rounded in the
    statistics' dtype as the kernel rounds it, is not above 0."""
    acc = mean.dtype
    bc = (...,) + (None,) * (x.ndim - 2)
    xh = (x.to(acc) - mean[bc]) * rstd[bc]
    dz = dy.to(acc)
    if leaky:
        z = xh * weight.to(acc).view(_shape(x)) + bias.to(acc).view(_shape(x))
        if residual is not None:
            z = z + residual.to(acc)
        dz = torch.where(z > 0, dz, dz * LEAKY_SLOPE)
    dims = tuple(range(2, x.ndim))
    n_vox = x[0, 0].numel()
    s1, s2 = dz.sum(dims), (dz * xh).sum(dims)
    k = weight.to(acc)[None] * rstd
    dx = k[bc] * (dz - (s1 / n_vox)[bc] - xh * (s2 / n_vox)[bc])
    dr = None if residual is None else dz.to(residual.dtype)
    return dx.to(x.dtype), dr, s2.sum(0), s1.sum(0)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_x(x: torch.Tensor) -> tuple[torch.device, int, int, int]:
    dev = conv_of._device_of(x)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x dtype {x.dtype} not supported (float32 or bfloat16)")
    if x.ndim < 3 or x.numel() == 0:
        raise ValueError(f"x of shape {tuple(x.shape)}: expected (B, C, spatial...), not empty")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return dev, x.shape[0], x.shape[1], x[0, 0].numel()


def _check_affine(weight, bias, c, dev) -> None:
    conv_of._check(weight, "weight", (c,), torch.float32, dev)
    conv_of._check(bias, "bias", (c,), torch.float32, dev)


def instance_norm_fwd(x, weight, bias, residual=None, leaky=False, eps=NORM_EPS):
    """N1 forward. x (B, C, ...) and residual (its shape and dtype, or None);
    weight and bias (C,) fp32. Returns ``(y, mean, rstd)``: y in x's dtype,
    mean and rstd (B, C) fp32."""
    if x.device.type == "cpu":
        return instance_norm_fwd_plain(x, weight, bias, residual, leaky, eps)
    dev, bsz, c, n_vox = _check_x(x)
    _check_affine(weight, bias, c, dev)
    if residual is not None:
        conv_of._check(residual, "residual", x.shape, x.dtype, dev)
    y = torch.empty_like(x)
    stats = torch.empty((2, bsz, c), dtype=torch.float32, device=dev)
    chunks = 0 if plane_route(n_vox, x.dtype) else n_chunks(n_vox, x.dtype)
    part = torch.empty((bsz * c * chunks, 2), dtype=torch.float32, device=dev) if chunks else None
    p = conv_of._ptr
    err = _build.lib().medseg_instnorm_fwd(
        dev.index, int(x.dtype == torch.bfloat16), int(leaky), int(residual is not None), p(x),
        p(residual), p(weight), p(bias), p(y), p(stats[0]), p(stats[1]), p(part), bsz, c, n_vox,
        chunks, plane_threads(n_vox, x.dtype), eps,
        int(vector_route(n_vox, x.dtype, *(t for t in (x, residual, y) if t is not None))),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "instance_norm forward kernel")
    instance_norm_fwd.launches += 1
    return y, stats[0], stats[1]


def instance_norm_bwd(dy, x, residual, mean, rstd, weight, bias, leaky=False):
    """N1 backward, from x (and the residual) and the forward's mean and
    rstd. Returns ``(dx, dresidual, dweight, dbias)``: dx and dresidual in
    x's dtype (dresidual None without a residual), dweight and dbias (C,)
    fp32."""
    if x.device.type == "cpu":
        return instance_norm_bwd_plain(dy, x, residual, mean, rstd, weight, bias, leaky)
    dev, bsz, c, n_vox = _check_x(x)
    _check_affine(weight, bias, c, dev)
    conv_of._check(dy, "dy", x.shape, x.dtype, dev)
    conv_of._check(mean, "mean", (bsz, c), torch.float32, dev)
    conv_of._check(rstd, "rstd", (bsz, c), torch.float32, dev)
    if residual is not None:
        conv_of._check(residual, "residual", x.shape, x.dtype, dev)
    dx = torch.empty_like(x)
    dr = None if residual is None else torch.empty_like(x)
    dparams = torch.empty((2, c), dtype=torch.float32, device=dev)
    chunks = n_chunks(n_vox, x.dtype)
    part = torch.empty((bsz * c * chunks, 2), dtype=torch.float32, device=dev)
    tensors = [t for t in (dy, x, residual, dx, dr) if t is not None]
    p = conv_of._ptr
    err = _build.lib().medseg_instnorm_bwd(
        dev.index, int(x.dtype == torch.bfloat16), int(leaky), int(residual is not None), p(dy),
        p(x), p(residual), p(mean), p(rstd), p(weight), p(bias), p(part), p(dx), p(dr),
        p(dparams[0]), p(dparams[1]), bsz, c, n_vox, chunks,
        int(vector_route(n_vox, x.dtype, *tensors)), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "instance_norm backward kernel")
    instance_norm_bwd.launches += 1
    return dx, dr, dparams[0], dparams[1]


KERNELS = (instance_norm_fwd, instance_norm_bwd)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# the norm
# ---------------------------------------------------------------------------

class InstanceNormFn(torch.autograd.Function):
    """Forward through ``instance_norm_fwd``, backward through
    ``instance_norm_bwd``; saves x, the residual, mean and rstd (nothing
    fp32 the size of x)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, leaky, eps):
        y, mean, rstd = instance_norm_fwd(x, weight, bias, residual, leaky, eps)
        ctx.save_for_backward(x, residual, mean, rstd, weight, bias)
        ctx.leaky = leaky
        return y

    @staticmethod
    def backward(ctx, dy):
        x, residual, mean, rstd, weight, bias = ctx.saved_tensors
        dx, dr, dw, db = instance_norm_bwd(dy.contiguous(), x, residual, mean, rstd, weight,
                                           bias, ctx.leaky)
        return dx, dw, db, dr, None, None


def instance_norm(x, weight, bias, eps: float = NORM_EPS, *, leaky: bool = False,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(weight * (x - mean) * rstd + bias [+ residual])`` per (b, c)
    plane, in x's dtype (module docstring)."""
    if x.device.type == "cpu":
        return instance_norm_fwd_plain(x, weight, bias, residual, leaky, eps)[0]
    weight, bias = weight.float(), bias.float()
    if residual is not None and residual.dtype != x.dtype:
        y = InstanceNormFn.apply(x.contiguous(), weight, bias, None, False, eps) + residual
        return torch.nn.functional.leaky_relu(y, LEAKY_SLOPE) if leaky else y
    if residual is not None:
        residual = residual.contiguous()
    return InstanceNormFn.apply(x.contiguous(), weight, bias, residual, leaky, eps)
