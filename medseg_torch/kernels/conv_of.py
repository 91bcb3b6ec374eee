"""Fused conv kernels of the serving forward and the conv backward of the
training step (counterpart of ``medseg/kernels/conv_of.py``).

Six wrappers, each beside its plain PyTorch version in this module:

- ``conv3x3x3_of`` (K1): 3x3x3 same-pad conv, optional input prologue
  ``leaky(a*x + b)`` (the previous instance norm + activation), optional 1x1x1
  residual tap on the same transformed input; returns per-(b, c_out) sum and
  sum of squares of the fp32 results beside each output (two-phase instance
  norm: ``norm_affine_from_stats`` turns them into the next prologue);
- ``conv3x3x3_of_cat2`` (K5): the same over the channel concat ``[xa ; xb]``
  of two streams, with the residual tap, no concat in memory;
- ``conv3x3x3_of_combine`` (K2): the same over
  ``[up ; leaky(ay*y + by + ax*x + bx)]`` built from three streams;
- ``outhead_of`` (K3): ``leaky(az*z + bz + ar*res + br)`` -> 1x1x1 head + bias,
  times a per-voxel blend weight;
- ``outhead_row_of`` (K4): K3 for a batch of sliding windows, added straight
  into the volume accumulator (no per-window logits in memory);
- ``conv3x3x3_wgrad_of`` (K6): the filter gradient of a no-prologue 3x3x3
  conv, fp32.

K1, K2, K5 and K6 have two routes each, picked by shape and dtype alone:

- the tensor cores (``csrc/conv_tc.cu``, ``csrc/wgrad_tc.cu``): bf16
  operands and the widths of ``tc_route`` / ``wgrad_tc_route``: K1 and K6
  with C_in a multiple of 16 up to 64 and C_out 16, 32 or 64 in one launch
  (K1 with or without the residual tap); K5 and K2 with both halves of
  their input a multiple of 16 wide (K5: C up to 128; K2: up to 64) at the
  output widths of ``TC_MODE_C_OUT``. The wrapper packs the conv weights
  into the kernel's layout (``pack_tc_weight``, ``pack_tc_wres``). K5 (and
  K9's tensor-core route, mode ``flat``, ``conv_flat``) stage their input
  asynchronously (cp.async) where W is a multiple of 8 (``tc_staging``),
  through registers otherwise;
- the tensor cores at narrow inputs (``csrc/conv_narrow_tc.cu``): K1 in mode
  plain (with or without the residual tap) and K6, bf16, 1 to 8 input
  channels (``narrow_tc_route``, ``wgrad_narrow_tc_route``: encoder1.conv1,
  C_in 1 on CT and 4 on BraTS), C_out 16 or 32, the reduction packed across
  taps (``pack_narrow_weight``, ``pack_narrow_wres`` in the order of
  ``narrow_columns``);
- the CUDA cores (``csrc/conv_of.cu``, ``csrc/wgrad_of.cu``): every other
  call (fp32 operands, the prologue at narrow C_in, 9 <= C_in <= 15). They
  are instantiated for 16 and 32 output channels; a 64-wide conv runs as
  two 32-wide launches over the halves of its weight (K6: of its
  cotangent), concatenated.

K3 and K4 have two routes too, by ``outhead_tc_route``: bf16 with C a
multiple of 16 and K_pad 8, 16 or 32 on the tensor cores
(``csrc/outhead_tc.cu``, one core with K3's logits exit and K4's
overlap-add exit), every other call on ``csrc/outhead_of.cu`` and
``csrc/outhead_row_of.cu``.

``conv_has_kernel``, ``wgrad_has_kernel``, ``outhead_has_kernel`` and
``outhead_row_has_kernel`` are the width table of all of them: the wrappers
raise on a width it lacks, and the routes that send work to the kernels
(``kernels.conv3d.train_route``, ``kernels.unetr_of.fast_path_supported``)
read it, so that they never send one.

Layouts are NCDHW and torch's own weight layouts. The compute dtype is the
weight dtype (fp32 or bf16): operands are rounded to it, sums are fp32.
K1, K2 and K5 add their per-(b, c) statistics in a fixed order: each block
(CUDA cores) or tile group (tensor cores) stores its partial sums into a
slot of its own in a buffer the wrapper allocates (``cuda_core_stat_slots``,
``tc_stat_slots``), and a second kernel of the same C call adds the slots in
one order, so the same inputs give the same bits on every call.
On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its CUDA kernel (``csrc/``) or raises. Each wrapper's ``launches``
counts its kernel launches, ``tc_launches`` those of them that took a
tensor-core route, and ``narrow_launches`` those that took the narrow one.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from medseg_torch.kernels import _build
from medseg_torch.models.blocks import NORM_EPS, leaky_relu

_MODES = {"plain": 0, "affine_leaky": 1, "cat2": 2, "combine": 3, "flat": 4}
KERNEL_C_OUT = (16, 32)  # output widths the conv kernel is instantiated for
SPLIT_C_OUT = 64  # run as two KERNEL_C_OUT[-1]-wide launches
WGRAD_C_OUT = (16, 32)  # cotangent widths the wgrad kernel is instantiated for
WGRAD_CC = 8  # input channels per wgrad block (WCC of csrc/wgrad_of.cu)
WGRAD_TILE = 16  # (y, x) edge of a wgrad voxel tile (WTX = WTY)
WGRAD_BLOCKS_PER_SM = 3  # 68 KB of shared memory per block: three fit in 227 KB
OUTHEAD_MAX_C = 64  # MAXC of csrc/outhead_of.cu
OUTHEAD_ROW_MAX_C = 32  # largest MAXC of csrc/outhead_row_of.cu
OUTHEAD_ROW_MAX_K = 32  # largest MAXK of csrc/outhead_row_of.cu
OUTHEAD_ROW_MAX_B = 16  # MAXB of csrc/outhead_row_of.cu and outhead_tc.cu: windows per launch
OUTHEAD_TC_MAX_C = 64  # widest C of csrc/outhead_tc.cu (K4's stays OUTHEAD_ROW_MAX_C)
OUTHEAD_TC_K_PAD = (8, 16, 32)  # its K_pad instantiations: 8 * (n8 tiles)
TC_SLICE = 16  # input channels per k-step of the tensor-core kernels
TC_C_OUT = (16, 32, 64)  # output widths they are instantiated for, each one launch
# per mode of csrc/conv_tc.cu (K9 is mode "flat"): the widest input, all
# slices of it; CAT2 and FLAT reach 128 (feature size 32's dec3.conv1), the
# modes whose kernels are not widened stay at 64 (kernels.conv3d.MAX_C)
TC_MAX_C = {"plain": 64, "affine_leaky": 64, "cat2": 128, "combine": 64, "flat": 128}
# the output widths: CAT2 and COMBINE only at the decoder's C_out = C/2 that
# their routes send (K5 at feature sizes 16 and 32; K2 at 16 and 32)
TC_MODE_C_OUT = {"plain": TC_C_OUT, "affine_leaky": TC_C_OUT, "cat2": (32, 64),
                 "combine": (16, 32), "flat": TC_C_OUT}
TC_TILE = (2, 8, 16)  # (z, y, x) voxel tile of a block of either
# asynchronous (cp.async) staging of the no-prologue modes: W a multiple of 8
# (aligned 16-byte pieces; csrc/conv_tc.cu ASYNC_W_ALIGN)
TC_ASYNC_MODES = ("cat2", "flat")
TC_ASYNC_W_ALIGN = 8
WGRAD_TC_BLOCKS_PER_SM = 2  # K6 tile groups per SM (two blocks fit at C_out = 16)
CC_TILE = (2, 16, 16)  # (z, y, x) voxel tile of a block of csrc/conv_of.cu
NARROW_MAX_C = 8  # widest input of csrc/conv_narrow_tc.cu
NARROW_C_OUT = (16, 32)  # its output widths (K1 and K6)
NARROW_TILE = (2, 4, 64)  # (z, y, x) voxel tile of its blocks
TC_GROUP_THREADS = 256  # threads of a tile group of csrc/conv_tc.cu (NT)
_DTYPES = (torch.float32, torch.bfloat16)


def tc_route(c_in: int, c_out: int, dtype: torch.dtype, mode: str = "plain") -> bool:
    """Whether a conv call of ``c_in`` -> ``c_out`` channels in ``dtype``
    runs on the tensor cores: K1 (modes plain and affine_leaky), K5 (cat2),
    K2 (combine; ``c_in`` counts both halves of the input, whose boundary
    must fall on a 16-channel slice) or K9 (flat)."""
    slice_c = c_in // 2 if mode in ("cat2", "combine") else c_in
    return (dtype == torch.bfloat16 and c_in % 2 == 0 and slice_c % TC_SLICE == 0
            and 0 < c_in <= TC_MAX_C[mode] and c_out in TC_MODE_C_OUT[mode])


def tc_staging(mode: str, w: int) -> int:
    """How a tensor-core call of ``mode`` on volumes of width ``w`` stages
    its input: 1, asynchronously by cp.async (the no-prologue modes, W a
    multiple of 8); 0, through registers."""
    return int(mode in TC_ASYNC_MODES and w % TC_ASYNC_W_ALIGN == 0)


def wgrad_tc_route(c: int, c_out: int, dtype: torch.dtype) -> bool:
    """Whether a K6 call (x of ``c`` channels, a cotangent of ``c_out``)
    in ``dtype`` runs on the tensor cores."""
    return tc_route(c, c_out, dtype)


def narrow_tc_route(c_in: int, c_out: int, dtype: torch.dtype, mode: str = "plain") -> bool:
    """Whether a K1 call of ``c_in`` -> ``c_out`` channels in ``dtype`` runs
    on the narrow-input tensor-core kernel (``csrc/conv_narrow_tc.cu``): bf16,
    no prologue, 1 <= C_in <= 8, C_out 16 or 32; with or without the residual
    tap."""
    return (dtype == torch.bfloat16 and mode == "plain" and 1 <= c_in <= NARROW_MAX_C
            and c_out in NARROW_C_OUT)


def wgrad_narrow_tc_route(c: int, c_out: int, dtype: torch.dtype) -> bool:
    """Whether a K6 call (x of ``c`` channels, a cotangent of ``c_out``) in
    ``dtype`` runs on the narrow-input tensor-core kernel."""
    return narrow_tc_route(c, c_out, dtype)


def narrow_cp(c: int) -> int:
    """Channels of a staged voxel of the narrow kernels: C rounded up to 1, 2,
    4 or 8 (the extra channels are staged 0)."""
    return next(cp for cp in (1, 2, 4, 8) if c <= cp)


def narrow_k(c: int) -> int:
    """The narrow forward's packed reduction: 27 (tap, ci) per staged
    channel, padded to whole k16 steps (32 at C = 1, 112 at C = 4)."""
    return -(-27 * narrow_cp(c) // TC_SLICE) * TC_SLICE


@functools.lru_cache(maxsize=None)
def narrow_columns(c: int) -> tuple[tuple[int, int, int], ...]:
    """The (k, tap, ci) of each column of the narrow forward's packed
    reduction (taps kz, ky, kx row-major; CP = ``narrow_cp(C)``), padded k
    and padding channels left out. At CP 1 and 2, k = tap * CP + ci. At CP 4
    and 8 a k16 step holds 16 / CP whole taps, ordered so that a lane's two
    B registers (k = 16 ks + 2 tig + e and that + 8) are 4 consecutive
    channels of one tap (one 8-byte load): tap = (16 / CP) ks + tig / (CP /
    4), ci = 4 (tig % (CP / 4)) + 2 h + e for k = 16 ks + 8 h + 2 tig + e."""
    cp = narrow_cp(c)
    cols = []
    for k in range(narrow_k(c)):
        if cp <= 2:
            tap, ci = divmod(k, cp)
        else:
            ks, r = divmod(k, 16)
            h, r = divmod(r, 8)
            tig, e = divmod(r, 2)
            lpt = cp // 4  # lanes per tap
            tap, ci = 16 // cp * ks + tig // lpt, 4 * (tig % lpt) + 2 * h + e
        if tap < 27 and ci < c:
            cols.append((k, tap, ci))
    return tuple(cols)


@functools.lru_cache(maxsize=None)
def _narrow_sources(c: int, residual: bool, device: torch.device) -> torch.Tensor:
    """Per packed column, its source in the flattened (C, 27) weight (or C
    for the residual tap's (C,)), or the index of an appended zero column;
    made once per device, so that packing is one gather on the device."""
    n_src = c if residual else 27 * c
    src = [n_src] * narrow_k(c)
    for k, tap, ci in narrow_columns(c):
        if not residual:
            src[k] = 27 * ci + tap
        elif tap == 13:
            src[k] = ci
    return torch.tensor(src, dtype=torch.long, device=device)


def _pack_narrow(w2d: torch.Tensor, c: int, residual: bool) -> torch.Tensor:
    zero = w2d.new_zeros((w2d.shape[0], 1))
    return torch.cat([w2d, zero], 1).index_select(1, _narrow_sources(c, residual, w2d.device))


def pack_narrow_weight(weight: torch.Tensor) -> torch.Tensor:
    """(CO, C, 3, 3, 3) -> (CO, KP), KP = ``narrow_k(C)``: column k holds
    ``weight[co, ci, tap]`` for its (tap, ci) of ``narrow_columns``; the
    padding channels' and padded k's columns are 0 (the A rows of
    ``csrc/conv_narrow_tc.cu``)."""
    c_out, c = weight.shape[:2]
    return _pack_narrow(weight.reshape(c_out, 27 * c), c, False)


def pack_narrow_wres(wres: torch.Tensor) -> torch.Tensor:
    """(CO, C, 1, 1, 1) -> (CO, KP): the residual tap at the centre tap's (13)
    columns of ``narrow_columns``, every other column 0."""
    c_out, c = wres.shape[:2]
    return _pack_narrow(wres.reshape(c_out, c), c, True)


def narrow_tiles(x_shape) -> int:
    """Voxel tiles (``NARROW_TILE``, the ragged edge rounded up) of an (B, C,
    D, H, W) volume."""
    bsz, _, *vol = x_shape
    n = bsz
    for size, edge in zip(vol, NARROW_TILE):
        n *= -(-size // edge)
    return n


@functools.lru_cache(maxsize=None)
def narrow_per_sm(device_index: int, which: int, residual: int, c_out: int, c: int) -> int:
    """Blocks per SM of the narrow forward (``which`` 0) or filter gradient
    (1) at these widths (``medseg_narrow_plan``). Cached per library."""
    per_sm = ctypes.c_int(0)
    _build.check(_build.lib().medseg_narrow_plan(device_index, which, residual, c_out, c,
                                                 ctypes.byref(per_sm)),
                 "narrow conv plan")
    return per_sm.value


def narrow_blocks(device: torch.device, which: int, residual: int, c_out: int,
                  x_shape) -> int:
    """Blocks of a narrow launch: as many as fit the SMs, or fewer where the
    volume has fewer tiles. The forward's statistics and the filter
    gradient's partials have one slot per block."""
    per_sm = narrow_per_sm(device.index, which, residual, c_out, x_shape[1])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(narrow_tiles(x_shape), per_sm * sms))


def conv_has_kernel(mode: str, c_in: int, c_out: int, dtype: torch.dtype) -> bool:
    """Whether ``conv3x3x3_of`` (modes plain, affine_leaky), ``_cat2`` or
    ``_combine`` has a kernel for ``c_in`` -> ``c_out`` channels in
    ``dtype``: the tensor-core route, or the CUDA-core kernel's
    ``KERNEL_C_OUT`` (``SPLIT_C_OUT`` as two launches) at any C_in."""
    if dtype not in _DTYPES or (mode in ("cat2", "combine") and c_in % 2):
        return False
    return (tc_route(c_in, c_out, dtype, mode) or c_out in KERNEL_C_OUT
            or c_out == SPLIT_C_OUT)


def wgrad_has_kernel(c: int, c_out: int, dtype: torch.dtype) -> bool:
    """Whether ``conv3x3x3_wgrad_of`` has a kernel for x of ``c`` channels
    and a cotangent of ``c_out`` in ``dtype``."""
    return dtype in _DTYPES and (wgrad_tc_route(c, c_out, dtype) or c_out in WGRAD_C_OUT
                                 or c_out == SPLIT_C_OUT)


def outhead_tc_route(c: int, k_pad: int, dtype: torch.dtype) -> bool:
    """Whether K3 (and K4, within ``outhead_row_has_kernel``) with ``c``
    input channels and ``k_pad`` classes in ``dtype`` runs on the tensor
    cores (``csrc/outhead_tc.cu``): bf16, C a multiple of 16 up to 64, K_pad
    one of ``OUTHEAD_TC_K_PAD``."""
    return (dtype == torch.bfloat16 and c % TC_SLICE == 0 and 0 < c <= OUTHEAD_TC_MAX_C
            and k_pad in OUTHEAD_TC_K_PAD)


def outhead_has_kernel(c: int) -> bool:
    """Whether ``outhead_of`` has a kernel for ``c`` input channels (any
    number of classes)."""
    return 0 < c <= OUTHEAD_MAX_C


def outhead_row_has_kernel(c: int, k: int) -> bool:
    """Whether ``outhead_row_of`` has a kernel for ``c`` input channels and
    ``k`` (padded) classes."""
    return 0 < c <= OUTHEAD_ROW_MAX_C and 0 < k <= OUTHEAD_ROW_MAX_K


def tc_tiles(x_shape) -> int:
    """Voxel tiles (``TC_TILE``, the ragged edge rounded up) of an (B, C, D,
    H, W) volume."""
    bsz, _, *vol = x_shape
    n = bsz
    for size, edge in zip(vol, TC_TILE):
        n *= -(-size // edge)
    return n


def wgrad_tc_groups(x_shape, sms: int) -> int:
    """Tile groups of K6's tensor-core route: blocks per 16-channel slice,
    about ``WGRAD_TC_BLOCKS_PER_SM`` blocks per SM in all. Group ``k`` sums
    tiles k, k + groups, ... into its own partial."""
    slices = x_shape[1] // TC_SLICE
    return max(1, min(tc_tiles(x_shape), -(-WGRAD_TC_BLOCKS_PER_SM * sms // slices)))


def pack_tc_weight(weight: torch.Tensor) -> torch.Tensor:
    """(CO, C, 3, 3, 3) -> (C/16, 27, CO, 16): per 16-channel slice, per tap
    (kz, ky, kx row-major), one row of the slice's 16 input channels per
    output channel (the B operand rows of ``csrc/conv_tc.cu``)."""
    c_out, c = weight.shape[:2]
    return weight.reshape(c_out, c // TC_SLICE, TC_SLICE, 27).permute(1, 3, 0, 2).contiguous()


def pack_tc_wres(wres: torch.Tensor) -> torch.Tensor:
    """(CO, C, 1, 1, 1) -> (C/16, CO, 16), the residual tap's B rows."""
    c_out, c = wres.shape[:2]
    return wres.reshape(c_out, c // TC_SLICE, TC_SLICE).permute(1, 0, 2).contiguous()


def _bc(t: torch.Tensor) -> torch.Tensor:
    """(B, C) per-channel values -> (B, C, 1, 1, 1)."""
    return t[:, :, None, None, None]


def norm_affine_from_stats(s, ss, scale, bias, n_valid: int, eps: float = NORM_EPS):
    """(B, C) sums and sums of squares -> per-(b, c) affine ``(a, b)`` with
    ``a*x + b == instance_norm(x)``; var = ss/n - mean^2 clamped at 0."""
    mean = s / n_valid
    var = ss / n_valid - mean * mean
    a = scale.float()[None, :] * torch.rsqrt(var.clamp_min(0.0) + eps)
    return a, bias.float()[None, :] - mean * a


# ---------------------------------------------------------------------------
# plain PyTorch versions (fp32 math on operands rounded to the compute dtype)
# ---------------------------------------------------------------------------

def _conv_stats_plain(xt: torch.Tensor, weight: torch.Tensor, wres: torch.Tensor | None):
    """Transformed fp32 input -> (out, s, ss[, res, rs, rss]) in weight.dtype."""
    xt = xt.to(weight.dtype).float()  # operands as the kernel stages them
    out = F.conv3d(xt, weight.float(), padding=1)
    outs = [out.to(weight.dtype), out.sum((2, 3, 4)), out.square().sum((2, 3, 4))]
    if wres is not None:
        res = F.conv3d(xt, wres.float())
        outs += [res.to(weight.dtype), res.sum((2, 3, 4)), res.square().sum((2, 3, 4))]
    return tuple(outs)


def conv3x3x3_of_plain(x, weight, a=None, b=None, wres=None):
    xt = x.float()
    if a is not None:
        xt = leaky_relu(xt * _bc(a) + _bc(b))
    return _conv_stats_plain(xt, weight, wres)


def conv3x3x3_of_cat2_plain(xa, xb, weight, wres):
    return _conv_stats_plain(torch.cat([xa.float(), xb.float()], dim=1), weight, wres)


def conv3x3x3_of_combine_plain(up, y, x1, ay, by, ax, bx, weight, wres):
    comb = leaky_relu(y.float() * _bc(ay) + _bc(by) + x1.float() * _bc(ax) + _bc(bx))
    return _conv_stats_plain(torch.cat([up.float(), comb], dim=1), weight, wres)


def conv3x3x3_wgrad_of_plain(x, g):
    """dW (CO, C, 3, 3, 3) fp32 of ``conv3d(x, W, padding=1)`` for the
    cotangent ``g``; operands in the compute dtype ``x.dtype``, fp32 math."""
    return torch.nn.grad.conv3d_weight(
        x.float(), (g.shape[1], x.shape[1], 3, 3, 3), g.float(), padding=1
    )


def _outhead_fp32(z, res, az, bz, ar, br, kout, bias, scale=None):
    comb = leaky_relu(z.float() * _bc(az) + _bc(bz) + res.float() * _bc(ar) + _bc(br))
    comb = comb.to(kout.dtype).float()
    logits = torch.einsum("kc,bcdhw->bkdhw", kout.float(), comb)
    logits = logits + bias.float()[None, :, None, None, None]
    if scale is not None:
        logits = logits * scale
    return logits


def outhead_of_plain(z, res, az, bz, ar, br, kout, bias, scale=None):
    return _outhead_fp32(z, res, az, bz, ar, br, kout, bias, scale).to(kout.dtype)


def _window_box(starts, roi):
    """Origin and extent of the bounding box of windows of ``roi`` at
    ``starts`` ((B, 3) host ints)."""
    lo = [min(int(s[i]) for s in starts) for i in range(3)]
    hi = [max(int(s[i]) for s in starts) + roi[i] for i in range(3)]
    return lo, [b - a for a, b in zip(lo, hi)]


def overlap_add_plain(windows: torch.Tensor, starts, acc: torch.Tensor) -> None:
    """Adds fp32 windows (B, K, rd, rh, rw) at ``starts`` into ``acc`` (K, D,
    H, W) in place: summed in fp32 in window order into the windows'
    bounding box, which is added into ``acc`` with one rounding to its dtype."""
    roi = windows.shape[2:]
    lo, ext = _window_box(starts, roi)
    box = torch.zeros((windows.shape[1], *ext), dtype=torch.float32, device=windows.device)
    for s, win in zip(starts, windows.float()):
        o = [int(s[i]) - lo[i] for i in range(3)]
        box[:, o[0] : o[0] + roi[0], o[1] : o[1] + roi[1], o[2] : o[2] + roi[2]] += win
    region = acc[:, lo[0] : lo[0] + ext[0], lo[1] : lo[1] + ext[1], lo[2] : lo[2] + ext[2]]
    region.copy_(region.float() + box)


def outhead_row_of_plain(z, res, az, bz, ar, br, kout, bias, scale, starts, acc) -> None:
    overlap_add_plain(_outhead_fp32(z, res, az, bz, ar, br, kout, bias, scale), starts, acc)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}; CPU tensors take the plain version")
    return x.device


def _launch_conv(mode: str, streams, weight, wres, affines, x_channels: int = 0):
    """Checks shapes, allocates outputs and launches the conv kernel, adding
    each launch to the ``launches`` of the mode's wrapper."""
    x0 = streams[0]
    dev = _device_of(x0)
    dt = weight.dtype
    if dt not in _DTYPES:
        raise ValueError(f"compute dtype {dt} not supported (float32 or bfloat16)")
    c_out, c = weight.shape[:2]
    if not conv_has_kernel(mode, c, c_out, dt):
        raise ValueError(
            f"C_out={c_out}: the conv kernel is built for C_out in {KERNEL_C_OUT} "
            f"(and {SPLIT_C_OUT} as two launches), and on the tensor cores for "
            f"{TC_MODE_C_OUT[mode]} ({mode}, C={c}, {dt})"
        )
    if tc_route(c, c_out, dt, mode):
        return _launch_conv_tc(mode, streams, weight, wres, affines, x_channels)
    if narrow_tc_route(c, c_out, dt, mode):
        return _launch_conv_narrow(x0, weight, wres)
    if c_out == SPLIT_C_OUT:
        wres_halves = (None, None) if wres is None else wres.chunk(2)
        halves = [
            _launch_conv(mode, streams, w_half, r_half, affines, x_channels)
            for w_half, r_half in zip(weight.chunk(2), wres_halves)
        ]
        return tuple(torch.cat(parts, dim=1) for parts in zip(*halves))
    bsz, _, d, h, w = x0.shape
    vol = (d, h, w)
    c_half = c // 2 if mode in ("cat2", "combine") else 0
    _check(weight, "weight", (c_out, c, 3, 3, 3), dt, dev)
    if wres is not None:
        _check(wres, "wres", (c_out, c, 1, 1, 1), dt, dev)
    widths = {
        "plain": [c], "affine_leaky": [c], "cat2": [c_half, c_half],
        "combine": [c_half, c_half, x_channels],
    }[mode]
    if mode == "combine" and x_channels not in (1, c_half):
        raise ValueError(f"combine: x has {x_channels} channels, expected 1 or {c_half}")
    for i, (t, width) in enumerate(zip(streams, widths)):
        _check(t, f"input stream {i}", (bsz, width, *vol), dt, dev)
    aff = [None] * 4
    aff_width = c if mode == "affine_leaky" else c_half
    for i, t in enumerate(affines):
        _check(t, f"affine {i}", (bsz, aff_width), torch.float32, dev)
        aff[i] = t
    slots = cuda_core_stat_slots(d, h, w)
    outs, part = _conv_outputs((bsz, c_out, *vol), dt, dev, wres is not None, slots)
    out, s, ss, res, rs, rss = outs
    xs = list(streams) + [None] * (3 - len(streams))
    err = _build.lib().medseg_conv3x3x3(
        dev.index,
        int(dt == torch.bfloat16), _MODES[mode], int(wres is not None), c_out,
        *map(_ptr, xs), *map(_ptr, aff), _ptr(weight), _ptr(wres),
        _ptr(out), _ptr(s), _ptr(ss), _ptr(res), _ptr(rs), _ptr(rss), _ptr(part), slots,
        bsz, c, c_half, x_channels, d, h, w, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"conv3x3x3 kernel ({mode})")
    _MODE_WRAPPER[mode].launches += 1
    return outs if wres is not None else outs[:3]


def _conv_outputs(shape, dtype, device, residual: bool, slots: int):
    """A conv kernel's outputs, (out, s, ss, res, rs, rss) with the
    residual three None without the tap, and the buffer of its statistics'
    partial sums, ``slots`` per (sum, b, c): nothing is zeroed, the kernels
    write every element they read."""
    out = torch.empty(shape, dtype=dtype, device=device)
    empty = functools.partial(torch.empty, shape[:2], dtype=torch.float32, device=device)
    part = torch.empty((4 if residual else 2) * shape[0] * shape[1] * slots,
                       dtype=torch.float32, device=device)
    if not residual:
        return (out, empty(), empty(), None, None, None), part
    return (out, empty(), empty(), torch.empty_like(out), empty(), empty()), part


def cuda_core_stat_slots(d: int, h: int, w: int) -> int:
    """Partial-sum slots of a CUDA-core conv launch (``csrc/conv_of.cu``):
    its blocks per batch element."""
    n = 1
    for size, edge in zip((d, h, w), CC_TILE):
        n *= -(-size // edge)
    return n


@functools.lru_cache(maxsize=None)
def tc_plan(device_index: int, mode: str, residual: int, c_out: int, staging: int, c: int,
            x_channels: int) -> tuple[int, int, int, int]:
    """The launch plan of a tensor-core conv (``medseg_conv_tc_plan``):
    blocks per SM, threads per block, shared memory per block, whether the
    weights are resident. Cached per library: clear it
    (``tc_plan.cache_clear()``) after swapping the library."""
    plan = (ctypes.c_int * 4)()
    _build.check(_build.lib().medseg_conv_tc_plan(device_index, _MODES[mode], residual, c_out,
                                                  staging, c, x_channels, plan),
                 f"conv3x3x3 tensor-core plan ({mode})")
    return tuple(plan)


def tc_stat_slots(device: torch.device, mode: str, residual: int, c_out: int, staging: int,
                  c: int, x_channels: int, ntiles: int) -> int:
    """Partial-sum slots of a tensor-core conv launch: its tile groups,
    as ``csrc/conv_tc.cu`` sizes the persistent grid (blocks per SM x SMs,
    or fewer where the volume has fewer tiles, times groups per block)."""
    per_sm, threads = tc_plan(device.index, mode, residual, c_out, staging, c, x_channels)[:2]
    groups = threads // TC_GROUP_THREADS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-ntiles // groups), per_sm * sms) * groups


def _launch_conv_tc(mode, streams, weight, wres, affines, x_channels):
    """A conv on the tensor cores (``tc_route``): checks shapes, packs the
    weights, allocates outputs and launches ``csrc/conv_tc.cu`` once,
    adding it to the ``launches`` and ``tc_launches`` of the mode's
    wrapper."""
    x0 = streams[0]
    dev, dt = x0.device, weight.dtype
    c_out, c = weight.shape[:2]
    bsz, _, d, h, w = x0.shape
    two = mode in ("cat2", "combine")
    width = c // 2 if two else c  # of each stream but COMBINE's x, and of the affines
    if mode == "combine" and x_channels not in (1, width):
        raise ValueError(f"combine: x has {x_channels} channels, expected 1 or {width}")
    if two and wres is None:
        raise ValueError(f"{mode}: the kernel takes the residual tap")
    widths = [width, width, x_channels][: len(streams)]
    for i, (t, cw) in enumerate(zip(streams, widths)):
        _check(t, f"input stream {i}", (bsz, cw, d, h, w), dt, dev)
    _check(weight, "weight", (c_out, c, 3, 3, 3), dt, dev)
    if wres is not None:
        _check(wres, "wres", (c_out, c, 1, 1, 1), dt, dev)
    for i, t in enumerate(affines):
        _check(t, f"affine {i}", (bsz, width), torch.float32, dev)
        if t.data_ptr() % 16:  # the kernel reads the coefficients 16 bytes at a time
            raise ValueError(f"affine {i} must start at a 16-byte boundary")
    xs = list(streams) + [None] * (3 - len(streams))
    aff = list(affines) + [None] * (4 - len(affines))
    staging = tc_staging(mode, w)
    residual = int(wres is not None)
    slots = tc_stat_slots(dev, mode, residual, c_out, staging, c, x_channels,
                          tc_tiles(x0.shape))
    outs, part = _conv_outputs((bsz, c_out, d, h, w), dt, dev, wres is not None, slots)
    if part.numel() >= 2**31:  # the kernel's 32-bit slot offsets
        raise ValueError(f"conv3x3x3 tensor-core kernel ({mode}): batch {bsz} too large for "
                         "its statistics' partial sums")
    out, s, ss, res, rs, rss = outs
    w_packed = pack_tc_weight(weight)
    wres_packed = None if wres is None else pack_tc_wres(wres)
    if staging:
        _check_async_aligned(streams)
    err = _build.lib().medseg_conv_tc(
        dev.index, _MODES[mode], residual, c_out, staging, *map(_ptr, xs),
        *map(_ptr, aff), _ptr(w_packed), _ptr(wres_packed), _ptr(out), _ptr(s), _ptr(ss),
        _ptr(res), _ptr(rs), _ptr(rss), _ptr(part), slots, bsz, c, x_channels, d, h, w,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"conv3x3x3 tensor-core kernel ({mode})")
    _MODE_WRAPPER[mode].launches += 1
    _MODE_WRAPPER[mode].tc_launches += 1
    return outs if wres is not None else outs[:3]


def _launch_conv_narrow(x, weight, wres):
    """K1 at a narrow input on the tensor cores (``narrow_tc_route``):
    checks shapes, packs the weights, allocates outputs and launches
    ``csrc/conv_narrow_tc.cu`` (the conv, then the statistics' finish),
    adding it to ``launches``, ``tc_launches`` and ``narrow_launches``."""
    dev, dt = x.device, weight.dtype
    c_out, c = weight.shape[:2]
    bsz, _, d, h, w = x.shape
    _check(x, "input stream 0", (bsz, c, d, h, w), dt, dev)
    _check(weight, "weight", (c_out, c, 3, 3, 3), dt, dev)
    if wres is not None:
        _check(wres, "wres", (c_out, c, 1, 1, 1), dt, dev)
    residual = int(wres is not None)
    slots = narrow_blocks(dev, 0, residual, c_out, x.shape)
    outs, part = _conv_outputs((bsz, c_out, d, h, w), dt, dev, wres is not None, slots)
    if part.numel() >= 2**31:
        raise ValueError(f"narrow conv: batch {bsz} too large for its statistics' partial sums")
    out, s, ss, res, rs, rss = outs
    w_packed = pack_narrow_weight(weight)
    wres_packed = None if wres is None else pack_narrow_wres(wres)
    err = _build.lib().medseg_conv_narrow(
        dev.index, residual, c_out, _ptr(x), _ptr(w_packed), _ptr(wres_packed), _ptr(out),
        _ptr(s), _ptr(ss), _ptr(res), _ptr(rs), _ptr(rss), _ptr(part), slots, bsz, c, d, h, w,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "narrow conv tensor-core kernel")
    conv3x3x3_of.launches += 1
    conv3x3x3_of.tc_launches += 1
    conv3x3x3_of.narrow_launches += 1
    return outs if wres is not None else outs[:3]


def _check_async_aligned(streams) -> None:
    for i, t in enumerate(streams):
        if t.data_ptr() % 16:  # the staging copies aligned 16-byte pieces
            raise ValueError(f"input stream {i} must start at a 16-byte boundary "
                             "(asynchronous staging)")


def launch_flat_tc(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K9 on the tensor cores (``tc_route(C, C_out, dtype, "flat")``): the
    plain 3x3x3 conv of x (B, C, D, H, W) bf16 in fp32 (B, CO, D, H, W), one
    launch of ``csrc/conv_tc.cu`` mode FLAT (no residual tap, no
    statistics). Shapes are checked by the caller (``conv_flat``)."""
    dev = x.device
    bsz, c, d, h, w = x.shape
    c_out = weight.shape[0]
    out = torch.empty((bsz, c_out, d, h, w), dtype=torch.float32, device=dev)
    staging = tc_staging("flat", w)
    if staging:
        _check_async_aligned((x,))
    err = _build.lib().medseg_conv_tc(
        dev.index, _MODES["flat"], 0, c_out, staging, _ptr(x), None, None, None, None, None, None,
        _ptr(pack_tc_weight(weight)), None, _ptr(out), None, None, None, None, None, None, 0, bsz,
        c, 0, d, h, w, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "conv3x3x3 tensor-core kernel (flat)")
    return out


def conv3x3x3_of(x, weight, a=None, b=None, wres=None):
    """K1. x (B, C, D, H, W) in the compute dtype; weight (CO, C, 3, 3, 3);
    ``a``, ``b`` (B, C) fp32 select the ``leaky(a*x + b)`` prologue; wres
    (CO, C, 1, 1, 1) adds the residual tap. Returns ``(out, s, ss)`` or
    ``(out, s, ss, res, rs, rss)``; ``s``/``ss`` are (B, CO) fp32."""
    if x.device.type == "cpu":
        return conv3x3x3_of_plain(x, weight, a, b, wres)
    mode = "plain" if a is None else "affine_leaky"
    return _launch_conv(mode, (x,), weight, wres, () if a is None else (a, b))


def conv3x3x3_of_cat2(xa, xb, weight, wres):
    """K5. Conv + residual tap + stats over ``[xa ; xb]`` (each (B, C/2, D, H,
    W)); returns ``(out, s, ss, res, rs, rss)``."""
    if xa.device.type == "cpu":
        return conv3x3x3_of_cat2_plain(xa, xb, weight, wres)
    return _launch_conv("cat2", (xa, xb), weight, wres, ())


def conv3x3x3_of_combine(up, y, x1, ay, by, ax, bx, weight, wres):
    """K2. Conv + residual tap + stats over ``[up ; leaky(ay*y + by + ax*x1 +
    bx)]``: up, y (B, C/2, D, H, W); x1 (B, 1 or C/2, D, H, W), a 1-channel
    x broadcast over the C/2 channels; affines (B, C/2) fp32. Returns
    ``(out, s, ss, res, rs, rss)``."""
    if up.device.type == "cpu":
        return conv3x3x3_of_combine_plain(up, y, x1, ay, by, ax, bx, weight, wres)
    return _launch_conv(
        "combine", (up, y, x1), weight, wres, (ay, by, ax, bx), x_channels=x1.shape[1]
    )


def outhead_of(z, res, az, bz, ar, br, kout, bias, scale=None):
    """K3. z, res (B, C, D, H, W); affines (B, C) fp32; kout (K_pad, C) in the
    compute dtype; bias (K_pad,) fp32; scale (B, 1, D, H, W) fp32 or None.
    Returns (B, K_pad, D, H, W) logits in the compute dtype (fp32 sums)."""
    if z.device.type == "cpu":
        return outhead_of_plain(z, res, az, bz, ar, br, kout, bias, scale)
    dev = _device_of(z)
    dt = kout.dtype
    if dt not in _DTYPES:
        raise ValueError(f"compute dtype {dt} not supported (float32 or bfloat16)")
    bsz, c, d, h, w = z.shape
    if not outhead_has_kernel(c):
        raise ValueError(f"out head: C={c} above the kernel's {OUTHEAD_MAX_C} register slots")
    k = kout.shape[0]
    _check(z, "z", (bsz, c, d, h, w), dt, dev)
    _check(res, "res", (bsz, c, d, h, w), dt, dev)
    for name, t in (("az", az), ("bz", bz), ("ar", ar), ("br", br)):
        _check(t, name, (bsz, c), torch.float32, dev)
    _check(kout, "kout", (k, c), dt, dev)
    _check(bias, "bias", (k,), torch.float32, dev)
    if scale is not None:
        _check(scale, "scale", (bsz, 1, d, h, w), torch.float32, dev)
    out = torch.empty((bsz, k, d, h, w), dtype=dt, device=dev)
    operands = (_ptr(z), _ptr(res), _ptr(az), _ptr(bz), _ptr(ar), _ptr(br), _ptr(kout),
                _ptr(bias), _ptr(scale), _ptr(out), bsz, c, k, d * h * w,
                torch.cuda.current_stream(dev).cuda_stream)
    if outhead_tc_route(c, k, dt):
        _build.check(_build.lib().medseg_outhead_tc(dev.index, *operands),
                     "outhead tensor-core kernel")
        outhead_of.tc_launches += 1
    else:
        err = _build.lib().medseg_outhead(dev.index, int(dt == torch.bfloat16),
                                          int(scale is not None), *operands)
        _build.check(err, "outhead kernel")
    outhead_of.launches += 1
    return out


def _host_starts(starts, bsz: int, roi, acc_shape) -> list[tuple[int, int, int]]:
    """(B, 3) window starts as host ints, each window inside the accumulator."""
    rows = [tuple(int(v) for v in s) for s in torch.as_tensor(starts).tolist()]
    if len(rows) != bsz or any(len(s) != 3 for s in rows):
        raise ValueError(f"starts must be ({bsz}, 3), got {tuple(torch.as_tensor(starts).shape)}")
    for s in rows:
        if any(v < 0 or v + r > n for v, r, n in zip(s, roi, acc_shape[1:])):
            raise ValueError(f"window at {s} of size {tuple(roi)} leaves the accumulator "
                             f"{tuple(acc_shape[1:])}")
    return rows


def outhead_row_of(z, res, az, bz, ar, br, kout, bias, scale, starts, acc) -> None:
    """K4. K3's combine, head, bias and blend weight for a batch of windows,
    added straight into the volume accumulator: z, res (B, C, rd, rh, rw) in
    the compute dtype; affines (B, C) fp32; kout (K_pad, C); bias (K_pad,)
    fp32; scale (B, 1, rd, rh, rw) fp32; starts (B, 3) int window origins in
    ``acc``, read on the host (a CPU tensor or a sequence); acc (K_pad, D, H,
    W) fp32 or bf16, updated in place. The windows are summed in fp32 and
    each voxel of ``acc`` they cover is rounded once; voxels they do not
    cover are left untouched."""
    bsz, c, rd, rh, rw = z.shape
    if acc.ndim != 4:
        raise ValueError(f"acc must be (K_pad, D, H, W), got {tuple(acc.shape)}")
    rows = _host_starts(starts, bsz, (rd, rh, rw), acc.shape)
    if z.device.type == "cpu":
        return outhead_row_of_plain(z, res, az, bz, ar, br, kout, bias, scale, rows, acc)
    dev = _device_of(z)
    dt = kout.dtype
    if dt not in _DTYPES:
        raise ValueError(f"compute dtype {dt} not supported (float32 or bfloat16)")
    if acc.dtype not in _DTYPES:
        raise ValueError(f"accumulator dtype {acc.dtype} not supported (float32 or bfloat16)")
    k = kout.shape[0]
    if not outhead_row_has_kernel(c, k):
        raise ValueError(f"out head row: C={c}, K={k} above the kernel's register slots "
                         f"({OUTHEAD_ROW_MAX_C}, {OUTHEAD_ROW_MAX_K})")
    _check(z, "z", (bsz, c, rd, rh, rw), dt, dev)
    _check(res, "res", (bsz, c, rd, rh, rw), dt, dev)
    for name, t in (("az", az), ("bz", bz), ("ar", ar), ("br", br)):
        _check(t, name, (bsz, c), torch.float32, dev)
    _check(kout, "kout", (k, c), dt, dev)
    _check(bias, "bias", (k,), torch.float32, dev)
    _check(scale, "scale", (bsz, 1, rd, rh, rw), torch.float32, dev)
    _check(acc, "acc", (k, *acc.shape[1:]), acc.dtype, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tc = outhead_tc_route(c, k, dt)
    for i in range(0, bsz, OUTHEAD_ROW_MAX_B):
        part = rows[i : i + OUTHEAD_ROW_MAX_B]
        nb = len(part)
        lo, ext = _window_box(part, (rd, rh, rw))
        operands = (
            _ptr(z[i]), _ptr(res[i]), _ptr(az[i]), _ptr(bz[i]), _ptr(ar[i]), _ptr(br[i]),
            _ptr(kout), _ptr(bias), _ptr(scale[i]), _ptr(acc), nb, c, k, rd, rh, rw,
            *acc.shape[1:], (ctypes.c_int * (3 * nb))(*[v for s in part for v in s]),
            (ctypes.c_int * 3)(*lo), (ctypes.c_int * 3)(*ext), stream,
        )
        acc_bf16 = int(acc.dtype == torch.bfloat16)
        if tc:
            _build.check(_build.lib().medseg_outhead_row_tc(dev.index, acc_bf16, *operands),
                         "outhead row tensor-core kernel")
            outhead_row_of.tc_launches += 1
        else:
            err = _build.lib().medseg_outhead_row(dev.index, int(dt == torch.bfloat16), acc_bf16,
                                                  *operands)
            _build.check(err, "outhead row kernel")
        outhead_row_of.launches += 1


def conv3x3x3_wgrad_of(x, g):
    """K6. x (B, C, D, H, W) and the cotangent g (B, CO, D, H, W) in the
    compute dtype. Returns dW (CO, C, 3, 3, 3) fp32 of the same-pad,
    no-prologue conv ``conv3x3x3_of(x, W)``; the sums are taken in a fixed
    order (per-block partials, then one reduction pass)."""
    if x.device.type == "cpu":
        return conv3x3x3_wgrad_of_plain(x, g)
    dev = _device_of(x)
    dt = x.dtype
    if dt not in _DTYPES:
        raise ValueError(f"compute dtype {dt} not supported (float32 or bfloat16)")
    bsz, c, d, h, w = x.shape
    c_out = g.shape[1]
    if not wgrad_has_kernel(c, c_out, dt):
        raise ValueError(f"C_out={c_out}: the wgrad kernel is built for C_out in {WGRAD_C_OUT} "
                         f"(and {SPLIT_C_OUT} as two launches)")
    if wgrad_tc_route(c, c_out, dt):
        return _launch_wgrad_tc(x, g)
    if wgrad_narrow_tc_route(c, c_out, dt):
        return _launch_wgrad_narrow(x, g)
    if c_out == SPLIT_C_OUT:  # the rows of dW of each half of the cotangent
        return torch.cat([conv3x3x3_wgrad_of(x, half.contiguous()) for half in g.chunk(2, dim=1)])
    _check(x, "x", (bsz, c, d, h, w), dt, dev)
    _check(g, "g", (bsz, c_out, d, h, w), dt, dev)
    chunks = -(-c // WGRAD_CC)
    tiles = bsz * d * -(-h // WGRAD_TILE) * -(-w // WGRAD_TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = max(1, min(tiles, -(-WGRAD_BLOCKS_PER_SM * sms // chunks)))
    partial = torch.empty((groups, c_out, c, 27), dtype=torch.float32, device=dev)
    dw = torch.empty((c_out, c, 3, 3, 3), dtype=torch.float32, device=dev)
    err = _build.lib().medseg_wgrad(
        dev.index, int(dt == torch.bfloat16), c_out, _ptr(x), _ptr(g), _ptr(partial), _ptr(dw),
        bsz, c, d, h, w, groups, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "wgrad kernel")
    conv3x3x3_wgrad_of.launches += 1
    return dw


def _launch_wgrad_tc(x, g):
    """K6 on the tensor cores (``wgrad_tc_route``): one launch of
    ``csrc/wgrad_tc.cu`` (its wgrad pass and its fixed-order reduction)."""
    dev, dt = x.device, x.dtype
    bsz, c, d, h, w = x.shape
    c_out = g.shape[1]
    _check(x, "x", (bsz, c, d, h, w), dt, dev)
    _check(g, "g", (bsz, c_out, d, h, w), dt, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = wgrad_tc_groups((bsz, c, d, h, w), sms)
    partial = torch.empty((groups, c_out, c, 27), dtype=torch.float32, device=dev)
    dw = torch.empty((c_out, c, 3, 3, 3), dtype=torch.float32, device=dev)
    err = _build.lib().medseg_wgrad_tc(
        dev.index, c_out, _ptr(x), _ptr(g), _ptr(partial), _ptr(dw), bsz, c, d, h, w, groups,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "wgrad tensor-core kernel")
    conv3x3x3_wgrad_of.launches += 1
    conv3x3x3_wgrad_of.tc_launches += 1
    return dw


def _launch_wgrad_narrow(x, g):
    """K6 at a narrow input on the tensor cores (``wgrad_narrow_tc_route``):
    one launch of ``csrc/conv_narrow_tc.cu``'s filter gradient (its blocks'
    partials, then the fixed-order reduction)."""
    dev, dt = x.device, x.dtype
    bsz, c, d, h, w = x.shape
    c_out = g.shape[1]
    _check(x, "x", (bsz, c, d, h, w), dt, dev)
    _check(g, "g", (bsz, c_out, d, h, w), dt, dev)
    groups = narrow_blocks(dev, 1, 0, c_out, x.shape)
    partial = torch.empty((groups, c_out, c, 27), dtype=torch.float32, device=dev)
    dw = torch.empty((c_out, c, 3, 3, 3), dtype=torch.float32, device=dev)
    err = _build.lib().medseg_wgrad_narrow(
        dev.index, c_out, _ptr(x), _ptr(g), _ptr(partial), _ptr(dw), bsz, c, d, h, w, groups,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "narrow wgrad tensor-core kernel")
    conv3x3x3_wgrad_of.launches += 1
    conv3x3x3_wgrad_of.tc_launches += 1
    conv3x3x3_wgrad_of.narrow_launches += 1
    return dw


_MODE_WRAPPER = {
    "plain": conv3x3x3_of, "affine_leaky": conv3x3x3_of, "cat2": conv3x3x3_of_cat2,
    "combine": conv3x3x3_of_combine,
}
KERNELS = (conv3x3x3_of, conv3x3x3_of_cat2, conv3x3x3_of_combine, outhead_of, outhead_row_of,
           conv3x3x3_wgrad_of)
NARROW_KERNELS = (conv3x3x3_of, conv3x3x3_wgrad_of)  # the wrappers with a narrow-input route


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = fn.tc_launches = 0
    for fn in NARROW_KERNELS:
        fn.narrow_launches = 0


reset_launches()
