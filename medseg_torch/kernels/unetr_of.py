"""Fused UNETR serving forward (counterpart of ``medseg/kernels/unetr_of.py``
``fast_apply_v3``, without its TPU layouts: no parity planes, no z-packing).

Functionally ``UNETR.forward(x, return_encoder_features=False)``, with the
48^3 decoder and the two full-resolution stages run as a chain of
``conv_of`` kernels and two-phase instance norm:

    ViT + enc2-4 + dec5-4 (the modules in their compute dtype: SDPA, cuDNN)
    dec3:  transpose conv -> K5 cat2 [up ; enc2] (+conv3 tap) -> K1 (affine)
    enc1:  K1 conv1 (C_in=1: conv3 folds into an affine of x; C_in>1: conv3
           from conv1's residual tap) -> K1 conv2 (affine prologue)
    dec2:  transpose conv -> K2 combine [up ; enc1] (+conv3 tap) -> K1 conv2
    out:   K3 combine + 1x1 head + bias [* blend weight], or, given the
           volume accumulator and the windows' starts, K4: the same added
           straight into the accumulator (the z-row walk's exit, the
           counterpart of the JAX ``w_fold`` route)

Each kernel's epilogue sums its output per (b, channel); ``_affine`` turns
the sums into the next norm's affine, applied in the next kernel's
prologue. Conv biases cancel under instance norm and are never read. The
chain's weights are cast to the compute dtype once per model
(``fused_weights``) and passed to every forward. ``fast_apply_v3`` is
``fused_body`` (everything up to the out head's inputs) followed by one of
two exits, ``outhead_exit`` (K3) or ``outhead_row_exit`` (K4).

``GraphedForward`` serves the same forward on the card as CUDA graphs, one
per window batch shape and exit, replayed with one launch a batch (the
``Validator``'s forward on a CUDA device).

``fast_path_supported`` is the serving predicate (the counterpart of the JAX
``fast_path_supported_v2``): the chain is correct for the model, and on a
CUDA device the window is a cube of at least ``MIN_ROI`` and every kernel of
the chain has the widths of the model's feature size, input channels,
classes and compute dtype (``conv_of``'s width table). The ``Validator``
serves the module forward where it is false; ``fast_apply_v3`` itself runs
the module forward where the chain is not correct or, on the card, a
kernel lacks a width, so that no width ever raises.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.nn.functional as F

from medseg_torch.kernels.conv_of import (
    _bc,
    conv3x3x3_of,
    conv3x3x3_of_cat2,
    conv3x3x3_of_combine,
    conv_has_kernel,
    norm_affine_from_stats,
    outhead_has_kernel,
    outhead_of,
    outhead_row_has_kernel,
    outhead_row_of,
    overlap_add_plain,
)
from medseg_torch.models.blocks import leaky_relu
from medseg_torch.models.unetr import UNETR
from medseg_torch.utils.profiling import span

MIN_ROI = 48  # smallest window edge served by the chain on the card (the JAX predicate's)


def _chain_correct(model: UNETR, x_shape) -> bool:
    """Whether the fused chain computes the right answer: it expresses
    residual blocks whose conv3 exists. With C_in == feature_size encoder1
    has no conv3 (its residual is x verbatim), and ``res_block=False`` has
    no residual at all — those route to the plain forward."""
    return model.res_block and x_shape[1] != model.feature_size


def chain_has_kernels(model: UNETR, c_in: int) -> bool:
    """Whether every kernel of the chain has the widths of ``model`` (its
    feature size, classes and compute dtype) at ``c_in`` input channels:
    enc1.conv1 (K1, C_in -> FS, with the conv3 tap for C_in > 1), enc1.conv2
    and dec2.conv2 (K1, FS -> FS), dec3.conv1 (K5, 4 FS -> 2 FS), dec3.conv2
    (K1, 2 FS -> 2 FS), dec2.conv1 (K2, 2 FS -> FS) and the out head of
    either walk (K3, K4)."""
    fs, dt = model.feature_size, model.dtype or torch.float32
    k_pad = class_pad(model.out_channels)
    return (conv_has_kernel("plain", c_in, fs, dt)
            and conv_has_kernel("affine_leaky", fs, fs, dt)
            and conv_has_kernel("cat2", 4 * fs, 2 * fs, dt)
            and conv_has_kernel("affine_leaky", 2 * fs, 2 * fs, dt)
            and conv_has_kernel("combine", 2 * fs, fs, dt)
            and outhead_has_kernel(fs) and outhead_row_has_kernel(fs, k_pad))


def fast_path_supported(model, x_shape, device) -> bool:
    """Whether the fused chain serves windows of ``x_shape`` (B, C_in, D, H,
    W) on ``device``: the model is a ``UNETR`` (any other model, such as a
    ``SwinUNETR``, is served through its module), the chain is correct for
    it and, on a CUDA device, the window is a cube of at least ``MIN_ROI``
    and every kernel of the chain has the widths (``chain_has_kernels``). On
    the CPU the chain runs the kernels' plain versions, which take every
    width and size."""
    if not isinstance(model, UNETR) or not _chain_correct(model, x_shape):
        return False
    if torch.device(device).type != "cuda":
        return True
    _, c_in, d, h, w = x_shape
    return d == h == w >= MIN_ROI and chain_has_kernels(model, c_in)


def class_pad(n_classes: int) -> int:
    """Out-head rows: classes padded to a multiple of 8 (at least 8)."""
    return max(8, -(-n_classes // 8) * 8)


def _affine(s, ss, norm, n_valid: int):
    return norm_affine_from_stats(s, ss, norm.weight, norm.bias, n_valid)


@torch.no_grad()
def fused_weights(model: UNETR) -> dict[str, torch.Tensor]:
    """The chain's weights in the compute dtype ``model.dtype``, on the
    model's device: every conv and transpose-conv parameter of encoder1,
    decoder3 and decoder2 under its ``state_dict`` name, plus the out head
    as ``out.weight`` (K_pad, FS) and ``out.bias`` (K_pad,) fp32, its pad
    rows zero. Stale once the model's parameters change or move."""
    dtype = model.dtype or torch.float32
    w = {
        name: p.to(dtype).contiguous()
        for name, p in model.named_parameters()
        if name.startswith(("encoder1.", "decoder3.", "decoder2.")) and ".norm" not in name
    }
    head = model.out.conv.conv
    n_pad = class_pad(model.out_channels) - model.out_channels
    w["out.weight"] = F.pad(head.weight.reshape(model.out_channels, -1), (0, 0, 0, n_pad)).to(dtype)
    w["out.bias"] = F.pad(head.bias.float(), (0, n_pad))
    return w


def _lowres_stages(model: UNETR, x: torch.Tensor):
    """ViT + the <= 24^3 stages (``_xla_stages`` on the JAX side): returns
    (enc2, dec2)."""
    q = model.num_layers // 4
    tokens, hidden = model.vit(x)
    enc2 = model.encoder2(model.proj_feat(hidden[q]))
    enc3 = model.encoder3(model.proj_feat(hidden[2 * q]))
    enc4 = model.encoder4(model.proj_feat(hidden[3 * q]))
    dec3 = model.decoder5(model.proj_feat(tokens), enc4)
    dec2 = model.decoder4(dec3, enc3)
    return enc2, dec2


def _upsample(w, name: str, x: torch.Tensor) -> torch.Tensor:
    weight = w[f"{name}.transp_conv.conv.weight"]
    up = F.conv_transpose3d(
        x.to(weight.dtype), weight, w[f"{name}.transp_conv.conv.bias"], stride=2
    )
    return up.contiguous()  # cuDNN may return another memory format


def up_block_of(model: UNETR, name: str, x: torch.Tensor, skip: torch.Tensor, w) -> torch.Tensor:
    """``UnetrUpBlock`` ``name`` through the kernels: transpose conv, K5 over
    ``[up ; skip]`` with the conv3 tap, K1 with the norm1 prologue, then the
    final combine ``leaky(norm2(z2) + norm3(res))``. ``w``: ``fused_weights``."""
    up = _upsample(w, name, x)
    blk = getattr(model, name).conv_block

    def cw(conv):
        return w[f"{name}.conv_block.{conv}.conv.weight"]

    n_valid = up.shape[2] * up.shape[3] * up.shape[4]
    z1, s1, ss1, res, rs, rss = conv3x3x3_of_cat2(
        up, skip.to(up.dtype).contiguous(), cw("conv1"), cw("conv3")
    )
    a1, b1 = _affine(s1, ss1, blk.norm1, n_valid)
    z2, s2, ss2 = conv3x3x3_of(z1, cw("conv2"), a1, b1)
    a2, b2 = _affine(s2, ss2, blk.norm2, n_valid)
    a3, b3 = _affine(rs, rss, blk.norm3, n_valid)
    out = leaky_relu(_bc(a2) * z2.float() + _bc(b2) + _bc(a3) * res.float() + _bc(b3))
    return out.to(up.dtype)


@torch.no_grad()
def fast_apply_v3(
    model: UNETR,
    x: torch.Tensor,
    weights: dict[str, torch.Tensor],
    *,
    out_scale: torch.Tensor | None = None,
    starts=None,
    acc: torch.Tensor | None = None,
) -> torch.Tensor | None:
    """Fused serving forward: ``fused_body``, then one of its exits.

    Args:
      x: (B, C_in, D, H, W) window batch, D/H/W = ``model.img_size``.
      weights: ``fused_weights(model)``.
      out_scale: (B, 1, D, H, W) fp32 per-voxel blend weight multiplied into
        the logits in the out-head epilogue (pre-weighted serving logits).
      starts, acc: the accumulating exit. ``acc`` (K_pad, Dp, Hp, Wp) fp32 or
        bf16 is the volume accumulator and ``starts`` (B, 3) the windows'
        origins in it (host ints); the weighted logits are added into
        ``acc`` in place (K4, ``outhead_row_exit``) and nothing is
        returned. Needs ``out_scale``.

    Returns:
      (B, K_pad, D, H, W) logits in the compute dtype ``model.dtype`` (fp32
      when None; the low-resolution stages run in it too), K_pad
      = ``class_pad(out_channels)``; pad classes carry bias (times the
      weight) and are cropped by the caller (K3, ``outhead_exit``). None
      with ``acc``.
    """
    n_classes = model.out_channels
    k_pad = class_pad(n_classes)
    dtype = model.dtype or torch.float32
    if (acc is None) != (starts is None) or (acc is not None and out_scale is None):
        raise ValueError("the accumulating exit takes acc, starts and out_scale together")
    widths_ok = not x.is_cuda or chain_has_kernels(model, x.shape[1])
    if not (_chain_correct(model, x.shape) and widths_ok):
        out = model(x, return_encoder_features=False)
        if out_scale is not None:
            out = out * out_scale
        out = F.pad(out, (0, 0, 0, 0, 0, 0, 0, k_pad - n_classes))
        if acc is not None:
            # the JAX fallback's XLA W-fold: the same add, no kernel
            overlap_add_plain(out.float(), starts, acc)
            return None
        return out.to(dtype)
    parts = fused_body(model, x, weights)
    if acc is not None:
        outhead_row_exit(weights, parts, out_scale, starts, acc)
        return None
    return outhead_exit(weights, parts, out_scale)


@torch.no_grad()
def fused_body(model: UNETR, x: torch.Tensor, weights: dict[str, torch.Tensor]):
    """The chain from the window batch to the out head's inputs: the ViT and
    the low-resolution stages, decoder3, encoder1's K1 pair, decoder2's
    transpose conv, K2 and K1, and the norms' affines. Returns ``(z2, res,
    za2, zb2, za3, zb3)``: decoder2's conv2 output and conv3 residual (B,
    FS, D, H, W) in the compute dtype, and the (B, FS) fp32 affines of their
    norms. Holds no host sync: the whole of it can be captured in a CUDA
    graph (``GraphedForward``). Assumes the chain is correct for the model
    and has its kernels (``fast_path_supported``)."""
    fs = model.feature_size
    dtype = model.dtype or torch.float32
    b, c_in, d, h, w = x.shape
    n_valid = d * h * w

    def cw(conv):
        return weights[f"{conv}.conv.weight"]

    enc2, dec2 = _lowres_stages(model, x)  # in the module's compute dtype
    dec1 = up_block_of(model, "decoder3", dec2, enc2, weights)

    # ---- full-resolution chain ----
    e1 = model.encoder1.layer
    xd = x.to(dtype).contiguous()
    if c_in == 1:
        y1, s1, ss1 = conv3x3x3_of(xd, cw("encoder1.layer.conv1"))
        # 1x1 conv3 on the 1-channel input == per-channel scale of x; its
        # norm3 stats derive from x's own moments (no residual tensor)
        k3 = e1.conv3.conv.weight.float().reshape(fs)
        xf = x.float()
        sx = xf.sum((1, 2, 3, 4))
        ssx = xf.square().sum((1, 2, 3, 4))
        a3, b3 = _affine(sx[:, None] * k3[None], ssx[:, None] * k3.square()[None], e1.norm3, n_valid)
        ax, bx = a3 * k3[None], b3  # the 1x1 weights folded into the affine
        x_stream = xd
    else:
        # the conv3 residual is a real C_in -> FS matmul: emitted by conv1's
        # residual tap, with its norm3 stats from the same epilogue
        y1, s1, ss1, x_stream, rs3, rss3 = conv3x3x3_of(
            xd, cw("encoder1.layer.conv1"), wres=cw("encoder1.layer.conv3")
        )
        ax, bx = _affine(rs3, rss3, e1.norm3, n_valid)
    a1, b1 = _affine(s1, ss1, e1.norm1, n_valid)
    y2, s2, ss2 = conv3x3x3_of(y1, cw("encoder1.layer.conv2"), a1, b1)
    a2, b2 = _affine(s2, ss2, e1.norm2, n_valid)

    up = _upsample(weights, "decoder2", dec1)
    d2 = model.decoder2.conv_block
    z1, zs1, zss1, res, rs, rss = conv3x3x3_of_combine(
        up, y2, x_stream, a2, b2, ax, bx, cw("decoder2.conv_block.conv1"),
        cw("decoder2.conv_block.conv3"),
    )
    za1, zb1 = _affine(zs1, zss1, d2.norm1, n_valid)
    z2, zs2, zss2 = conv3x3x3_of(z1, cw("decoder2.conv_block.conv2"), za1, zb1)
    za2, zb2 = _affine(zs2, zss2, d2.norm2, n_valid)
    za3, zb3 = _affine(rs, rss, d2.norm3, n_valid)
    return z2, res, za2, zb2, za3, zb3


def outhead_exit(weights, parts, out_scale) -> torch.Tensor:
    """The flat walk's exit: K3 over ``fused_body``'s ``parts``, the out
    head's combine, 1x1 conv and bias times ``out_scale`` (or None): (B,
    K_pad, D, H, W) logits in the compute dtype."""
    return outhead_of(*parts, weights["out.weight"], weights["out.bias"], out_scale)


def outhead_row_exit(weights, parts, out_scale, starts, acc) -> None:
    """The z-row walk's exit: K4 over ``fused_body``'s ``parts``, the
    weighted logits added into ``acc`` at ``starts`` (host ints)."""
    outhead_row_of(*parts, weights["out.weight"], weights["out.bias"], out_scale, starts, acc)


MAX_GRAPHS = 4  # graphs a GraphedForward keeps; the least recently used goes first


class CudaGraphs:
    """How ``GraphedForward`` captures: ``torch.cuda.CUDAGraph``, for CUDA
    tensors only."""

    @staticmethod
    def captures(x: torch.Tensor) -> bool:
        return x.is_cuda

    @staticmethod
    def new_graph():
        return torch.cuda.CUDAGraph()

    @staticmethod
    def capture(graph, fn, pool):
        """Captures ``fn()`` into ``graph`` (memory from ``pool``, a new
        pool where None) and returns its outputs, the graph's static ones."""
        with torch.cuda.graph(graph, pool=pool):
            return fn()


@dataclasses.dataclass
class _Captured:
    graph: object
    x: torch.Tensor  # the static window batch
    scale: torch.Tensor | None  # the static blend weight (the K3 exit's)
    outs: object  # the static logits (K3) or body outputs (K4)


class GraphedForward:
    """``fast_apply_v3`` replayed as a CUDA graph per window batch shape and
    exit: one graph launch where the host issued the chain's ~550 kernels.

    The first batch of a shape runs eagerly (``fast_apply_v3``; it warms
    cuDNN's plans, the kernels' launch plans and the narrow weights'
    packing); the second is captured and every later one replays: the batch
    (and K3's blend weight) is copied into the graph's static buffers and
    ``replay()`` runs the same kernels on the same stream, so the results
    are the eager ones bit for bit. The flat exit (K3) is captured with the
    body; its static logits are overwritten by the next replay, so the
    caller uses them first (the flat walk adds them into its accumulator
    before the next batch). The accumulating exit (K4) reads the batch's
    window starts on the host, so only the body is captured and K4 is
    launched after the replay, eagerly, on the same stream.

    The graphs share one memory pool, and at most ``MAX_GRAPHS`` are kept
    (least recently used out). Shapes the fused chain does not serve
    (``fast_path_supported``) and tensors ``graphs`` does not capture (the
    CPU's) always run eagerly. The ``conv_of`` wrappers' launch counters
    count what the host issues: the eager batches' launches and the
    capture's (into the graph); a replay issues no kernel from the host and
    adds nothing to them (the kernels a replay runs are read from a profiler
    trace, ``kernel_check.trace_kernels``). ``captures`` and ``replays``
    count the graphs' own. ``graphs``: the capturing backend,
    ``CudaGraphs``. The spans, ``medseg.serve.replay`` and
    ``medseg.serve.capture``, bear the serving walk's names: the
    ``Validator`` is the runner's one caller.
    """

    def __init__(self, model: UNETR, weights: dict[str, torch.Tensor], *,
                 graphs=CudaGraphs) -> None:
        self.model, self.weights, self.graphs = model, weights, graphs
        self._seen: set = set()
        self._captured: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self.captures = self.replays = 0

    def __call__(self, x: torch.Tensor, out_scale: torch.Tensor, starts=None,
                 acc: torch.Tensor | None = None) -> torch.Tensor | None:
        """``fast_apply_v3(model, x, weights, out_scale=out_scale,
        starts=starts, acc=acc)``; the K3 logits returned after a replay are
        the graph's static ones."""
        rows = acc is not None
        key = (rows, tuple(x.shape), x.dtype, x.device)
        entry = self._captured.get(key)
        if entry is None:
            if key not in self._seen:
                if self.graphs.captures(x) and fast_path_supported(self.model, x.shape, x.device):
                    self._seen.add(key)
                return fast_apply_v3(self.model, x, self.weights, out_scale=out_scale,
                                     starts=starts, acc=acc)
            entry = self._capture(key, x, out_scale)
        else:
            self._captured.move_to_end(key)
        entry.x.copy_(x)
        if entry.scale is not None:
            entry.scale.copy_(out_scale)
        with span("medseg.serve.replay"):
            entry.graph.replay()
        self.replays += 1
        if rows:
            outhead_row_exit(self.weights, entry.outs, out_scale, starts, acc)
            return None
        return entry.outs

    def _capture(self, key, x: torch.Tensor, out_scale: torch.Tensor) -> _Captured:
        rows = key[0]
        static_x = x.clone(memory_format=torch.contiguous_format)
        scale = None if rows else out_scale.clone(memory_format=torch.contiguous_format)

        def chain():
            parts = fused_body(self.model, static_x, self.weights)
            return parts if rows else outhead_exit(self.weights, parts, scale)

        graph = self.graphs.new_graph()
        with span("medseg.serve.capture"):
            outs = self.graphs.capture(graph, chain, self._pool)
        if self._pool is None:
            self._pool = graph.pool()
        self.captures += 1
        if len(self._captured) >= MAX_GRAPHS:
            self._captured.popitem(last=False)
        entry = _Captured(graph, static_x, scale, outs)
        self._captured[key] = entry
        return entry
