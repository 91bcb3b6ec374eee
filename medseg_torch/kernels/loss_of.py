"""Fused DiceCE loss of the CT training step (counterpart of
``medseg/kernels/loss_of.py``).

Same value and gradient as ``medseg_torch.ops.losses.dice_ce_loss(softmax=True,
to_onehot_y=True)``, in two passes over the logits:

- forward, ``dice_ce_sums`` (K7): one read of (logits, labels) gives the CE
  sum per sample and the per-(b, k) soft-dice sums (intersection, pred,
  ground); the scalar loss is assembled from those few numbers;
- backward, ``dice_ce_bwd`` (K8): one read and one dlogits write, softmax
  recomputed, the dice quotient terms entering as per-(b, k) coefficients
  ``u = ca*g + cb`` and CE as ``cec*(p - g)``, chained through the softmax in
  closed form: ``dl = cec*(p - g) + p*(u - sum_k p_k u_k)``.

The logits are class-major NCDHW ``(B, K, D, H, W)`` (fp32 or bf16) as the
model emits them, so the kernels take them as they are; labels are int32
``(B, D, H, W)``. On a CPU tensor each wrapper runs its plain version; on a
CUDA tensor it launches its kernel (``csrc/loss_of.cu``) or raises. Each
wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medseg_torch.kernels import _build
from medseg_torch.kernels.conv_of import _check, _device_of, _ptr

_NR = 1e-5  # MONAI smooth_nr / smooth_dr
_DR = 1e-5
MAX_CLASSES = 16  # LMAXK of csrc/loss_of.cu: the class values a thread holds in registers
_DTYPES = (torch.float32, torch.bfloat16)
_BLOCKS_PER_SM = 8  # 256-thread blocks per SM the grid is sized for


def _check_labels(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if labels.dtype != torch.int32:
        raise ValueError(f"labels have dtype {labels.dtype}, expected torch.int32")
    want = (logits.shape[0], *logits.shape[2:])
    if tuple(labels.shape) != want:
        raise ValueError(f"labels have shape {tuple(labels.shape)}, expected {want}")


def _onehot(labels: torch.Tensor, k: int) -> torch.Tensor:
    if labels.numel() and (labels.min() < 0 or labels.max() >= k):
        raise ValueError(f"labels outside [0, {k})")
    return F.one_hot(labels.long(), k).movedim(-1, 1).float()


# ---------------------------------------------------------------------------
# plain PyTorch versions (fp32 math)
# ---------------------------------------------------------------------------

def dice_ce_sums_plain(logits, labels):
    """-> (ce (B,), inter (B, K), pred (B, K), ground (B, K)) fp32; ce is the
    per-sample sum of -log p[label]."""
    logp = torch.log_softmax(logits.float(), dim=1)
    p = torch.softmax(logits.float(), dim=1)
    g = _onehot(labels, logits.shape[1])
    spatial = tuple(range(2, logits.ndim))
    ce = -(g * logp).sum(tuple(range(1, logits.ndim)))
    return ce, (p * g).sum(spatial), p.sum(spatial), g.sum(spatial)


def dice_ce_bwd_plain(logits, labels, ca, cb, cec):
    """dlogits in the logits' dtype; ca, cb (B, K) and cec (B,) fp32."""
    p = torch.softmax(logits.float(), dim=1)
    g = _onehot(labels, logits.shape[1])
    bc = (...,) + (None,) * (logits.ndim - 2)
    u = ca[bc] * g + cb[bc]
    pu = (p * u).sum(dim=1, keepdim=True)
    return (cec[(slice(None),) + (None,) * (logits.ndim - 1)] * (p - g) + p * (u - pu)).to(
        logits.dtype
    )


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _grid(dev: torch.device, bsz: int, n_vox: int) -> int:
    """Blocks per batch element: the SMs' worth, at most one per 256 voxels."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-n_vox // 256), -(-_BLOCKS_PER_SM * sms // bsz)))


def _check_logits(logits: torch.Tensor) -> tuple[torch.device, int, int, int]:
    dev = _device_of(logits)
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits dtype {logits.dtype} not supported (float32 or bfloat16)")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    bsz, k = logits.shape[:2]
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"K={k}: the loss kernels hold at most {MAX_CLASSES} classes")
    return dev, bsz, k, logits[0, 0].numel()


def dice_ce_sums(logits, labels):
    """K7. logits (B, K, D, H, W), labels (B, D, H, W) int32 in [0, K).
    Returns ``(ce, inter, pred, ground)``: (B,) and three (B, K), fp32."""
    _check_labels(logits, labels)
    if logits.device.type == "cpu":
        return dice_ce_sums_plain(logits, labels)
    dev, bsz, k, n_vox = _check_logits(logits)
    _check(labels, "labels", labels.shape, torch.int32, dev)
    ce = torch.zeros((bsz,), dtype=torch.float32, device=dev)
    inter, pred, ground = (torch.zeros((bsz, k), dtype=torch.float32, device=dev) for _ in range(3))
    err = _build.lib().medseg_dice_ce_sums(
        dev.index, int(logits.dtype == torch.bfloat16), _ptr(logits), _ptr(labels), _ptr(ce),
        _ptr(inter), _ptr(pred), _ptr(ground), bsz, k, n_vox, _grid(dev, bsz, n_vox),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "dice_ce_sums kernel")
    dice_ce_sums.launches += 1
    return ce, inter, pred, ground


def dice_ce_bwd(logits, labels, ca, cb, cec):
    """K8. ca, cb (B, K) and cec (B,) fp32 coefficients; returns dlogits
    (B, K, D, H, W) in the logits' dtype."""
    _check_labels(logits, labels)
    if logits.device.type == "cpu":
        return dice_ce_bwd_plain(logits, labels, ca, cb, cec)
    dev, bsz, k, n_vox = _check_logits(logits)
    _check(labels, "labels", labels.shape, torch.int32, dev)
    _check(ca, "ca", (bsz, k), torch.float32, dev)
    _check(cb, "cb", (bsz, k), torch.float32, dev)
    _check(cec, "cec", (bsz,), torch.float32, dev)
    dl = torch.empty_like(logits)
    err = _build.lib().medseg_dice_ce_bwd(
        dev.index, int(logits.dtype == torch.bfloat16), _ptr(logits), _ptr(labels), _ptr(ca),
        _ptr(cb), _ptr(cec), _ptr(dl), bsz, k, n_vox, _grid(dev, bsz, n_vox),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "dice_ce_bwd kernel")
    dice_ce_bwd.launches += 1
    return dl


KERNELS = (dice_ce_sums, dice_ce_bwd)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

class DiceCEFn(torch.autograd.Function):
    """Counterpart of the ``dice_ce_of`` custom VJP: forward through K7 and
    the sums, backward through K8. No gradient for the labels."""

    @staticmethod
    def forward(ctx, logits, labels):
        ce, inter, pred, ground = dice_ce_sums(logits, labels)
        denom = ground + pred + _DR
        dice = (1.0 - (2.0 * inter + _NR) / denom).mean()
        loss = dice + ce.sum() / labels.numel()
        ctx.save_for_backward(logits, labels, inter, denom)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        logits, labels, inter, denom = ctx.saved_tensors
        bsz, k = inter.shape
        inv_bc = gbar.float() / (bsz * k)  # d(mean over B x K)
        ca = -2.0 * inv_bc / denom  # df/dI
        cb = inv_bc * (2.0 * inter + _NR) / denom.square()  # df/d(P + G)
        cec = (gbar.float() / labels.numel()).expand(bsz).contiguous()
        return dice_ce_bwd(logits, labels, ca, cb, cec), None


def fused_loss_supported(logits_shape, task: str) -> bool:
    """The CT (softmax + one-hot target) config on (B, K, D, H, W) logits
    with at most ``MAX_CLASSES`` classes; the MRI sigmoid/multi-label config
    takes ``ops.losses.dice_ce_loss``."""
    return task == "ct" and len(logits_shape) == 5 and logits_shape[1] <= MAX_CLASSES


def dice_ce_fused(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Scalar fp32 DiceCE of logits (B, K, D, H, W) against int32 labels
    (B, D, H, W) or (B, 1, D, H, W); same value and gradient as
    ``dice_ce_loss(softmax=True, to_onehot_y=True)``."""
    if label.ndim == logits.ndim:
        label = label[:, 0]
    return DiceCEFn.apply(logits.contiguous(), label.contiguous())
