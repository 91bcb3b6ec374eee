"""Operations and bytes of a model's layers, counted from the configuration's
widths, never from tensors the program made. An architecture's file
(``architectures/<name>.py``) lists its layers as ``Layer`` rows; the
arithmetic of each kind of row is here.

The arithmetic of the bounds is a copy of
``medseg_torch/kernels/kernel_check.py`` (``_conv_flops``, ``_nbytes``,
``bound_ms``, ``PEAK_FLOPS``, ``HBM_BYTES_PER_S``) as it stood when this
benchmark was written, kept here so that no change to the program moves the
yardstick: a kernel's least time is the larger of its operations over the
peak rate of their type and its bytes (each input read once, each output
written once) over the HBM bandwidth. Published peaks of one NVIDIA H100 SXM
(dense): 989 TFLOP/s in bf16, 67 TFLOP/s in fp32 outside the tensor cores,
3.35 TB/s of HBM3.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "fp32": 4, "int32": 4}


@dataclasses.dataclass(frozen=True)
class Layer:
    """One matmul or conv of a window's forward pass. ``kind``: "conv"
    (stride 1, same padding, ``taps`` = k^3), "transp" (k = s = 2),
    "linear" (``voxels`` = tokens), "attention" (QK^T and AV of every head:
    ``c_in`` = hidden, ``voxels`` = tokens, split into ``windows`` equal
    windows that attend within themselves: 4 x windows x (tokens per
    window)^2 x hidden operations). ``voxels``: output positions."""

    name: str
    kind: str
    c_in: int
    c_out: int
    taps: int
    voxels: int
    windows: int = 1

    @property
    def flops(self) -> float:
        if self.kind == "attention":
            per_window = self.voxels // self.windows
            return 2.0 * 2.0 * self.windows * per_window * per_window * self.c_in
        if self.kind == "transp":  # each output voxel takes one of the 8 taps
            return 2.0 * self.c_in * self.c_out * self.voxels
        return 2.0 * self.taps * self.c_in * self.c_out * self.voxels

    @property
    def in_voxels(self) -> int:
        return self.voxels // 8 if self.kind == "transp" else self.voxels

    @property
    def weight_elements(self) -> int:
        return 0 if self.kind == "attention" else self.c_in * self.c_out * self.taps


def forward_flops(arch, m: dict) -> float:
    """Operations of one window's forward pass (matmuls and convs) of the
    model group ``m`` of architecture ``arch`` (``manifest.architecture``)."""
    return sum(layer.flops for layer in arch.layers(m))


def layer_by_name(arch, m: dict) -> dict[str, Layer]:
    return {layer.name: layer for layer in arch.layers(m)}


def pass_work(layer: Layer, pass_: str, act: str = "bf16") -> tuple[float, float, float, str]:
    """(operations, activation bytes, weight bytes, operation type) of one
    pass of ``layer`` over one window: "fwd" reads x and the weight and
    writes y; "dgrad" reads dy and the weight and writes dx; "wgrad" reads x
    and dy and writes the fp32 weight gradient. Activations and weights in
    ``act``."""
    e = ELEMENT_BYTES[act]
    x = layer.c_in * layer.in_voxels * e
    y = layer.c_out * layer.voxels * e
    w = layer.weight_elements
    if pass_ in ("fwd", "dgrad"):
        return layer.flops, x + y, w * e, act
    if pass_ == "wgrad":
        return layer.flops, x + y, w * ELEMENT_BYTES["fp32"], act
    raise ValueError(f"pass {pass_!r} is not fwd, dgrad or wgrad")


def input_bytes(layer: Layer, act: str = "bf16") -> float:
    """The bytes of x that a pass reads (shared by a tap fused into the
    same kernel call, which reads them once)."""
    return layer.c_in * layer.in_voxels * ELEMENT_BYTES[act]


def loss_work(m: dict, pass_: str, task: str) -> tuple[float, float, str]:
    """DiceCE over one crop's logits (bf16) and int32 labels: the forward
    reads both (K7, ``kernel_check``'s 6 operations per logit), the backward
    reads both and writes the logits' gradient (K8, 13 per logit); fp32
    arithmetic."""
    if task != "ct":
        raise ValueError("the fused loss kernels serve the CT task only")
    n = m["out_channels"] * m["img_size"] ** 3
    v = m["img_size"] ** 3
    logits, labels = n * ELEMENT_BYTES["bf16"], v * ELEMENT_BYTES["int32"]
    if pass_ == "fwd":
        return 6.0 * n, logits + labels, "fp32"
    if pass_ == "bwd":
        return 13.0 * n, 2 * logits + labels, "fp32"
    raise ValueError(f"loss pass {pass_!r} is not fwd or bwd")


def bound_s(flops: float, nbytes: float, op_type: str) -> float:
    """The least seconds the card could take for this work."""
    return max(flops / PEAK_FLOPS[op_type], nbytes / HBM_BYTES_PER_S)
