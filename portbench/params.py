"""The benchmark's own seeded weights for a configuration.

The tensors, their shapes and their order are the architecture's
``parameter_table`` (``architectures/<name>.py``). All weights are drawn in
one ``torch.randn`` call on the device from a generator seeded by the run's
seed, then scaled per tensor: matrices and conv kernels N(0, 1/fan_in);
the positional embedding N(0, 0.02^2); biases N(0, 0.02^2); norm scales
1 + N(0, 0.1^2) and norm shifts N(0, 0.1^2). The same seed gives the same
tensors; the program loads them under their names in the table (MONAI's
module names for UNETR) and the reference reads them as they are.
"""

from __future__ import annotations

import torch

WEIGHT_STREAM = 1
_SCALE = {"pos": 0.02, "bias": 0.02, "norm_weight": 0.1, "norm_bias": 0.1}


def stream_seed(seed: int, stream: int) -> int:
    """A seed for one of the run's independent streams (weights, inputs)."""
    return (int(seed) * 1_000_003 + stream) % (2**63)


def make_weights(arch, model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Name -> fp32 tensor on ``device``, every tensor a view of one buffer,
    for the model group ``model`` of architecture ``arch``."""
    table = arch.parameter_table(model)
    sizes = [1] * len(table)
    std, mean = [], []
    for i, (_, shape, kind, fan_in) in enumerate(table):
        for s in shape:
            sizes[i] *= s
        std.append(fan_in ** -0.5 if kind in ("linear", "conv") else _SCALE[kind])
        mean.append(1.0 if kind == "norm_weight" else 0.0)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHT_STREAM))
    counts = torch.tensor(sizes, device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(torch.repeat_interleave(torch.tensor(std, device=device), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(mean, device=device), counts))
    return {name: part.view(shape)
            for (name, shape, _, _), part in zip(table, torch.split(flat, sizes))}
