"""medseg_torch — the PyTorch/CUDA port of ``medseg`` for NVIDIA Hopper.

A second package beside ``medseg/`` (the JAX reference, which stays as it
is). Module names mirror ``medseg/`` so each counterpart is easy to find:

- ``models``: UNETR, its ViT encoder and conv blocks as NCDHW ``nn.Module``s
  whose ``state_dict`` keys follow the MONAI-0.6 schema of the reference
  checkpoints;
- ``engine.checkpoint``: the weight bridge from the JAX package's params and
  the reference ``.pth`` loader;
- ``kernels``: hand-written CUDA kernels for the fused serving forward and
  the training step (conv backward, fused DiceCE), each beside its plain
  PyTorch version;
- ``ops``: sliding-window inference (the flat and the z-row walk),
  post-transforms, Dice, the DiceCE losses, the device preprocessing
  (``ops.resample``);
- ``engine.evaluate``: the ``Validator``;
- ``engine.state`` and ``engine.train``: the train state (AdamW), the
  supervised step and the training loop;
- ``parallel``: the data-parallel runtime on ``torch.distributed`` (the
  process group from the JAX package's ``MEDSEG_*`` variables, the mesh and
  its collectives, the sharded window walks' merge);
- ``config``, ``data``, ``utils`` and ``cli``: presets, NIfTI I/O, the
  Decathlon datalist, the host preprocessing chains, throughput counters and
  the serving CLI (``python -m medseg_torch.cli.infer``).

Importing the package imports nothing heavy: no ``jax``, no ``triton``, and
no kernel is built until one is launched on a CUDA tensor.
"""

__version__ = "0.1.0"
