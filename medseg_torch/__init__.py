"""medseg_torch — the PyTorch/CUDA port of ``medseg`` for NVIDIA Hopper.

A second package beside ``medseg/`` (the JAX reference, which stays as it
is). Module names mirror ``medseg/`` so each counterpart is easy to find:

- ``models``: UNETR, its ViT encoder and conv blocks as NCDHW ``nn.Module``s
  whose ``state_dict`` keys follow the MONAI-0.6 schema of the reference
  checkpoints;
- ``engine.checkpoint``: the weight bridge from the JAX package's params;
- ``kernels``: hand-written CUDA kernels for the fused serving forward and
  the training step (conv backward, fused DiceCE), each beside its plain
  PyTorch version;
- ``ops``: sliding-window inference, post-transforms, Dice, the DiceCE
  losses;
- ``engine.evaluate``: the ``Validator``;
- ``engine.state`` and ``engine.train``: the train state (AdamW), the
  supervised step and the training loop.

Importing the package imports nothing heavy: no ``jax``, no ``triton``, and
no kernel is built until one is launched on a CUDA tensor.
"""

__version__ = "0.1.0"
