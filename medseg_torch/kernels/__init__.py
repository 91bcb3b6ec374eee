"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions, the fused serving forward, the training step's conv Function and
fused loss. Nothing is built at import: the library is compiled with
``nvcc`` at the first launch on a CUDA tensor (``_build``)."""
