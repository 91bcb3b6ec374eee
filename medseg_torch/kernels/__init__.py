"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions and the fused serving forward. Nothing is built at import: the
library is compiled with ``nvcc`` at the first launch on a CUDA tensor
(``_build``)."""
