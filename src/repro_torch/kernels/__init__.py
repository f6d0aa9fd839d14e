"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions, and
the backend dispatch (``ops``). Nothing is built at import: the kernel
library is compiled at first launch."""
