"""PyTorch/CUDA port of the BCPM mapper (``repro``, the JAX package, is the
reference).  Entry points run on a CUDA device unless the caller passes
``device="cpu"``; the batched DP superstep is a hand-written CUDA kernel
(``kernels/minplus/csrc/batched_superstep.cu``)."""
