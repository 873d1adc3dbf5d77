"""PyTorch / CUDA port of xfemm_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX package ``xfemm_tpu``, with the same
module layout. This slice carries the planar nonlinear magnetostatic
solve: the mesher, the host Newton chain, and the band + block-
tridiagonal linear solver whose hot loop runs hand-written CUDA kernels
(``ops/kernels.py``). Entry points run on the card unless the caller
passes ``device="cpu"``, which runs the kernels' plain PyTorch versions.

The package imports torch, numpy and scipy only -- never jax or the
JAX package.
"""

__version__ = "0.1.0"
