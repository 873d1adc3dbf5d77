"""PyTorch / CUDA port of xfemm_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX package ``xfemm_tpu``, with the same
module layout. It carries the planar nonlinear magnetostatic solve (the
mesher, the Newton chain on the host and on the device, and the band
linear solvers whose hot loops run hand-written CUDA kernels,
``ops/kernels.py``), the postprocessors (``post/``) and the user
surfaces: ``api``, the pyFEMM verbs (``femm_compat``), the Lua femmcli
interpreter (``scripting/``) and ``python -m xfemm_tpu_torch``, every
problem family of the reference, and the domain decomposition behind
each model's ``devices=`` (``parallel/``). Entry points run on the card
unless the caller passes ``device="cpu"``, which runs the kernels' plain
PyTorch versions.

The package imports torch, numpy and scipy only -- never jax or the
JAX package.
"""

__version__ = "0.1.0"
