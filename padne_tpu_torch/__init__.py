"""padne_tpu_torch — the PyTorch + CUDA port of padne_tpu's solve path.

The JAX package (padne_tpu) is the reference.  This package re-implements
its block-offset DIA solve route (Hilbert-ordered slab operator, aligned
AMG V/W-cycle, deflated multi-RHS PCG, Schur border with a compensated
refinement ladder) on torch tensors, with the two TPU kernels of that
route written by hand for Hopper (padne_tpu_torch/csrc).

It never imports jax.  Host-only stages that contain no JAX (KiCad
loading, geometry, meshing, indexing) are reused from padne_tpu; host
code that lives under padne_tpu/ops is carried here as numpy, because
importing anything under padne_tpu.ops loads jax.
"""

__version__ = "0.1.0"
