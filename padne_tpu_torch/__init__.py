"""padne_tpu_torch — the PyTorch + CUDA port of padne_tpu's solve path.

The JAX package (padne_tpu) is the reference.  This package re-implements
its solve routes on torch tensors — the block-offset DIA route
(Hilbert-ordered slab operator, aligned AMG V/W-cycle, deflated
multi-RHS PCG, Schur border with a compensated refinement ladder) and
the generic ELL route (smoothed-aggregation AMG, deflated PCG, mixed-
precision refinement) — with the TPU kernels of those routes written by
hand for Hopper (padne_tpu_torch/csrc).

It imports neither jax nor anything of padne_tpu.  The host stages
(KiCad loading, geometry and its C++ core, meshing, indexing, assembly)
are the port's own copies of the JAX package's jax-free modules, and
produce bit-identical problems, meshes and systems.
"""

__version__ = "0.1.0"


def _tune_allocator() -> None:
    """Keep large allocations on the reusable glibc heap.

    By default glibc serves multi-MB allocations via mmap and returns the
    pages to the kernel on free, so every large numpy temporary pays
    first-touch page faults again.  On virtualized hosts those faults can
    run at ~100-400 MB/s while warm pages stream at ~7 GB/s — a 4-20x
    slowdown on the whole host-side pipeline (meshing, ELL packing, AMG
    setup).  Raising M_MMAP_THRESHOLD and disabling mmap-backed malloc
    keeps freed pages warm; process peak RSS then tracks peak live usage,
    which this workload is fine with.  Opt out with
    PADNE_TPU_NO_MALLOC_TUNE=1.
    """
    import ctypes
    import os
    import sys

    if os.environ.get("PADNE_TPU_NO_MALLOC_TUNE") == "1":
        return
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 2**31 - 1)  # M_MMAP_THRESHOLD
        libc.mallopt(-4, 0)          # M_MMAP_MAX
    except OSError:  # non-glibc (musl etc.)
        pass


_tune_allocator()
