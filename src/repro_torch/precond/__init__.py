"""Kernel-multigrid (KMG) preconditioning for additive-GP backfitting.

Counterpart of ``repro.precond``: ``coarse`` builds the coarse levels from
subsampled kernel-packet rows; ``vcycle`` composes them into the symmetric
V-cycle preconditioner that ``backfitting.solve_mhat`` applies inside PCG
when ``SolveConfig.precond == "kmg"``. Everything here is plain PyTorch
around the banded kernels of ``kernels.ops`` (block CR, the LU kernel at
w = 0, the banded matvec), which launch on CUDA tensors.
"""
from .coarse import CoarseLevel, build_hierarchy, coarse_capacity
from .vcycle import (coarse_matvec, coarse_solve, kmg_preconditioner,
                     prolong, restrict)

__all__ = [
    "CoarseLevel",
    "build_hierarchy",
    "coarse_capacity",
    "coarse_matvec",
    "coarse_solve",
    "kmg_preconditioner",
    "prolong",
    "restrict",
]
