"""Banded matrix times a block of vectors: CUDA kernel and plain version.

Counterpart of ``repro.kernels.banded_matvec.banded_matvec_pallas``:
``y[g, i, b] = sum_{m=-lo..hi} band[g, i, lo+m] * x[g, i+m, b]`` with zero
outside the rows. The CUDA kernel is ``csrc/banded_matvec.cu`` (one thread
per output element); the wrapper launches it for CUDA tensors and runs
:func:`banded_matvec_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build
from .ops import resolve_backend

__all__ = ["banded_matvec", "banded_matvec_plain", "MAX_HALF_WIDTH"]

MAX_HALF_WIDTH = 8  # lo, hi <= 8 (csrc/banded_matvec.cu MAX_HALF)


def banded_matvec_plain(band: torch.Tensor, x: torch.Tensor, lo: int,
                        hi: int):
    """band (G, n, lo+hi+1), x (G, n, B) -> (G, n, B): the reference's
    shift-multiply sum over the diagonals, in its order."""
    from ..core.banded import Banded, _matvec_scan

    return _matvec_scan(Banded(band, lo, hi), x)


def banded_matvec(band: torch.Tensor, x: torch.Tensor, lo: int, hi: int,
                  backend: str | None = None):
    """y = M x for band (G, n, lo+hi+1) and x (G, n, B), float64. CUDA
    tensors launch ``csrc/banded_matvec.cu``."""
    if resolve_backend(backend, band.device) == "plain":
        return banded_matvec_plain(band, x, lo, hi)
    if not (0 <= lo <= MAX_HALF_WIDTH and 0 <= hi <= MAX_HALF_WIDTH):
        raise ValueError(
            f"banded_matvec kernel takes 0 <= lo, hi <= {MAX_HALF_WIDTH}")
    G, n, _ = band.shape
    B = x.shape[-1]
    dev = band.device
    _build.expect(band, "band", torch.float64, (G, n, lo + hi + 1), dev)
    _build.expect(x, "x", torch.float64, (G, n, B), dev)
    y = torch.empty_like(x)
    lib = _build.load_library()
    err = lib.repro_banded_matvec_f64(band.data_ptr(), x.data_ptr(),
                                      y.data_ptr(), G, n, lo, hi, B,
                                      _build.stream_handle(dev))
    _build.check(err, "banded_matvec")
    _build.count_launch("banded_matvec")
    return y
