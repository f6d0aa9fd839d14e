"""Band x band product in band form: CUDA kernel and plain version.

Counterpart of ``repro.kernels.band_matmul.band_matmul_pallas``:

    C[i, i+m] = sum_t A[i, i+t] * B[i+t, i+m],  t in [-a_lo, a_hi],

with result half-bandwidths ``a_lo + b_lo`` and ``a_hi + b_hi``; rows of B
outside ``[0, n)`` count as zero (the Pallas kernel's zero halo). The
result is not masked here: ``ops.band_band_matmul`` masks it, as the
reference's dispatch does.
"""
from __future__ import annotations

import torch

from . import _build
from .ops import resolve_backend

__all__ = ["band_matmul", "band_matmul_plain"]

MAX_WIDTH = 9  # wa, wb <= 9 in the kernel (csrc/band_matmul.cu)


def band_matmul_plain(a_band, b_band, a_lo: int, a_hi: int, b_lo: int,
                      b_hi: int):
    """(G, n, wa), (G, n, wb) -> (G, n, wa + wb - 1); the kernel's t/s order."""
    G, n, wa = a_band.shape
    wb = b_band.shape[-1]
    lo = a_lo + b_lo
    acc = a_band.new_zeros((G, n, wa + wb - 1))
    for t in range(-a_lo, a_hi + 1):
        rows = torch.zeros_like(b_band)
        k = max(n - abs(t), 0)
        if t >= 0:
            rows[:, :k] = b_band[:, n - k:]
        else:
            rows[:, n - k:] = b_band[:, :k]
        acc[:, :, lo + t - b_lo: lo + t + b_hi + 1] += (
            a_band[:, :, a_lo + t, None] * rows)
    return acc


def band_matmul(a_band, b_band, a_lo: int, a_hi: int, b_lo: int, b_hi: int,
                backend: str | None = None):
    """C = A @ B band data; (G, n, wa), (G, n, wb) float64. CUDA tensors
    launch ``csrc/band_matmul.cu``."""
    if resolve_backend(backend, a_band.device) == "plain":
        return band_matmul_plain(a_band, b_band, a_lo, a_hi, b_lo, b_hi)
    G, n, wa = a_band.shape
    wb = b_band.shape[-1]
    if wa > MAX_WIDTH or wb > MAX_WIDTH:
        raise ValueError(f"band_matmul kernel takes widths <= {MAX_WIDTH}")
    dev = a_band.device
    _build.expect(a_band, "a_band", torch.float64, (G, n, a_lo + a_hi + 1),
                  dev)
    _build.expect(b_band, "b_band", torch.float64, (G, n, b_lo + b_hi + 1),
                  dev)
    out = torch.empty((G, n, wa + wb - 1), dtype=torch.float64, device=dev)
    lib = _build.load_library()
    err = lib.repro_band_matmul_f64(
        a_band.data_ptr(), b_band.data_ptr(), out.data_ptr(), G, n, a_lo,
        a_hi, b_lo, b_hi, _build.stream_handle(dev))
    _build.check(err, "band_matmul")
    _build.count_launch("band_matmul")
    return out
