"""Banded LU solve (no pivoting) + log-determinant: CUDA kernel and plain version.

Counterpart of ``repro.kernels.banded_lu.banded_lu_pallas``: forward
elimination with ``lo`` multipliers per row, back substitution with ``hi``
terms per row, and ``log|det| = sum_i log|U[i, 0]|`` from the same pass.
The CUDA kernel is ``csrc/banded_lu.cu``; the wrapper launches it for CUDA
tensors and runs :func:`banded_lu_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build
from .ops import resolve_backend

__all__ = ["banded_lu", "banded_lu_plain"]

MAX_HALF_WIDTH = 7  # lo, hi <= 7 in the kernel (csrc/banded_lu.cu MAXW - 1)


def banded_lu_plain(band: torch.Tensor, rhs: torch.Tensor, lo: int, hi: int):
    """band (G, n, lo+hi+1), rhs (G, n, B) -> (x (G, n, B), logdet (G,)).

    The kernel body's row recurrence, batched over G and the RHS columns.
    U rows sit at ``row + lo`` behind ``lo`` identity rows, so the first
    rows eliminate against no-op pivots.
    """
    G, n, _ = band.shape
    B = rhs.shape[-1]
    dtype = torch.promote_types(band.dtype, rhs.dtype)
    band, rhs = band.to(dtype), rhs.to(dtype)
    wu = hi + 1
    if lo > 0:
        U = band.new_zeros((G, n + lo, wu))
        U[:, :lo, 0] = 1.0
        Y = band.new_zeros((G, n + lo, B))
        for i in range(n):
            w = band[:, i, :].clone()
            y = rhs[:, i, :].clone()
            for t in range(lo):
                pu = U[:, i + t, :]
                f = w[:, t] / pu[:, 0]
                w[:, t:t + wu] -= f[:, None] * pu
                y -= f[:, None] * Y[:, i + t, :]
            U[:, i + lo] = w[:, lo:lo + wu]
            Y[:, i + lo] = y
    else:
        U, Y = band, rhs
    diag = U[:, lo:lo + n, 0]
    ld = torch.log(torch.abs(diag)).sum(dim=1)
    if hi == 0:
        return Y[:, lo:lo + n, :] / diag[:, :, None], ld
    xp = band.new_zeros((G, n + hi, B))
    for i in range(n - 1, -1, -1):
        u_row = U[:, i + lo, :]
        acc = Y[:, i + lo, :] - (u_row[:, 1:, None] * xp[:, i + 1:i + 1 + hi, :]
                                 ).sum(dim=1)
        xp[:, i, :] = acc / u_row[:, 0:1]
    return xp[:, :n, :], ld


def banded_lu(band: torch.Tensor, rhs: torch.Tensor, lo: int, hi: int,
              backend: str | None = None):
    """Solve M x = rhs and return ``(x, log|det M|)``; band (G, n, lo+hi+1),
    rhs (G, n, B), float64. CUDA tensors launch ``csrc/banded_lu.cu``."""
    if resolve_backend(backend, band.device) == "plain":
        return banded_lu_plain(band, rhs, lo, hi)
    if lo > MAX_HALF_WIDTH or hi > MAX_HALF_WIDTH:
        raise ValueError(f"banded_lu kernel takes lo, hi <= {MAX_HALF_WIDTH}")
    G, n, w = band.shape
    B = rhs.shape[-1]
    dev = band.device
    _build.expect(band, "band", torch.float64, (G, n, lo + hi + 1), dev)
    _build.expect(rhs, "rhs", torch.float64, (G, n, B), dev)
    x = torch.empty_like(rhs)
    ld = torch.empty((G,), dtype=torch.float64, device=dev)
    ubuf = torch.empty((G, n, hi + 1), dtype=torch.float64, device=dev)
    lib = _build.load_library()
    err = lib.repro_banded_lu_f64(
        band.data_ptr(), rhs.data_ptr(), x.data_ptr(), ld.data_ptr(),
        ubuf.data_ptr(), G, n, lo, hi, B, _build.stream_handle(dev))
    _build.check(err, "banded_lu")
    _build.count_launch("banded_lu")
    return x, ld
