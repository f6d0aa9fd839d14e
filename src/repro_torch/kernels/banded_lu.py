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


def banded_lu_plain(band: torch.Tensor, rhs, lo: int, hi: int,
                    solve: bool = True, logdet: bool = True):
    """band (G, n, lo+hi+1), rhs (G, n, B) -> (x (G, n, B), logdet (G,)).

    The kernel body's row recurrence, batched over G and the RHS columns.
    U rows sit at ``row + lo`` behind ``lo`` identity rows, so the first
    rows eliminate against no-op pivots. ``solve=False`` (rhs may be None)
    returns x as None, ``logdet=False`` the log-determinant as None.
    """
    G, n, _ = band.shape
    if not solve:
        rhs = band.new_zeros((G, n, 0))
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
    ld = torch.log(torch.abs(diag)).sum(dim=1) if logdet else None
    if not solve:
        return None, ld
    if hi == 0:
        return Y[:, lo:lo + n, :] / diag[:, :, None], ld
    xp = band.new_zeros((G, n + hi, B))
    for i in range(n - 1, -1, -1):
        u_row = U[:, i + lo, :]
        acc = Y[:, i + lo, :] - (u_row[:, 1:, None] * xp[:, i + 1:i + 1 + hi, :]
                                 ).sum(dim=1)
        xp[:, i, :] = acc / u_row[:, 0:1]
    return xp[:, :n, :], ld


# rows per log-determinant tile of the lo = hi = 0 kernel
# (csrc/banded_lu.cu LOG_ROWS)
_LOG_ROWS = 1024
_counters: dict = {}


def _tile_counters(dev, stream: int, G: int) -> torch.Tensor:
    """Zeroed per-matrix tile counters for the lo = hi = 0 log-determinant,
    one buffer per device and stream: each launch's last tile resets its
    counter, so the buffer is zeroed once, when it is made."""
    key = (dev, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < G:
        buf = torch.zeros((max(G, 64),), dtype=torch.int32, device=dev)
        _counters[key] = buf
    return buf


def banded_lu(band: torch.Tensor, rhs, lo: int, hi: int,
              backend: str | None = None, solve: bool = True,
              logdet: bool = True):
    """Solve M x = rhs and return ``(x, log|det M|)``; band (G, n, lo+hi+1),
    rhs (G, n, B), float64. ``solve=False`` (the reference's flag; rhs may
    be None) returns x as None; ``logdet=False`` returns the
    log-determinant as None. At lo = hi = 0 the kernel skips the half it is
    not asked for. CUDA tensors launch ``csrc/banded_lu.cu``."""
    if not (solve or logdet):
        raise ValueError("banded_lu: nothing to compute")
    if resolve_backend(backend, band.device) == "plain":
        return banded_lu_plain(band, rhs, lo, hi, solve=solve, logdet=logdet)
    if lo > MAX_HALF_WIDTH or hi > MAX_HALF_WIDTH:
        raise ValueError(f"banded_lu kernel takes lo, hi <= {MAX_HALF_WIDTH}")
    G, n, w = band.shape
    dev = band.device
    f64 = torch.float64
    _build.expect(band, "band", f64, (G, n, lo + hi + 1), dev)
    if solve:
        _build.expect(rhs, "rhs", f64, (G, n, rhs.shape[-1]), dev)
    stream = _build.stream_handle(dev)
    ld = ubuf = part = count = None
    if lo == 0 and hi == 0:
        rhs = rhs if solve else None
        x = torch.empty_like(rhs) if solve else None
        if logdet:  # ld and the per-tile partials in one allocation
            buf = torch.empty((G * (1 + -(-n // _LOG_ROWS)),), dtype=f64,
                              device=dev)
            ld, part = buf[:G], buf[G:]
            count = _tile_counters(dev, stream, G)
    else:  # the general kernel always solves and sums the log-determinant
        if not solve:
            rhs = band.new_zeros((G, n, 1))
        x = torch.empty_like(rhs)
        ld = torch.empty((G,), dtype=f64, device=dev)
        ubuf = torch.empty((G, n, hi + 1), dtype=f64, device=dev)
    B = rhs.shape[-1] if rhs is not None else 1
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load_library()
    err = lib.repro_banded_lu_f64(
        band.data_ptr(), ptr(rhs), ptr(x), ptr(ld), ptr(ubuf), ptr(part),
        ptr(count), G, n, lo, hi, B, stream)
    _build.check(err, "banded_lu")
    _build.count_launch("banded_lu")
    return (x if solve else None), (ld if logdet else None)
