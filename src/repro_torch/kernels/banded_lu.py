"""Banded LU solves + log-determinants: CUDA kernels and plain versions.

:func:`banded_lu` is the counterpart of
``repro.kernels.banded_lu.banded_lu_pallas`` (no pivoting): forward
elimination with ``lo`` multipliers per row, back substitution with ``hi``
terms per row, and ``log|det| = sum_i log|U[i, 0]|`` from the same pass
(``csrc/banded_lu.cu``).

:func:`banded_lu_pivot` is the LU route with partial pivoting, the
counterpart of the reference's LAPACK gbsv-style scan
(``repro.core.banded._lu_pivot_scan``, ``_solve_pivot_single``,
``_logdet_scan``), which has no Pallas kernel: each column's pivot is the
first largest magnitude among the ``lo + 1`` candidate rows, and U's upper
width grows to ``lo + hi`` (``csrc/banded_lu_pivot.cu``).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build
from .ops import resolve_backend

__all__ = ["banded_lu", "banded_lu_plain", "banded_lu_pivot",
           "banded_lu_pivot_plain"]

MAX_HALF_WIDTH = 7  # lo, hi <= 7 in the kernel (csrc/banded_lu.cu MAXW - 1)
# lo, hi <= 8 in the pivoted kernel (csrc/banded_lu_pivot.cu MAXL): the
# kmg/AΦ bands at q = 3 (7) and the q = 3 streaming patch (8)
MAX_PIVOT_HALF_WIDTH = 8


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


def banded_lu_pivot_plain(band: torch.Tensor, rhs, lo: int, hi: int,
                          solve: bool = True, logdet: bool = True,
                          swaps: bool = False):
    """band (G, n, lo+hi+1), rhs (G, n, B) -> (x (G, n, B), logdet (G,))
    by LU with partial pivoting, plus the swap flags (G, n) with
    ``swaps=True``.

    The reference's gbsv scan step for step, batched over G and the
    right-hand-side columns: a working window of the ``lo + 1`` candidate
    rows of column k (the first ``lo + 1`` rows to start); the pivot is the
    first largest ``|R[:, 0]|`` (``argmax``'s tie rule); row 0 and the
    pivot row swap, rows 1..lo are eliminated (each product and difference
    rounded on its own), row 0 is U's row k (width ``lo + hi + 1``), and
    the window shifts one column left and takes row ``k + lo + 1``; a row
    past n enters as zeros with 1 on its diagonal. The reference's window
    is ``2 lo + hi + 1`` wide, but its columns past ``lo + hi`` only ever
    hold zeros; here the window keeps one of them, which the shift moves
    into place, and the right-hand side rides in the same rows. Back
    substitution runs over U with upper width ``lo + hi``; ``log|det| =
    sum_k log|U[k, 0]|``. At lo = 0 nothing pivots: it is the unpivoted LU.
    ``solve=False`` (rhs may be None) returns x as None, ``logdet=False``
    the log-determinant as None.
    """
    G, n, _ = band.shape
    if not solve:
        rhs = band.new_zeros((G, n, 0))
    B = rhs.shape[-1]
    dtype = torch.promote_types(band.dtype, rhs.dtype)
    band, rhs = band.to(dtype), rhs.to(dtype)
    wu, L = lo + hi + 1, lo + 1
    W = wu + 1 + B  # a window row: [U columns (wu) | zero | right-hand side]
    dev = band.device
    # the row that enters at step k: row k + lo + 1, or a unit row past n
    inc = band.new_zeros((G, n, W))
    m = max(n - L, 0)
    inc[:, :m, :wu] = band[:, L:]
    inc[:, m:, lo] = 1.0
    inc[:, :m, wu + 1:] = rhs[:, L:]
    win = band.new_zeros((G, L, W))
    for j in range(L):  # row j covers columns j - lo .. j + hi
        if j < n:
            c0 = max(0, lo - j)
            win[:, j, j - lo + c0:j + hi + 1] = band[:, j, c0:]
            win[:, j, wu + 1:] = rhs[:, j]
        else:
            win[:, j, j] = 1.0
    ar = torch.arange(L, device=dev)
    # perms[t]: the row order after swapping rows 0 and t
    perms = torch.where(ar == 0, ar[:, None],
                        torch.where(ar == ar[:, None], 0, ar))
    rows_in = inc[:, :, None].unbind(1)
    tops, picks = [], []
    for k in range(n):
        t = win[:, :, 0].abs().argmax(dim=1)
        picks.append(t)
        win = win.gather(1, perms[t][:, :, None].expand(G, L, W))
        top, rest = win[:, :1], win[:, 1:]
        rest = rest - (rest[:, :, :1] / top[:, :, :1]) * top
        tops.append(top)
        # shift one column left: U columns 1 .. wu-1 and the zero column,
        # then the zero column again and the right-hand side
        win = torch.cat([torch.cat([rest[:, :, 1:wu + 1], rest[:, :, wu:]],
                                   2), rows_in[k]], 1)
    P = torch.cat(tops, 1)  # (G, n, W): U rows and forward-solved rhs
    U = P[:, :, :wu]
    ld = torch.log(torch.abs(U[:, :, 0])).sum(dim=1) if logdet else None
    x = None
    if solve:
        ubw = wu - 1
        u_rows = U.permute(1, 2, 0)[..., None].unbind(0)  # n x (wu, G, 1)
        ys = P[:, :, wu + 1:].unbind(1)
        nxt = [band.new_zeros((G, B))] * ubw  # x[i+1 .. i+ubw]
        xs = [None] * n
        for i in range(n - 1, -1, -1):
            u, acc = u_rows[i], ys[i]
            for s in range(1, ubw + 1):
                acc = acc - u[s] * nxt[s - 1]
            xs[i] = acc / u[0]
            nxt = [xs[i]] + nxt[:-1]
        x = torch.stack(xs, 1)
    return (x, ld, torch.stack(picks, 1) != 0) if swaps else (x, ld)


def banded_lu_pivot(band: torch.Tensor, rhs, lo: int, hi: int,
                    backend: str | None = None, solve: bool = True,
                    logdet: bool = True):
    """Solve M x = rhs by LU with partial pivoting and return ``(x,
    log|det M|)``; band (G, n, lo+hi+1), rhs (G, n, B), float64, lo, hi <=
    8. ``solve=False`` (rhs may be None) returns x as None (the kernel
    then only factors), ``logdet=False`` the log-determinant as None.
    CUDA tensors launch ``csrc/banded_lu_pivot.cu``: one block a matrix,
    its U, multipliers and pivot rows in scratch this wrapper allocates."""
    if not (solve or logdet):
        raise ValueError("banded_lu_pivot: nothing to compute")
    if resolve_backend(backend, band.device) == "plain":
        return banded_lu_pivot_plain(band, rhs, lo, hi, solve=solve,
                                     logdet=logdet)
    if not (0 <= lo <= MAX_PIVOT_HALF_WIDTH
            and 0 <= hi <= MAX_PIVOT_HALF_WIDTH):
        raise ValueError(f"banded_lu_pivot kernel takes lo, hi <= "
                         f"{MAX_PIVOT_HALF_WIDTH}")
    G, n, _ = band.shape
    dev = band.device
    f64 = torch.float64
    _build.expect(band, "band", f64, (G, n, lo + hi + 1), dev)
    B = 0
    if solve:
        B = rhs.shape[-1]
        _build.expect(rhs, "rhs", f64, (G, n, B), dev)
    x = torch.empty_like(rhs) if solve else None
    ld = torch.empty((G,), dtype=f64, device=dev) if logdet else None
    # U rows (lo+hi+1) and multipliers (lo) of every step, then its pivot
    # row's offset in the window
    work = torch.empty((G * n * (2 * lo + hi + 1),), dtype=f64, device=dev)
    picks = torch.empty((G * n,), dtype=torch.uint8, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load_library()
    err = lib.repro_banded_lu_pivot_f64(
        band.data_ptr(), ptr(rhs if solve else None), ptr(x), ptr(ld),
        work.data_ptr(), picks.data_ptr(), G, n, lo, hi, B,
        _build.stream_handle(dev))
    _build.check(err, "banded_lu_pivot")
    _build.count_launch("banded_lu_pivot")
    return x, ld
