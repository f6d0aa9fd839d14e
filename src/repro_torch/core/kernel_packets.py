"""Kernel Packet (KP) and generalized-KP sparse factorizations.

Counterpart of ``repro.core.kernel_packets`` (paper Theorem 3, Theorems 5-6,
Algorithms 2-3):

    P^T k(X, X) P         = A^{-1} Phi        (A: half-bw q+1, Phi: half-bw q)
    P^T d_omega k(X,X) P  = B^{-1} Psi        (B: half-bw q+2, Psi: half-bw q+1)

All n window systems are solved at once as a batch of tiny SVD null-space
problems, with per-window centering and column scaling. Every function
takes a leading batch of dimensions: ``omega`` (...,), ``xs`` (..., n).
The SVD batch stays plain torch on every device (the reference has no
kernel for it either).
"""
from __future__ import annotations

import torch

from ..masking import lead_count
from . import matern as mk
from .banded import Banded, mask_band

__all__ = ["kp_coefficient_rows", "kp_coefficients", "gram_band_rows",
           "kp_factors", "gkp_factors", "query_window_start", "phi_at",
           "phi_grad_at"]


def _kp_row_inputs(n, q: int, rows: torch.Tensor, clip_n: int | None = None):
    """Window indices, validity, signs and auxiliary-equation counts for
    ``rows`` (..., r). ``n`` is the matrix size, a python int or (capacity
    padding) a tensor that only enters comparisons: 0-d, or counts that
    broadcast against ``rows`` (a fleet's per-dimension counts); ``clip_n``
    the static allocation the gather indices are clipped to (default n)."""
    t = torch.arange(-(q + 1), q + 2, device=rows.device)
    j = rows[..., None] + t
    valid = (j >= 0) & (j < _per_window(n))
    j_idx = j.clamp(0, (n if clip_n is None else clip_n) - 1)
    is_left = rows <= q
    is_right = rows >= n - q - 1
    one = torch.ones((), dtype=torch.float64, device=rows.device)
    psign = torch.where(is_left, one, torch.where(is_right, -one, one))
    naux = torch.where(is_left, rows,
                       torch.where(is_right, n - 1 - rows,
                                   torch.full_like(rows, q + 1)))
    return j_idx, valid, psign, -psign, naux.clamp(max=q + 1)


def _per_window(n):
    """A count that broadcasts against rows (..., r), shaped for their
    windows (..., r, w)."""
    return n[..., None] if torch.is_tensor(n) and n.ndim else n


def _kp_build_rows(q: int, omega, xrow, vrow, psign, asign, naux):
    """KP coefficient rows from window points (..., r, P) + categories
    (..., r), the categories broadcast against the points' leading dims."""
    P = 2 * q + 3
    dev, dt = xrow.device, xrow.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    vrow = vrow.expand(xrow.shape)
    bshape = xrow.shape[:-1]
    psign, asign, naux = (t.expand(bshape) for t in (psign, asign, naux))
    om = omega[..., None, None]
    c = torch.where(vrow, xrow, zero).sum(-1) / vrow.sum(-1).clamp(min=1)
    xt = torch.where(vrow, xrow - c[..., None], zero)
    s = torch.abs(xt).amax(-1).clamp(min=1e-30)
    xh = xt / s[..., None]
    col_log = -om * torch.abs(xt)
    ls = torch.arange(q + 1, dtype=dt, device=dev)[:, None]
    powx = xh[..., None, :] ** ls
    prim = powx * torch.exp(psign[..., None, None] * om[..., None]
                            * xt[..., None, :] + col_log[..., None, :])
    aux = powx * torch.exp(asign[..., None, None] * om[..., None]
                           * xt[..., None, :] + col_log[..., None, :])
    aux_valid = torch.arange(q + 1, device=dev) < naux[..., None]
    aux = torch.where(aux_valid[..., None], aux, zero)
    E = torch.cat([prim, aux], dim=-2)  # (..., r, 2q+2, P)
    # pin a_j = 0 on invalid columns: each masked aux slot takes a unit row
    # selecting one invalid column
    inv_cols = ~vrow
    inv_rank = (torch.cumsum(inv_cols.long(), -1) - 1).clamp(0, q)
    pin_rows = (torch.nn.functional.one_hot(inv_rank, q + 1).to(dt)
                * inv_cols[..., None]).transpose(-1, -2)  # (..., r, q+1, P)
    slot = torch.arange(q + 1, device=dev)
    shift = slot - naux[..., None]
    take = (shift >= 0) & (slot >= naux[..., None])
    pin = torch.gather(pin_rows, -2,
                       shift.clamp(0, q)[..., None].expand(pin_rows.shape))
    pin = torch.where(take[..., None], pin, zero)
    E = torch.cat([E[..., :q + 1, :], E[..., q + 1:, :] + pin], dim=-2)
    _, _, vh = torch.linalg.svd(E, full_matrices=True)
    a = vh[..., -1, :] * torch.exp(col_log)
    a = torch.where(vrow, a, zero)
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp(min=1e-30)
    ctr = a[..., q + 1]
    sign = torch.sign(ctr) + (ctr == 0).to(dt)
    return a * sign[..., None]


def _take(xs, idx):
    """xs (..., n) at window indices: idx (r, w) shared by every leading
    dim, or (..., r, w) per leading dim."""
    if idx.ndim == 2:
        return xs[..., idx]
    return torch.gather(xs, -1, idx.reshape(idx.shape[:-2] + (-1,))).reshape(
        idx.shape)


def kp_coefficient_rows(q: int, omega, xs, rows, n_active=None):
    """KP coefficient rows (..., r, 2q+3) for a subset of rows: ``rows``
    (r,) shared by the leading dims of ``xs`` (..., n), or (..., r) per
    leading dim (the streaming window of each dimension).

    Each row is computed as :func:`kp_coefficients` computes it for the
    whole matrix. Under capacity padding ``n_active`` (0-d tensor) is the
    matrix size: validity and the Algorithm-2 boundary category use it, and
    tail ``xs`` values are masked out of the window math."""
    n = xs.shape[-1]
    na = n if n_active is None else n_active
    j_idx, valid, psign, asign, naux = _kp_row_inputs(na, q, rows, clip_n=n)
    xw = torch.where(valid, _take(xs, j_idx),
                     torch.zeros((), dtype=xs.dtype, device=xs.device))
    return _kp_build_rows(q, omega, xw, valid, psign, asign, naux)


def kp_coefficients(q: int, omega, xs) -> Banded:
    """KP coefficient matrix A (lo = hi = q+1) on sorted ``xs`` (..., n)."""
    n = xs.shape[-1]
    data = kp_coefficient_rows(q, omega, xs,
                               torch.arange(n, device=xs.device))
    return mask_band(Banded(data, q + 1, q + 1))


def gram_band_rows(kfun, xs, a_rows, rows, loA: int, hiA: int, hw: int,
                   n_active=None):
    """Rows of the band of Phi = A @ K restricted to ``rows`` ((r,) shared,
    or (..., r) per leading dim, as :func:`kp_coefficient_rows`).

    ``kfun(x, y)`` broadcasts over (..., r, wPhi, wA) window points. Under
    capacity padding ``n_active`` bounds validity; out-of-range window
    points are zeroed before ``kfun``, so poisoned tail slots cannot make
    NaNs that survive the mask.
    """
    n = xs.shape[-1]
    na = n if n_active is None else n_active
    dev = xs.device
    zero = torch.zeros((), dtype=xs.dtype, device=dev)
    j = rows[..., None] + torch.arange(-loA, hiA + 1, device=dev)
    vv = (j >= 0) & (j < _per_window(na))
    xw = torch.where(vv, _take(xs, j.clamp(0, n - 1)), zero)
    jm = rows[..., None] + torch.arange(-hw, hw + 1, device=dev)
    vm = (jm >= 0) & (jm < _per_window(na))
    xm = torch.where(vm, _take(xs, jm.clamp(0, n - 1)), zero)
    kv = kfun(xm[..., :, :, None], xw[..., :, None, :]) * vv[..., None, :]
    data = torch.einsum("...nmt,...nt->...nm", kv, a_rows)
    return data * vm


def _phi_band_from_A(kfun, xs, A: Banded, hw: int) -> Banded:
    n = xs.shape[-1]
    data = gram_band_rows(kfun, xs, A.data, torch.arange(n, device=xs.device),
                          A.lo, A.hi, hw)
    return Banded(data, hw, hw)


def kp_factors(q: int, omega, xs):
    """Algorithm 2: banded (A, Phi) with P^T K P = A^{-1} Phi (xs sorted)."""
    A = kp_coefficients(q, omega, xs)
    om = omega[..., None, None, None]
    Phi = _phi_band_from_A(lambda x, y: mk.matern(q, om, x, y), xs, A, q)
    return A, Phi


def gkp_factors(q: int, omega, xs):
    """Algorithm 3: banded (B, Psi) with P^T [d_omega K] P = B^{-1} Psi."""
    B = kp_coefficients(q + 1, omega, xs)
    om = omega[..., None, None, None]
    Psi = _phi_band_from_A(lambda x, y: mk.matern_domega(q, om, x, y), xs, B,
                           q + 1)
    return B, Psi


def query_window_start(xs, xq, n_active=None):
    """Insertion points of ``xq`` (..., m) in sorted ``xs`` (..., n). Under
    capacity padding the tail of ``xs`` may hold anything: it is read as
    +inf, so the result is the count of active entries below ``xq`` (the
    reference's masked count)."""
    if n_active is not None:
        j = torch.arange(xs.shape[-1], device=xs.device)
        xs = torch.where(j < lead_count(n_active, xs.ndim), xs,
                         torch.full((), float("inf"), dtype=xs.dtype,
                                    device=xs.device))
    return torch.searchsorted(xs.contiguous(), xq.contiguous(), side="left")


def _query_windows(q: int, omega, xs, A: Banded, xq, kfun, n_active=None):
    """Rows and values of A kfun(X, x*) in each query's KP window, for every
    dim and query: ``kfun(om, xj, xq)`` evaluates the kernel (or its
    derivative) at the window points ``xj`` (D, m, 2q+2, 2q+3), with ``om``
    (D, 1, 1, 1) and ``xq`` (D, m, 1, 1); a fleet adds a leading tenant
    axis to every input (``n_active`` (T,)). Under capacity padding
    (``n_active``, defaulting to ``A.n_active``) the rows are clamped into
    the active prefix and tail points never enter the kernel."""
    if n_active is None:
        n_active = A.n_active
    n = xs.shape[-1]
    lead = xs.shape[:-1]  # (..., D)
    m = xq.shape[-1]
    dev = xs.device
    zero = torch.zeros((), dtype=xs.dtype, device=dev)
    t = query_window_start(xs, xq, n_active=n_active)
    rows = t[..., None] + torch.arange(-(q + 1), q + 1, device=dev)
    na = n if n_active is None else lead_count(n_active, rows.ndim)
    valid = (rows >= 0) & (rows < na)
    # clamp into the active prefix: consumers gather bY / Gband at these
    # rows and multiply by the (zeroed) values, and 0 * NaN is NaN
    rows_c = (rows.clamp(0, n - 1) if n_active is None else torch.minimum(
        rows.clamp(min=0), (na - 1).clamp(min=0)))
    j = rows_c[..., None] + torch.arange(-(q + 1), q + 2, device=dev)
    jv = (j >= 0) & (j < (na if n_active is None else na[..., None]))
    jc = j.clamp(0, n - 1)
    xj = torch.where(jv, torch.gather(xs, -1, jc.reshape(lead + (-1,)))
                     .reshape(jc.shape), zero)
    kv = kfun(omega[..., None, None, None], xj, xq[..., None, None]) * jv
    wA = A.data.shape[-1]
    arows = torch.gather(A.data, -2, rows_c.reshape(lead + (-1, 1)).expand(
        lead + (m * rows_c.shape[-1], wA)))
    avals = torch.where(valid[..., None], arows.reshape(lead + (m, -1, wA)),
                        zero)
    vals = torch.einsum("...rs,...rs->...r", avals, kv) * valid
    return rows_c, vals, valid


def phi_at(q: int, omega, xs, A: Banded, xq, n_active=None):
    """Sparse KP vectors phi(x*) = A k(X, x*) for every dim and query.

    omega (D,), xs (D, n), A data (D, n, 2q+3), xq (D, m). Returns
    (rows (D, m, 2q+2), vals (D, m, 2q+2), valid mask).
    """
    return _query_windows(q, omega, xs, A, xq,
                          lambda om, xj, x: mk.matern(q, om, xj, x),
                          n_active=n_active)


def phi_grad_at(q: int, omega, xs, A: Banded, xq, n_active=None):
    """d phi(x*) / d x* for every dim and query, as :func:`phi_at` lays it
    out (the same rows and validity)."""
    return _query_windows(q, omega, xs, A, xq,
                          lambda om, xj, x: mk.matern_dx(q, om, x, xj),
                          n_active=n_active)
