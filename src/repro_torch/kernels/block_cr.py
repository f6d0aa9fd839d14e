"""Block cyclic-reduction banded solve + exact log-determinant: CUDA kernel
and plain version.

Counterpart of ``repro.kernels.block_cr`` (``cr_solve_values``,
``block_cr_pallas``, ``block_cr_solve_pallas``, ``block_cr_logdet_pallas``).
A band with ``lo = hi = w`` is viewed as block-tridiagonal with ``w x w``
blocks

    A_i x_{i-1} + B_i x_i + C_i x_{i+1} = r_i,      i = 0..nb-1,

and eliminated by even/odd cyclic reduction: at level ``k`` (stride
``s = 2^k``) every surviving even row folds its two odd neighbours into
itself; back substitution replays the levels in reverse. Eliminated rows
are frozen in place, so ``log|det| = sum_i log|det B_i|``. ``pivot=True``
runs the ``w x w`` block solves with partial pivoting inside each block.

On the card the elimination is the device function ``csrc/cr.cuh``: the
standalone launch is ``csrc/block_cr.cu`` (one thread block per matrix),
and the relaxation kernels (``csrc/jacobi.cu``, ``gauss_seidel.cu``,
through ``csrc/sweep.cuh``) call the same function. The wrappers launch it
for CUDA tensors and run :func:`block_cr_plain` for CPU tensors.

Factor once, apply per right-hand side: everything the elimination does
that does not read the right-hand side (the coefficients ``alpha``,
``beta`` of every level's even rows, and the block triples once every level
has run) is the factor, :func:`block_cr_factor` (``csrc/block_cr.cu``'s
factor launch) with its plain twin :func:`block_cr_factor_plain`; the
right-hand-side updates replayed from it are :func:`block_cr_apply_plain`
on the CPU and ``cr.cuh``'s ``cr_block_apply`` inside the whole-solve PCG
kernel (``csrc/mega_pcg.cu``). Factor plus apply gives the solve's bits.
"""
from __future__ import annotations

import torch

from . import _build
from .ops import resolve_backend

__all__ = ["cr_solve_values", "block_cr", "block_cr_plain", "block_cr_solve",
           "block_cr_logdet", "block_cr_factor", "block_cr_factor_plain",
           "block_cr_apply_plain", "cr_factor_size", "MAX_W",
           "MAX_FACTOR_W"]

MAX_W = 4  # w <= 4 (csrc/block_cr.cu instantiations)
MAX_FACTOR_W = 3  # w <= 3 for the factor (the PCG kernel's widths)


def _nbr(x, d):
    """x[:, i+d] along the block axis (dim 1) with zero fill."""
    if d == 0:
        return x
    n = x.shape[1]
    out = torch.zeros_like(x)
    k = max(n - abs(d), 0)
    if d > 0:
        out[:, :k] = x[:, n - k:]
    else:
        out[:, n - k:] = x[:, :k]
    return out


def _small_solve(M, R, pivot: bool = False):
    """Gaussian elimination of (..., w, w) against (..., w, m), optionally
    with partial pivoting inside each block (the first row of largest
    magnitude in column t moves to row t, for t < w - 1).

    Returns (X, log|det M| per block). A zero pivot is replaced by 1, as in
    the reference's ``_small_solve``.
    """
    w = M.shape[-1]
    A = torch.cat([M, R], dim=-1)
    ld = M.new_zeros(M.shape[:-2])
    rows = torch.arange(w, device=M.device)
    for t in range(w):
        if pivot and t < w - 1:
            col = torch.where(rows >= t, torch.abs(A[..., :, t]),
                              torch.full((), -1.0, dtype=A.dtype,
                                         device=A.device))
            p = torch.argmax(col, dim=-1)  # first maximum, as jnp.argmax
            src = torch.where(rows == t, p[..., None],
                              torch.where(rows == p[..., None], t, rows))
            A = torch.gather(A, -2, src[..., None].expand(A.shape))
        piv = A[..., t, t]
        ld = ld + torch.log(torch.abs(piv))
        safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        f = torch.where(rows > t, A[..., :, t] / safe[..., None],
                        torch.zeros((), dtype=A.dtype, device=A.device))
        A = A - f[..., None] * A[..., t:t + 1, :]
    X = torch.zeros_like(R)
    for t in range(w - 1, -1, -1):
        acc = A[..., t, w:]
        for u in range(t + 1, w):
            acc = acc - A[..., t, u][..., None] * X[..., u, :]
        piv = A[..., t, t]
        X[..., t, :] = acc / torch.where(piv == 0, torch.ones_like(piv),
                                         piv)[..., None]
    return X, ld


def _band_to_blocks(data, w, nb):
    """(G, nb*w, 2w+1) row-aligned band -> block triples (G, nb, w, w)."""
    G = data.shape[0]
    blk = data.reshape(G, nb, w, 2 * w + 1)

    def tri(off):
        out = data.new_zeros((G, nb, w, w))
        for r in range(w):
            for c in range(w):
                j = off + c - r
                if 0 <= j <= 2 * w:
                    out[:, :, r, c] = blk[:, :, r, j]
        return out

    return tri(0), tri(w), tri(2 * w)


def _bmm(a, b):
    return torch.einsum("gnij,gnjk->gnik", a, b)


def cr_solve_values(data, rhs, *, w: int, nb: int, steps: int,
                    pivot: bool = False, solve: bool = True):
    """Block cyclic reduction on (G, nb*w, 2w+1) bands and (G, nb*w, B)
    right-hand sides (identity-padded past the real rows); ``pivot`` selects
    the pivoted block solves.

    Returns ``(x (G, nb*w, B), logdet (G,))``.
    """
    G, _, B = rhs.shape
    Ab, Bb, Cb = _band_to_blocks(data, w, nb)
    R = rhs.reshape(G, nb, w, B)
    idx = torch.arange(nb, device=data.device)
    eye = torch.eye(w, dtype=data.dtype, device=data.device).expand(G, nb, w, w)
    for k in range(steps):
        s = 1 << k
        even = ((idx % s) == 0) & (((idx // s) % 2) == 0)
        Binv, _ = _small_solve(Bb, eye, pivot)
        alpha = -_bmm(Ab, _nbr(Binv, -s))
        beta = -_bmm(Cb, _nbr(Binv, s))
        m = even[None, :, None, None]
        Bb = torch.where(m, Bb + _bmm(alpha, _nbr(Cb, -s))
                         + _bmm(beta, _nbr(Ab, s)), Bb)
        R = torch.where(m, R + _bmm(alpha, _nbr(R, -s))
                        + _bmm(beta, _nbr(R, s)), R)
        Ab = torch.where(m, _bmm(alpha, _nbr(Ab, -s)), Ab)
        Cb = torch.where(m, _bmm(beta, _nbr(Cb, s)), Cb)
    X0, ld_all = _small_solve(Bb, R, pivot)
    ld = ld_all.sum(dim=1)
    if not solve:
        return rhs.new_zeros((G, nb * w, B)), ld
    x = torch.where(idx[None, :, None, None] == 0, X0, torch.zeros_like(X0))
    for k in range(steps - 1, -1, -1):
        s = 1 << k
        odd = ((idx % s) == 0) & (((idx // s) % 2) == 1)
        rhs_k = R - _bmm(Ab, _nbr(x, -s)) - _bmm(Cb, _nbr(x, s))
        Xk, _ = _small_solve(Bb, rhs_k, pivot)
        x = torch.where(odd[None, :, None, None], Xk, x)
    return x.reshape(G, nb * w, B), ld


def _padded(band, rhs, w):
    G, n, width = band.shape
    nb = max(1, -(-n // w))
    npad = nb * w
    band_p = band.new_zeros((G, npad, width))
    band_p[:, :, w] = 1.0
    band_p[:, :n] = band
    rhs_p = rhs.new_zeros((G, npad, rhs.shape[-1]))
    rhs_p[:, :n] = rhs
    return band_p, rhs_p, nb, max(0, (nb - 1).bit_length())


def block_cr_plain(band, rhs, w: int, pivot: bool = False,
                   solve: bool = True):
    """band (G, n, 2w+1), rhs (G, n, B) -> (x (G, n, B), logdet (G,)); x is
    zeros when ``solve`` is False."""
    n = band.shape[1]
    band_p, rhs_p, nb, steps = _padded(band, rhs, w)
    x, ld = cr_solve_values(band_p, rhs_p, w=w, nb=nb, steps=steps,
                            pivot=pivot, solve=solve)
    return x[:, :n], ld


def block_cr(band, rhs, w: int, pivot: bool = False, solve: bool = True,
             backend: str | None = None):
    """Block cyclic reduction of a (G, n, 2w+1) band (lo = hi = w) against
    rhs (G, n, B), float64; returns ``(x, logdet)``. CUDA tensors launch
    ``csrc/block_cr.cu``; with ``solve=False`` only the log-determinant is
    computed and x is None."""
    if resolve_backend(backend, band.device) == "plain":
        x, ld = block_cr_plain(band, rhs, w, pivot=pivot, solve=solve)
        return (x if solve else None), ld
    if not 1 <= w <= MAX_W:
        raise ValueError(f"block_cr kernel takes 1 <= w <= {MAX_W}")
    G, n, _ = band.shape
    B = rhs.shape[-1]
    dev = band.device
    _build.expect(band, "band", torch.float64, (G, n, 2 * w + 1), dev)
    _build.expect(rhs, "rhs", torch.float64, (G, n, B), dev)
    band_p, x_p, nb, _ = _padded(band, rhs, w)
    npad = nb * w
    work = torch.empty((3, G, nb, w, w), dtype=torch.float64, device=dev)
    ld = torch.empty((G,), dtype=torch.float64, device=dev)
    lib = _build.load_library()
    err = lib.repro_block_cr_f64(
        band_p.data_ptr(), x_p.data_ptr(), ld.data_ptr(), work.data_ptr(), G,
        npad, w, B, int(pivot), int(solve), _build.stream_handle(dev))
    _build.check(err, "block_cr")
    _build.count_launch("block_cr")
    return (x_p[:, :n] if solve else None), ld


def block_cr_solve(band, rhs, w: int, pivot: bool = False,
                   backend: str | None = None):
    """Solve with a (G, n, 2w+1) band, rhs (G, n, B)."""
    x, _ = block_cr(band, rhs, w, pivot=pivot, backend=backend)
    return x


def block_cr_logdet(band, w: int, pivot: bool = False,
                    backend: str | None = None):
    """log|det| of a (G, n, 2w+1) band (a width-1 dummy right-hand side, no
    back substitution)."""
    dummy = band.new_zeros(band.shape[:2] + (1,))
    _, ld = block_cr(band, dummy, w, pivot=pivot, solve=False,
                     backend=backend)
    return ld


# ---------------------------------------------------------------------------
# factor once, apply per right-hand side
# ---------------------------------------------------------------------------


def _levels(nb: int) -> int:
    return max(0, (nb - 1).bit_length())


def _even_rows(nb: int) -> list[int]:
    """Even rows (i = 2^{k+1} j < nb) of each level k."""
    return [-(-nb // (2 << k)) for k in range(_levels(nb))]


def cr_factor_size(nb: int, w: int) -> int:
    """float64 entries of one band's factor: the A, B, C blocks (nb each)
    and alpha, beta of every level's even rows, each block w x w."""
    return (3 * nb + 2 * sum(_even_rows(nb))) * w * w


def _check_factor_band(band, w):
    if not 1 <= w <= MAX_FACTOR_W:
        raise ValueError(f"the block-CR factor takes 1 <= w <= {MAX_FACTOR_W}")
    if band.shape[1] % w:
        raise ValueError(f"the block-CR factor takes n a multiple of w: "
                         f"n={band.shape[1]}, w={w}")
    return band.shape[0], band.shape[1] // w


def block_cr_factor_plain(band, w: int, pivot: bool = False):
    """The factor of (G, n, 2w+1) bands, n = nb w (identity-padded to whole
    blocks): (G, cr_factor_size(nb, w)), laid out as ``csrc/cr.cuh``'s
    ``cr_block_factor`` stores it. The block elimination of
    :func:`cr_solve_values`, op for op."""
    G, nb = _check_factor_band(band, w)
    Ab, Bb, Cb = _band_to_blocks(band, w, nb)
    idx = torch.arange(nb, device=band.device)
    eye = torch.eye(w, dtype=band.dtype, device=band.device).expand(
        G, nb, w, w)
    als, bes = [], []
    for k in range(_levels(nb)):
        s = 1 << k
        even = ((idx % s) == 0) & (((idx // s) % 2) == 0)
        Binv, _ = _small_solve(Bb, eye, pivot)
        alpha = -_bmm(Ab, _nbr(Binv, -s))
        beta = -_bmm(Cb, _nbr(Binv, s))
        m = even[None, :, None, None]
        Bb = torch.where(m, Bb + _bmm(alpha, _nbr(Cb, -s))
                         + _bmm(beta, _nbr(Ab, s)), Bb)
        Ab = torch.where(m, _bmm(alpha, _nbr(Ab, -s)), Ab)
        Cb = torch.where(m, _bmm(beta, _nbr(Cb, s)), Cb)
        als.append(alpha[:, ::2 * s])
        bes.append(beta[:, ::2 * s])
    return torch.cat([t.reshape(G, -1) for t in (Ab, Bb, Cb, *als, *bes)],
                     dim=1)


def block_cr_apply_plain(factor, rhs, w: int, pivot: bool = False):
    """Solve from a factor (G, cr_factor_size(nb, w)) against rhs
    (G, nb w, B): the right-hand-side updates of :func:`cr_solve_values`,
    op for op, with alpha, beta and the final blocks read from the factor
    (its result is that of :func:`block_cr_plain`, bit for bit)."""
    G, n, B = rhs.shape
    nb = n // w
    ne = _even_rows(nb)
    sizes = [nb] * 3 + ne + ne
    parts = torch.split(factor, [c * w * w for c in sizes], dim=1)
    Ab, Bb, Cb = (t.reshape(G, nb, w, w) for t in parts[:3])
    als, bes = parts[3:3 + len(ne)], parts[3 + len(ne):]
    R = rhs.reshape(G, nb, w, B)
    idx = torch.arange(nb, device=rhs.device)
    for k in range(len(ne)):
        s = 1 << k
        even = ((idx % s) == 0) & (((idx // s) % 2) == 0)
        alpha, beta = (torch.zeros_like(Ab) for _ in range(2))
        alpha[:, ::2 * s] = als[k].reshape(G, ne[k], w, w)
        beta[:, ::2 * s] = bes[k].reshape(G, ne[k], w, w)
        R = torch.where(even[None, :, None, None],
                        R + _bmm(alpha, _nbr(R, -s)) + _bmm(beta, _nbr(R, s)),
                        R)
    X0, _ = _small_solve(Bb, R, pivot)
    x = torch.where(idx[None, :, None, None] == 0, X0, torch.zeros_like(X0))
    for k in range(len(ne) - 1, -1, -1):
        s = 1 << k
        odd = ((idx % s) == 0) & (((idx // s) % 2) == 1)
        rhs_k = R - _bmm(Ab, _nbr(x, -s)) - _bmm(Cb, _nbr(x, s))
        Xk, _ = _small_solve(Bb, rhs_k, pivot)
        x = torch.where(odd[None, :, None, None], Xk, x)
    return x.reshape(G, n, B)


def block_cr_factor(band, w: int, pivot: bool = False,
                    backend: str | None = None):
    """The block-CR factor of (G, n, 2w+1) bands (lo = hi = w, n a multiple
    of w), float64: (G, cr_factor_size(n // w, w)). CUDA tensors launch
    ``csrc/block_cr.cu``'s factor kernel (one block per band)."""
    if resolve_backend(backend, band.device) == "plain":
        return block_cr_factor_plain(band, w, pivot=pivot)
    G, nb = _check_factor_band(band, w)
    dev = band.device
    _build.expect(band, "band", torch.float64, (G, nb * w, 2 * w + 1), dev)
    fac = torch.empty((G, cr_factor_size(nb, w)), dtype=torch.float64,
                      device=dev)
    lib = _build.load_library()
    err = lib.repro_cr_factor_f64(band.data_ptr(), fac.data_ptr(), G,
                                  nb * w, w, int(pivot),
                                  _build.stream_handle(dev))
    _build.check(err, "cr_factor")
    _build.count_launch("cr_factor")
    return fac
