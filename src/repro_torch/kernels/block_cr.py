"""Block cyclic-reduction banded solve + exact log-determinant: CUDA kernels
(factor, apply) and plain versions.

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

Factor once, apply per right-hand side: everything the elimination does
that does not read the right-hand side (the coefficients ``alpha``,
``beta`` of every level's even rows, and the block triples once every level
has run) is the factor, :func:`block_cr_factor` (``csrc/block_cr.cu``'s
factor launch, one thread block per band; it also gives log|det|) with its
plain twin :func:`block_cr_factor_plain`; the right-hand-side updates
replayed from it are :func:`block_cr_apply` (``csrc/block_cr.cu``'s apply
launch, (band, column chunk) items over the whole grid) with its plain twin
:func:`block_cr_apply_plain`. Factor plus apply gives :func:`block_cr_plain`'s
bits. On CUDA tensors :func:`block_cr` is one factor and one apply launch,
and :func:`block_cr_logdet` one factor launch; a caller that solves one band
many times keeps the factor (``kernels.ops.banded_factor``). The device
functions are ``csrc/cr.cuh``'s: the whole-solve PCG kernel
(``csrc/mega_pcg.cu``), the Gauss-Seidel kernel (``gauss_seidel.cu``) and
the Jacobi kernel (``jacobi.cu``) apply the same factors, through
``csrc/sweep.cuh``'s ``apply_cols``.
"""
from __future__ import annotations

import torch

from . import _build
from .ops import resolve_backend

__all__ = ["cr_solve_values", "block_cr", "block_cr_plain", "block_cr_solve",
           "block_cr_logdet", "block_cr_factor", "block_cr_factor_plain",
           "block_cr_apply", "block_cr_apply_plain", "block_cr_apply_cols",
           "cr_factor_size", "pad_band", "MAX_W", "MAX_WIDE_W"]

MAX_W = 5  # 1 <= w <= 5: csrc/block_cr.cu's factor and apply instances
# 6 <= w <= 8: its wide instances (the streaming Woodbury patch solves at
# q = 2 and 3), launched and counted apart as "cr_factor_wide" /
# "cr_apply_wide"
MAX_WIDE_W = 8


def _small_solve(M, R, pivot: bool = False, logdet: bool = True):
    """Gaussian elimination of (..., w, w) against (..., w, m), optionally
    with partial pivoting inside each block (the first row of largest
    magnitude in column t moves to row t, for t < w - 1).

    Returns (X, log|det M| per block; None without ``logdet``, which leaves
    X's bits as they are). A zero pivot is replaced by 1, as in the
    reference's ``_small_solve``.
    """
    w = M.shape[-1]
    A = torch.cat([M, R], dim=-1)
    ld = M.new_zeros(M.shape[:-2]) if logdet else None
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
        if logdet:
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


def _pair_rows(X, first: int, step: int, rows: int):
    """``rows`` rows of X's block axis (dim 1), from ``first`` every
    ``step``, zero where that runs past either end: the neighbours a
    reduction level pairs with its rows (the even rows 0, 2s, ... with
    rows -s and +s from them, the odd rows s, 3s, ... with theirs)."""
    if first < 0:
        return torch.cat([torch.zeros_like(X[:, :1]),
                          _pair_rows(X, first + step, step, rows - 1)], dim=1)
    part = X[:, first::step][:, :rows]
    if part.shape[1] < rows:
        part = torch.cat([part, torch.zeros_like(
            X[:, :rows - part.shape[1]])], dim=1)
    return part


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
    R = rhs.reshape(G, nb, w, B).clone()
    eye = torch.eye(w, dtype=data.dtype, device=data.device).expand(G, nb, w, w)
    for k in range(steps):
        s = 1 << k
        alpha, beta = _eliminate(Ab, Bb, Cb, eye, pivot, s)
        ev = slice(0, None, 2 * s)
        ne = alpha.shape[1]
        R[:, ev] = (R[:, ev] + _bmm(alpha, _pair_rows(R, -s, 2 * s, ne))
                    + _bmm(beta, _pair_rows(R, s, 2 * s, ne)))
    X0, ld_all = _small_solve(Bb, R, pivot)
    ld = ld_all.sum(dim=1)
    if not solve:
        return rhs.new_zeros((G, nb * w, B)), ld
    x = torch.zeros_like(X0)
    x[:, 0] = X0[:, 0]
    _back_substitute(x, R, Ab, Bb, Cb, pivot, steps)
    return x.reshape(G, nb * w, B), ld


def _eliminate(Ab, Bb, Cb, eye, pivot, s: int):
    """One reduction level (s = 2^k) of the block elimination, in place:
    the even rows 0, 2s, ... eliminate their odd neighbours s, 3s, ...;
    returns the level's (alpha, beta) at the even rows. Only the rows a
    level reads and writes are computed (each block's arithmetic is the
    same as over the whole axis, so are its bits)."""
    ev, od = slice(0, None, 2 * s), slice(s, None, 2 * s)
    binv, _ = _small_solve(Bb[:, od], eye[:, od], pivot, logdet=False)
    ne = Ab[:, ev].shape[1]
    # binv holds the odd rows only: even row j's neighbours are its rows
    # j - 1 and j
    alpha = -_bmm(Ab[:, ev], _pair_rows(binv, -1, 1, ne))
    beta = -_bmm(Cb[:, ev], _pair_rows(binv, 0, 1, ne))
    b_new = (Bb[:, ev] + _bmm(alpha, _pair_rows(Cb, -s, 2 * s, ne))
             + _bmm(beta, _pair_rows(Ab, s, 2 * s, ne)))
    a_new = _bmm(alpha, _pair_rows(Ab, -s, 2 * s, ne))
    c_new = _bmm(beta, _pair_rows(Cb, s, 2 * s, ne))
    Bb[:, ev], Ab[:, ev], Cb[:, ev] = b_new, a_new, c_new
    return alpha, beta


def _back_substitute(x, R, Ab, Bb, Cb, pivot, steps: int):
    """The levels' back substitution, in place on ``x`` (row 0 set): each
    level's odd rows from their even neighbours, coarsest level first."""
    nb = x.shape[1]
    for k in range(steps - 1, -1, -1):
        s = 1 << k
        od = slice(s, None, 2 * s)
        no = len(range(s, nb, 2 * s))
        rhs_k = (R[:, od] - _bmm(Ab[:, od], _pair_rows(x, 0, 2 * s, no))
                 - _bmm(Cb[:, od], _pair_rows(x, 2 * s, 2 * s, no)))
        x[:, od], _ = _small_solve(Bb[:, od], rhs_k, pivot, logdet=False)


def pad_band(band, w):
    """(G, n, 2w+1) -> (G, nb w, 2w+1), nb = ceil(n / w): identity rows past
    n, so the band tiles into whole w x w blocks."""
    G, n, width = band.shape
    npad = max(1, -(-n // w)) * w
    if npad == n:
        return band
    band_p = band.new_zeros((G, npad, width))
    band_p[:, :, w] = 1.0
    band_p[:, :n] = band
    return band_p


def pad_rows(x, npad):
    """(G, n, B) -> (G, npad, B) with zero rows past n."""
    if x.shape[1] == npad:
        return x
    out = x.new_zeros((x.shape[0], npad, x.shape[2]))
    out[:, :x.shape[1]] = x
    return out


def _padded(band, rhs, w):
    band_p = pad_band(band, w)
    nb = band_p.shape[1] // w
    return (band_p, pad_rows(rhs, nb * w), nb,
            max(0, (nb - 1).bit_length()))


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
    ``csrc/block_cr.cu``'s factor (with the log-determinant) and, when
    ``solve``, its apply; with ``solve=False`` x is None."""
    if resolve_backend(backend, band.device) == "plain":
        x, ld = block_cr_plain(band, rhs, w, pivot=pivot, solve=solve)
        return (x if solve else None), ld
    n = band.shape[1]
    band_p = pad_band(band, w)
    fac, ld = block_cr_factor(band_p, w, pivot=pivot, logdet=True)
    if not solve:
        return None, ld
    x = block_cr_apply(fac, pad_rows(rhs, band_p.shape[1]), w, pivot=pivot)
    return x[:, :n], ld


def block_cr_solve(band, rhs, w: int, pivot: bool = False,
                   backend: str | None = None):
    """Solve with a (G, n, 2w+1) band, rhs (G, n, B)."""
    x, _ = block_cr(band, rhs, w, pivot=pivot, backend=backend)
    return x


def block_cr_logdet(band, w: int, pivot: bool = False,
                    backend: str | None = None):
    """log|det| of a (G, n, 2w+1) band: the factor's (one factor launch on
    CUDA tensors, no right-hand side)."""
    _, ld = block_cr_factor(pad_band(band, w), w, pivot=pivot, logdet=True,
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
    if not 1 <= w <= MAX_WIDE_W:
        raise ValueError(f"the block-CR factor takes 1 <= w <= {MAX_WIDE_W}")
    if band.shape[1] % w:
        raise ValueError(f"the block-CR factor takes n a multiple of w: "
                         f"n={band.shape[1]}, w={w}")
    return band.shape[0], band.shape[1] // w


def block_cr_factor_plain(band, w: int, pivot: bool = False,
                          logdet: bool = False):
    """The factor of (G, n, 2w+1) bands, n = nb w (identity-padded to whole
    blocks): (G, cr_factor_size(nb, w)), laid out as ``csrc/cr.cuh``'s
    ``cr_block_factor`` stores it. The block elimination of
    :func:`cr_solve_values`, op for op; with ``logdet`` also log|det| (G,)
    as :func:`cr_solve_values` reduces it, returned as ``(factor,
    logdet)``."""
    G, nb = _check_factor_band(band, w)
    Ab, Bb, Cb = _band_to_blocks(band, w, nb)
    eye = torch.eye(w, dtype=band.dtype, device=band.device).expand(
        G, nb, w, w)
    als, bes = [], []
    for k in range(_levels(nb)):
        alpha, beta = _eliminate(Ab, Bb, Cb, eye, pivot, 1 << k)
        als.append(alpha)
        bes.append(beta)
    fac = torch.cat([t.reshape(G, -1) for t in (Ab, Bb, Cb, *als, *bes)],
                    dim=1)
    if not logdet:
        return fac
    _, ld = _small_solve(Bb, Bb.new_zeros(Bb.shape[:-1] + (1,)), pivot)
    return fac, ld.sum(dim=1)


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
    R = rhs.reshape(G, nb, w, B).clone()
    for k in range(len(ne)):
        s = 1 << k
        ev = slice(0, None, 2 * s)
        R[:, ev] = (R[:, ev] + _bmm(als[k].reshape(G, ne[k], w, w),
                                    _pair_rows(R, -s, 2 * s, ne[k]))
                    + _bmm(bes[k].reshape(G, ne[k], w, w),
                           _pair_rows(R, s, 2 * s, ne[k])))
    x = torch.zeros_like(R)
    x[:, :1], _ = _small_solve(Bb[:, :1], R[:, :1], pivot, logdet=False)
    _back_substitute(x, R, Ab, Bb, Cb, pivot, len(ne))
    return x.reshape(G, n, B)


def block_cr_factor(band, w: int, pivot: bool = False, logdet: bool = False,
                    backend: str | None = None):
    """The block-CR factor of (G, n, 2w+1) bands (lo = hi = w, n a multiple
    of w), float64: (G, cr_factor_size(n // w, w)); with ``logdet``,
    ``(factor, log|det| (G,))``. CUDA tensors launch ``csrc/block_cr.cu``'s
    factor kernel (one block per band)."""
    if resolve_backend(backend, band.device) == "plain":
        return block_cr_factor_plain(band, w, pivot=pivot, logdet=logdet)
    G, nb = _check_factor_band(band, w)
    dev = band.device
    _build.expect(band, "band", torch.float64, (G, nb * w, 2 * w + 1), dev)
    fac = torch.empty((G, cr_factor_size(nb, w)), dtype=torch.float64,
                      device=dev)
    ld = torch.empty((G,), dtype=torch.float64, device=dev) if logdet else None
    lib = _build.load_library()
    name = "cr_factor" if w <= MAX_W else "cr_factor_wide"
    err = getattr(lib, f"repro_{name}_f64")(
        band.data_ptr(), fac.data_ptr(),
        None if ld is None else ld.data_ptr(), G, nb * w, w, int(pivot),
        _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(name)
    return (fac, ld) if logdet else fac


def block_cr_apply_cols(G: int, B: int) -> int:
    """Columns per (band, column chunk) item of an apply launch that leaves
    ``cols`` open: the narrowest power of two whose items fit on the card's
    SMs, one each (``csrc/block_cr.cu`` apply_cols)."""
    cols = _build.load_library().repro_cr_apply_cols(G, B)
    if cols < 0:
        _build.check(-cols, "cr_apply column query")
    return cols


def block_cr_apply(factor, rhs, w: int, pivot: bool = False,
                   backend: str | None = None, cols: int | None = None):
    """Solve from a factor (G, cr_factor_size(nb, w)) of
    :func:`block_cr_factor` against rhs (G, nb w, B), float64; returns x.
    CUDA tensors launch ``csrc/block_cr.cu``'s apply kernel on a copy of
    rhs, in items of ``cols`` columns (None: :func:`block_cr_apply_cols`);
    the result does not depend on ``cols``."""
    if resolve_backend(backend, rhs.device) == "plain":
        return block_cr_apply_plain(factor, rhs, w, pivot=pivot)
    if not 1 <= w <= MAX_WIDE_W:
        raise ValueError(f"the block-CR apply takes 1 <= w <= {MAX_WIDE_W}")
    G, npad, B = rhs.shape
    if npad % w:
        raise ValueError(f"the block-CR apply takes n a multiple of w: "
                         f"n={npad}, w={w}")
    if cols is not None and cols < 1:
        raise ValueError(f"cols must be >= 1, got {cols}")
    dev = rhs.device
    _build.expect(factor, "factor", torch.float64,
                  (G, cr_factor_size(npad // w, w)), dev)
    _build.expect(rhs, "rhs", torch.float64, (G, npad, B), dev)
    x = rhs.clone()
    lib = _build.load_library()
    name = "cr_apply" if w <= MAX_W else "cr_apply_wide"
    err = getattr(lib, f"repro_{name}_f64")(
        factor.data_ptr(), x.data_ptr(), G, npad, w, B, cols or 0,
        int(pivot), _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(name)
    return x
