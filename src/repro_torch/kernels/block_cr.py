"""Block cyclic-reduction banded solve: the plain version of the elimination.

Counterpart of ``repro.kernels.block_cr.cr_solve_values``. A band with
``lo = hi = w`` is viewed as block-tridiagonal with ``w x w`` blocks

    A_i x_{i-1} + B_i x_i + C_i x_{i+1} = r_i,      i = 0..nb-1,

and eliminated by even/odd cyclic reduction: at level ``k`` (stride
``s = 2^k``) every surviving even row folds its two odd neighbours into
itself; back substitution replays the levels in reverse. Eliminated rows
are frozen in place, so ``log|det| = sum_i log|det B_i|``.

On the card this elimination is a device function (``csrc/cr.cuh``) inside
the whole-solve kernel (``csrc/mega_pcg.cu``). The standalone launch
(``block_cr_pallas`` in the reference) is not ported yet: a standalone
solve on CUDA tensors raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .ops import resolve_backend

__all__ = ["cr_solve_values", "block_cr_solve", "block_cr_logdet"]


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


def _small_solve(M, R):
    """Unpivoted Gaussian elimination of (..., w, w) against (..., w, m).

    Returns (X, log|det M| per block). A zero pivot is replaced by 1, as in
    the reference's ``_small_solve``.
    """
    w = M.shape[-1]
    A = torch.cat([M, R], dim=-1)
    ld = M.new_zeros(M.shape[:-2])
    rows = torch.arange(w, device=M.device)
    for t in range(w):
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
                    solve: bool = True):
    """Block cyclic reduction on (G, nb*w, 2w+1) bands and (G, nb*w, B)
    right-hand sides (identity-padded past the real rows).

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
        Binv, _ = _small_solve(Bb, eye)
        alpha = -_bmm(Ab, _nbr(Binv, -s))
        beta = -_bmm(Cb, _nbr(Binv, s))
        m = even[None, :, None, None]
        Bb = torch.where(m, Bb + _bmm(alpha, _nbr(Cb, -s))
                         + _bmm(beta, _nbr(Ab, s)), Bb)
        R = torch.where(m, R + _bmm(alpha, _nbr(R, -s))
                        + _bmm(beta, _nbr(R, s)), R)
        Ab = torch.where(m, _bmm(alpha, _nbr(Ab, -s)), Ab)
        Cb = torch.where(m, _bmm(beta, _nbr(Cb, s)), Cb)
    X0, ld_all = _small_solve(Bb, R)
    ld = ld_all.sum(dim=1)
    if not solve:
        return rhs.new_zeros((G, nb * w, B)), ld
    x = torch.where(idx[None, :, None, None] == 0, X0, torch.zeros_like(X0))
    for k in range(steps - 1, -1, -1):
        s = 1 << k
        odd = ((idx % s) == 0) & (((idx // s) % 2) == 1)
        rhs_k = R - _bmm(Ab, _nbr(x, -s)) - _bmm(Cb, _nbr(x, s))
        Xk, _ = _small_solve(Bb, rhs_k)
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


def _standalone(band, backend):
    if resolve_backend(backend, band.device) != "plain":
        raise NotImplementedError(
            "standalone block-CR solve/logdet on CUDA is not ported yet "
            "(ROADMAP Queue 2, kernel #5 block_cr_pallas); q >= 1 needs it")


def block_cr_solve(band, rhs, w: int, backend: str | None = None):
    """Solve with a (G, n, 2w+1) band, rhs (G, n, B); plain version only."""
    _standalone(band, backend)
    n = band.shape[1]
    band_p, rhs_p, nb, steps = _padded(band, rhs, w)
    x, _ = cr_solve_values(band_p, rhs_p, w=w, nb=nb, steps=steps)
    return x[:, :n]


def block_cr_logdet(band, w: int, backend: str | None = None):
    """log|det| of a (G, n, 2w+1) band; plain version only."""
    _standalone(band, backend)
    dummy = band.new_zeros(band.shape[:2] + (1,))
    band_p, rhs_p, nb, steps = _padded(band, dummy, w)
    _, ld = cr_solve_values(band_p, rhs_p, w=w, nb=nb, steps=steps,
                            solve=False)
    return ld
