"""KMG V-cycle: the coarse-grid-corrected PCG preconditioner of backfitting.

Counterpart of ``repro.precond.vcycle`` (arXiv 2403.13300), on the levels
of :mod:`coarse`:

  * ``prolong`` / ``restrict``: windowed Lagrange interpolation in
    per-dimension sorted order, and its exact adjoint. Restriction gathers
    through the level's transposed map and adds in a fixed order, so the
    preconditioner is one fixed linear operator on every device (no
    scatter atomics);
  * ``coarse_matvec``: the mixed coarse operator
    ``M_c u = Khat_c^{-1} u + sigma^{-2} R (S S^T) P u`` (banded prior, data
    term through the fine grid);
  * ``coarse_solve``: deflated damped block-Jacobi on ``M_c``;
  * ``kmg_preconditioner``: the symmetric multiplicative cycle
    ``z = aB r;  z += P M_c^{-1} R (r - M z)  [levels forward, then
    mirrored];  z += aB (r - M z)`` with B the fine block solve and
    ``a = damping`` (default 1/D).

The banded solves and matvecs go through ``kernels.ops`` (block CR, the LU
kernel at w = 0, the banded matvec): hand kernels on CUDA tensors. Every
function takes a tenant stack's leading axis (``core.fleet``): sums over the
dimensions, the sigma^2 divide and the deflation stay within a tenant.
"""
from __future__ import annotations

import torch

from ..core.backfitting import DimOps, mhat_matvec
from ..masking import mask_rows, tree_sum
from .coarse import CoarseLevel, tenant_mm

__all__ = ["prolong", "restrict", "coarse_matvec", "coarse_solve",
           "kmg_preconditioner"]


def _window_idx(level: CoarseLevel):
    """(..., D, n, npts) clipped window indices into coarse sorted order
    (the ones the restriction map was built from)."""
    idx = level.j0[..., None] + torch.arange(level.npts,
                                             device=level.j0.device)
    return idx.clamp(0, level.nc - 1)


def prolong(level: CoarseLevel, fine_ops: DimOps, u):
    """Interpolate coarse state (..., D, nc, B) to the fine grid
    (..., D, n, B)."""
    us = level.ops.to_sorted(u)
    lead = tuple(us.shape[:-3])
    D, _, B = us.shape[-3:]
    idx = _window_idx(level)
    n = idx.shape[-2]
    g = torch.gather(us, -2, idx.reshape(lead + (D, -1, 1)).expand(
        lead + (D, n * level.npts, B)))
    g = g.reshape(lead + (D, n, level.npts, B))
    vals = level.W[..., 0, None] * g[..., 0, :]
    for a in range(1, level.npts):
        vals = vals + level.W[..., a, None] * g[..., a, :]
    return fine_ops.from_sorted(vals)


def restrict(level: CoarseLevel, fine_ops: DimOps, r):
    """Adjoint of :func:`prolong`: fine (..., D, n, B) -> coarse
    (..., D, nc, B), each coarse row summing its fine rows' weighted values
    in the reference scatter-add's order (``CoarseLevel.r_idx``), then the
    zero-weight padding slots."""
    rs = fine_ops.to_sorted(r)
    lead = tuple(rs.shape[:-3])
    D, _, B = rs.shape[-3:]
    out = torch.zeros(lead + (D, level.nc, B), dtype=rs.dtype,
                      device=rs.device)
    for k in range(level.r_idx.shape[-1]):
        g = torch.gather(rs, -2, level.r_idx[..., k, None].expand(
            lead + (D, level.nc, B)))
        out = out + level.r_w[..., k, None] * g
    return level.ops.from_sorted(out)


def coarse_matvec(level: CoarseLevel, fine_ops: DimOps, u,
                  pivot: bool = False, backend: str | None = None,
                  alg: str | None = None):
    """``M_c u = Khat_c^{-1} u + sigma^{-2} R broadcast(sum_d (P u)_d)``."""
    k = len(level.ops.lead)
    Pu = prolong(level, fine_ops, u)
    s = tree_sum(Pu, axis=k).unsqueeze(k).expand(Pu.shape)
    prior = level.ops.khat_inv_mv(u, pivot=pivot, backend=backend, alg=alg)
    return prior + restrict(level, fine_ops, s) / fine_ops.s2(s)


def _deflation(level: CoarseLevel, r, shape):
    """E (E^T M_c E)^{-1} E^T r broadcast to ``shape``: ``level.EG``
    applied to the per-dimension sums of r, tail rows zero."""
    k = len(level.ops.lead)
    y = tenant_mm(level.EG, tree_sum(r, axis=k + 1))  # (..., D, B)
    return mask_rows(y[..., :, None, :].expand(shape), level.ops.n_active,
                     axis=k + 1)


def _deflate(level: CoarseLevel, fine_ops: DimOps, x, b, pivot=False,
             backend=None, alg=None):
    """x += E (E^T M_c E)^{-1} E^T (b - M_c x), with ``level.EG``."""
    r = b - coarse_matvec(level, fine_ops, x, pivot=pivot, backend=backend,
                          alg=alg)
    return x + _deflation(level, r, x.shape)


def coarse_solve(level: CoarseLevel, fine_ops: DimOps, b, *, smooth: int = 1,
                 pivot: bool = False, backend: str | None = None,
                 alg: str | None = None):
    """Approximate M_c^{-1} b: deflation around ``smooth`` damped
    block-Jacobi sweeps (each per-dimension band solved exactly, the
    cross-dimension coupling damped by 1/D)."""
    D = level.ops.D
    kw = dict(pivot=pivot, backend=backend, alg=alg)
    # entry deflation at x = 0: M_c 0 = 0 exactly, so it reads b directly
    x = _deflation(level, b, b.shape)
    for _ in range(smooth):
        r = b - coarse_matvec(level, fine_ops, x, **kw)
        x = x + level.ops.block_solve(r, **kw) / D
    return _deflate(level, fine_ops, x, b, **kw)


def kmg_preconditioner(ops: DimOps, hier, *, damping: float = 0.0,
                       smooth: int = 1, pivot: bool = False,
                       backend: str | None = None, alg: str | None = None):
    """The symmetric V-cycle ``pre(r) ~ Mhat^{-1} r`` over ``hier``: with
    one coarse level pre-smooth / coarse-correct / post-smooth; with more,
    the corrections sweep the levels forward, then mirrored back.
    ``damping <= 0`` selects 1/D. Linear and self-adjoint by construction,
    so plain PCG takes it."""
    alpha = damping if damping > 0 else 1.0 / ops.D
    levels = tuple(hier)
    seq = levels + levels[-2::-1]
    kw = dict(pivot=pivot, backend=backend, alg=alg)

    def amv(u):
        return mhat_matvec(ops, u, **kw)

    def bsolve(r):
        return ops.block_solve(r, **kw)

    def pre(r):
        z = alpha * bsolve(r)
        for lv in seq:
            rc = restrict(lv, ops, r - amv(z))
            zc = coarse_solve(lv, ops, rc, smooth=smooth, **kw)
            z = z + prolong(lv, ops, zc)
        return z + alpha * bsolve(r - amv(z))

    return pre
