"""Coarse levels of the kernel-multigrid (KMG) preconditioner.

Counterpart of ``repro.precond.coarse`` (Kernel Multigrid, arXiv
2403.13300). Each coarse level is
a sparse-GP view of the fine additive system: a strided subset of the
original points is the inducing set, and its prior is the smaller banded KP
system that ``core.kernel_packets.kp_factors`` builds at the subsampled
coordinates. A :class:`CoarseLevel` carries

  * the coarse ``DimOps``: KP factors ``(A_c, Phi_c)`` and the smoother
    band ``SAPhi = sigma_b^2 A_c + Phi_c`` with ``sigma_b^2 = 3 sigma^2 /
    (2 c)`` (each stride-c point stands in for ~c fine observations);
  * the prolongation in window form, order-(2q+1) Lagrange interpolation
    from coarse to fine sorted coordinates: window starts ``j0 (D, n)`` and
    weights ``W (D, n, npts)``;
  * the restriction map, the transpose of those windows built once here:
    for each coarse sorted row its (fine sorted row, weight) pairs in the
    order the reference's scatter-add visits them (window slot a = 0..npts-1
    outer, fine rows ascending), padded with zero weights to the largest
    count, so ``vcycle.restrict`` is a fixed sequence of gathers and adds:
    no atomics, the same bits on every run;
  * ``EG``, the SPD-safe inverse Gram of the rank-D per-dimension-constant
    deflation basis under the mixed coarse operator.

Capacity padding: on a padded fine system (``fine_ops.n_active``) a level
has the static size ``nc = coarse_capacity(capacity, stride)`` and the
active count ``nc_active = ceil(n_active / stride)`` (a 0-d tensor): the
strided subset of an active prefix is again a prefix. Its tail coordinates
are filled strictly increasing above the active ones, so its sort is the
canonical layout, its factors are canonical bands, and the prolongation
weights of fine tail rows are zero.

Tenant stacks (a fleet, ``core.fleet``): every input may carry a leading T
axis (X (T, n, D), ``n_active`` (T,)), and the levels are built once for
the whole stack, every tensor of a level with that axis and ``nc_active``
(T,). The restriction maps share one width K, the largest over every
tenant and dimension (one host read a level for the fleet); a lane's
extra slots are zero-weight terms after its own (:func:`pad_restriction`),
which leave its restriction's bits as they are.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import matern as mk
from ..core.backfitting import DimOps
from ..core.banded import Banded, add, scale
from ..core.kernel_packets import gram_band_rows, kp_coefficient_rows, kp_factors
from ..masking import lead_count, mask_rows, tree_sum

__all__ = ["CoarseLevel", "build_hierarchy", "coarse_capacity",
           "interp_order", "pad_restriction", "tenant_mm"]

# span-relative tie separation of coarse sorted coordinates (the fit's)
_TIE_EPS = 1e-9


def interp_order(q: int) -> int:
    """Prolongation polynomial order 2q+1 (the Matérn-(q+1/2) smoothness)."""
    return 2 * q + 1


def coarse_capacity(capacity: int, stride: int) -> int:
    """Coarse size of a strided subset: ceil(capacity / stride)."""
    return -(-capacity // stride)


@dataclasses.dataclass(frozen=True)
class CoarseLevel:
    """One level of the KMG hierarchy (see the module docstring).

    ops:    coarse DimOps (KP factors, smoother band, permutations).
    j0:     (D, n) window starts into coarse sorted order.
    W:      (D, n, npts) Lagrange prolongation weights.
    EG:     (D, D) SPD-safe inverse Gram of the deflation basis.
    r_idx:  (D, nc, K) fine sorted rows of each coarse row's restriction.
    r_w:    (D, nc, K) their weights (0 in the padding).
    stride: subsampling stride relative to the fine level.
    npts:   interpolation window size (interp_order(q) + 1).

    On a tenant stack each tensor has a leading T axis.
    """

    ops: DimOps
    j0: torch.Tensor
    W: torch.Tensor
    EG: torch.Tensor
    r_idx: torch.Tensor
    r_w: torch.Tensor
    stride: int
    npts: int

    @property
    def nc(self) -> int:
        return self.ops.n


def pad_restriction(level: CoarseLevel, K: int) -> CoarseLevel:
    """``level`` with its restriction map widened to ``K`` slots: the new
    slots (row 0, weight 0) come after every row's own, so
    ``vcycle.restrict`` adds ``+ 0 * g`` after the row's terms and its
    values keep their bits (a sum started at +0 never holds -0)."""
    pad = K - level.r_idx.shape[-1]
    if pad <= 0:
        return level
    return dataclasses.replace(
        level, r_idx=torch.cat([level.r_idx, level.r_idx.new_zeros(
            level.r_idx.shape[:-1] + (pad,))], dim=-1),
        r_w=torch.cat([level.r_w, level.r_w.new_zeros(
            level.r_w.shape[:-1] + (pad,))], dim=-1))


def tenant_mm(a, b):
    """``a @ b`` over a tenant stack's leading axis. On CUDA one batched
    matmul; on the CPU tenant by tenant, since a batched CPU matmul rounds
    otherwise than the 2-D one, and so each lane keeps its standalone GP's
    bits there. One system is the 2-D product."""
    if a.ndim == 2 or a.is_cuda:
        return a @ b
    return torch.stack([x @ y for x, y in zip(a, b)])


def _coarse_sorted(Xc_t, nc_active=None):
    """Per-dim stable sort of the coarse subset's coordinates (..., D, nc),
    with the fit's span-relative bump on exact ties. Under capacity padding
    the slots ``>= nc_active`` (which may hold anything) are first
    overwritten by a strictly increasing sequence above every active value,
    so the sort puts the active coordinates first and keeps an identity
    tail."""
    if nc_active is None:
        hi = Xc_t.amax(dim=-1, keepdim=True)
        lo = Xc_t.amin(dim=-1, keepdim=True)
    else:
        nca = lead_count(nc_active, Xc_t.ndim)
        j = torch.arange(Xc_t.shape[-1], device=Xc_t.device)
        act = j < nca
        inf = torch.full((), float("inf"), dtype=Xc_t.dtype,
                         device=Xc_t.device)
        hi = torch.where(act, Xc_t, -inf).amax(dim=-1, keepdim=True)
        lo = torch.where(act, Xc_t, inf).amin(dim=-1, keepdim=True)
    span = hi - lo + 1.0
    if nc_active is not None:
        fill = hi + span * (j - nca + 1).to(Xc_t.dtype)
        Xc_t = torch.where(act, Xc_t, fill)
    sort_idx = torch.argsort(Xc_t, dim=-1, stable=True)
    xs_c = torch.gather(Xc_t, -1, sort_idx)
    rank_idx = torch.argsort(sort_idx, dim=-1, stable=True)
    gaps = torch.diff(xs_c, dim=-1)
    bump = torch.cumsum(torch.where(gaps <= 0, span * _TIE_EPS,
                                    torch.zeros_like(gaps)), dim=-1)
    xs_c = torch.cat([xs_c[..., :1], xs_c[..., 1:] + bump], dim=-1)
    return xs_c, sort_idx, rank_idx


def _interp_maps(xs_f, xs_c, npts: int, nc_active=None, n_active=None):
    """Window starts (..., D, n) and Lagrange weights (..., D, n, npts),
    coarse sorted -> fine sorted; windows clamped inside
    [0, nc_active - npts]. Under capacity padding the weights of fine rows
    ``>= n_active`` are zero."""
    lead = tuple(xs_f.shape[:-2])
    D, n = xs_f.shape[-2:]
    nc = xs_c.shape[-1]
    dev = xs_f.device
    j = torch.searchsorted(xs_c.contiguous(), xs_f.contiguous(),
                           right=True) - 1
    j0 = j - (npts // 2 - 1)
    j0 = (j0.clamp(0, max(nc - npts, 0)) if nc_active is None else
          torch.minimum(j0.clamp(min=0),
                        (lead_count(nc_active, j0.ndim) - npts).clamp(min=0)))
    win = (j0[..., None] + torch.arange(npts, device=dev)).clamp(0, nc - 1)
    pts = torch.gather(xs_c, -1, win.reshape(lead + (D, -1))).reshape(
        lead + (D, n, npts))
    # W[i, a] = prod_{b != a} (xf_i - p_b) / (p_a - p_b)
    eye = torch.eye(npts, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=xs_f.dtype, device=dev)
    pd = pts[..., :, None] - pts[..., None, :]
    denom = torch.where(eye, one, pd).prod(dim=-1)
    xd = xs_f[..., None] - pts
    numer = torch.where(eye, one, xd[..., None, :]).prod(dim=-1)
    W = numer / denom
    if n_active is not None:
        W = torch.where(torch.arange(n, device=dev)[:, None]
                        < lead_count(n_active, W.ndim),
                        W, torch.zeros((), dtype=W.dtype, device=dev))
    return j0, W


def _restrict_map(j0, W, nc: int, n_active=None):
    """The transposed windows: for each coarse sorted row, its (fine sorted
    row, weight) pairs in the reference scatter-add's order (slot a outer,
    fine row i inner), padded with weight 0 to the largest count K. Under
    capacity padding the fine rows ``>= n_active`` (zero weights) are left
    out: they go to a sink row ``nc`` that is dropped, so a coarse row's
    pairs and K are the unpadded system's. K is read back to the host (one
    sync per level). A tenant stack's (T, D) windows are mapped as T D
    dimensions, K the largest over all of them."""
    lead = tuple(W.shape[:-3])
    D, n, npts = W.shape[-3:]
    G = D * int(torch.Size(lead).numel())
    j0, W = j0.reshape(G, n), W.reshape(G, n, npts)
    dev = W.device
    win = (j0[:, :, None] + torch.arange(npts, device=dev)).clamp(0, nc - 1)
    tgt = win.permute(0, 2, 1).reshape(G, npts * n)  # position a * n + i
    if n_active is not None:
        fine = torch.arange(n, device=dev).repeat(npts)
        na = (lead_count(n_active, len(lead) + 1).expand(lead + (D,))
              .reshape(G, 1) if lead else n_active)
        tgt = torch.where(fine < na, tgt, nc)
    order = torch.argsort(tgt, dim=1, stable=True)
    tgt_s = torch.gather(tgt, 1, order)
    counts = torch.zeros((G, nc + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, tgt, torch.ones_like(tgt))
    K = max(int(counts[:, :nc].max()), 1)
    start = torch.cumsum(counts, dim=1) - counts
    slot = (torch.arange(npts * n, device=dev)[None, :]
            - torch.gather(start, 1, tgt_s)).clamp(max=K - 1)
    src_i, src_a = order % n, order // n
    d_i = torch.arange(G, device=dev)[:, None].expand_as(order)
    r_idx = torch.zeros((G, nc + 1, K), dtype=torch.long, device=dev)
    r_w = torch.zeros((G, nc + 1, K), dtype=W.dtype, device=dev)
    r_idx[d_i, tgt_s, slot] = src_i
    r_w[d_i, tgt_s, slot] = W[d_i, src_i, src_a]
    shape = lead + (D, nc, K)
    return (r_idx[:, :nc].reshape(shape).contiguous(),
            r_w[:, :nc].reshape(shape).contiguous())


def _deflation_gram(level: CoarseLevel, fine_ops: DimOps):
    """SPD-safe inverse Gram of the per-dim-constant basis under M_c.

    Column k of ``E`` (D, nc, D) is the indicator of dimension k; its Gram
    ``E^T M_c E`` is the fixed-association row sum of ``M_c E``,
    symmetrized and eigenvalue-clamped to a positive floor, so the
    deflation stays a bounded SPD correction."""
    from .vcycle import coarse_matvec  # vcycle imports this module

    lead = level.ops.lead
    D, nc = level.ops.D, level.ops.n
    dt, dev = level.W.dtype, level.W.device
    E = mask_rows(torch.eye(D, dtype=dt, device=dev)[:, None, :].expand(
        lead + (D, nc, D)), level.ops.n_active, axis=-2)
    EME = tree_sum(coarse_matvec(level, fine_ops, E.contiguous()), axis=-2)
    EME = 0.5 * (EME + EME.mT)
    lam, V = torch.linalg.eigh(EME)
    floor = torch.clamp(lam[..., -1:], min=1.0) * 1e-8
    lam = torch.maximum(lam, floor)
    return tenant_mm(V / lam[..., None, :], V.mT)


def _padded_factors(q: int, omega, xs_c, nc_active):
    """Canonical KP factors (A, Phi) of the active prefix of a padded coarse
    level: the rows of ``kp_factors``, with validity bounded by
    ``nc_active`` (per tenant on a stack)."""
    rows = torch.arange(xs_c.shape[-1], device=xs_c.device)
    na = lead_count(nc_active, xs_c.ndim)
    a = kp_coefficient_rows(q, omega, xs_c, rows, n_active=na)
    om = omega[..., None, None, None]
    phi = gram_band_rows(lambda x, y: mk.matern(q, om, x, y), xs_c, a, rows,
                         q + 1, q + 1, q, n_active=na)
    return (Banded(a, q + 1, q + 1, nc_active).canonical(),
            Banded(phi, q, q, nc_active).canonical())


def _build_level(q: int, omega, sigma2, X, xs_f, fine_ops: DimOps,
                 stride: int) -> CoarseLevel:
    """One coarse level at ``stride`` (relative to the fine level)."""
    lead = tuple(X.shape[:-2])
    n, D = X.shape[-2:]
    nc = coarse_capacity(n, stride)
    na_f = fine_ops.n_active
    nc_active = None if na_f is None else (na_f + stride - 1) // stride
    # the strided original-index subset, shared across dimensions
    Ic = torch.arange(nc, device=X.device) * stride
    xs_c, sort_idx, rank_idx = _coarse_sorted(
        X[..., Ic, :].transpose(-1, -2).contiguous(), nc_active)
    if nc_active is None:
        A, Phi = kp_factors(q, omega, xs_c)
    else:
        A, Phi = _padded_factors(q, omega, xs_c, nc_active)
    sigma2_b = 3.0 * sigma2 / (2.0 * stride)
    SAPhi = add(scale(A, lead_count(sigma2_b, A.data.ndim)), Phi)
    ops_c = DimOps(A=A, Phi=Phi, SAPhi=SAPhi, sort_idx=sort_idx,
                   rank_idx=rank_idx, sigma2=sigma2_b, pivot=fine_ops.pivot,
                   alg=fine_ops.alg, n_active=nc_active)
    npts = interp_order(q) + 1
    j0, W = _interp_maps(xs_f, xs_c, npts, nc_active, na_f)
    r_idx, r_w = _restrict_map(j0, W, nc, na_f)
    level = CoarseLevel(ops=ops_c, j0=j0, W=W,
                        EG=torch.eye(D, dtype=W.dtype,
                                     device=W.device).expand(lead + (D, D)),
                        r_idx=r_idx, r_w=r_w, stride=stride, npts=npts)
    return dataclasses.replace(level, EG=_deflation_gram(level, fine_ops))


def build_hierarchy(q: int, omega, sigma2, X, xs_f, fine_ops: DimOps, *,
                    levels: int = 2, coarsen: int = 8):
    """The coarse hierarchy of a fitted fine system: level l subsamples the
    original points at stride ``coarsen**l`` and maps directly to the fine
    grid. ``levels`` counts the fine level (2 = one coarse grid); levels
    whose static size is smaller than one interpolation window are dropped.
    Any input may be capacity-padded (``fine_ops.n_active``), and carry a
    tenant stack's leading axis (the fleet's levels, built once)."""
    if levels < 2:
        return ()
    out = []
    npts = interp_order(q) + 1
    for lvl in range(1, levels):
        stride = coarsen ** lvl
        if coarse_capacity(X.shape[-2], stride) < max(npts, 2 * q + 4):
            break
        out.append(_build_level(q, omega, sigma2, X, xs_f, fine_ops,
                                stride))
    return tuple(out)
