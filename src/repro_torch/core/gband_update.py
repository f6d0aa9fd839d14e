"""Windowed maintenance of the cached variance band ``Gband = (A Phi^T)^{-1}``.

Counterpart of ``repro.core.gband_update``. A streaming insert or evict
(``repro_torch.streaming.updates``) changes ``H = A Phi^T`` only inside an
O(q) window of rows around the sorted position ``p``; every other row of
the new factors is a shifted copy of the old ones. So the cached band of
``G = H^{-1}`` is updated by a splice (a gather of band data) plus a
low-rank window term, exactly, by a Woodbury identity whose solves are
banded:

  * **Insert at p.** Moving the first pad slot of the canonical padded
    ``H_old`` to ``p`` is a symmetric permutation ``H_s = P H_old P^T``,
    banded at half-width ``h + 1`` (entries straddling ``p`` move one offset
    outward). ``H_new = H_s + E M F^T`` with ``M`` the window block of
    ``H_new - H_s`` (rows within ``R = window_radius(q)`` of ``p``, columns
    within ``R + h + 1``), and
    ``G_new = G_s - G_s E (I + M F^T G_s E)^{-1} M F^T G_s``; the stored band
    of ``G_s = P G_old P^T`` is a gather of the old ``Gband``.
  * **Evict at p.** Splice an identity slot at ``p`` into ``H_new`` to get
    ``H_s'``; then ``H_old = H_s' + E M F^T`` and
    ``G_s' = G_old + G_old E (I - M F^T G_old E)^{-1} M F^T G_old`` solves
    against the cached pre-mutation ``Hband``. Deleting row and column
    ``p`` shifts 2h entries at offsets +-(h + 1) into the band; they lie in
    the solve windows, where the Woodbury gives dense rows and columns.

The two window solves (``X = H^{-1} E``, ``Y^T = F^T H^{-1}``) run on a
principal patch of ``patch_size(q, C)`` rows around ``p``, as one stacked
pivoted block-CR solve (``core.banded.solve(..., pivot=True)``, route
"cr": the plain version on the CPU, ``csrc/block_cr.cu`` on the card; the
reference's jax-backend ``kernels.cr_jax`` needs no twin). The truncation
drops terms that decay like ``exp(-omega * gap)`` per row away from ``p``:
with ``TRUNC_MARGIN`` rows of slack the update agrees with the full
recompute to roundoff on quasi-uniform data and is exact whenever the
patch covers the capacity. :func:`_drift_estimate` measures, per mutation,
how far the correction has failed to decay at the patch edge; the health
sentinel (``health.verdict.DRIFT_TOL``) resyncs the band exactly when it
accumulates. The small ``(r, r)`` Woodbury system is a dense solve
(``torch.linalg.solve_ex``, no host sync).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..masking import canonical_band
from .banded import Banded, band_band_matmul, mask_band, solve, transpose

__all__ = ["gband_insert", "gband_evict", "window_radius", "patch_size",
           "TRUNC_MARGIN"]

# Patch rows kept on each side beyond the perturbation window (the
# reference's margin: ~1e-16 relative dropped mass at omega * gap >= 0.32)
TRUNC_MARGIN = 112

# Patch-edge rows sampled by the truncation-drift estimator
DRIFT_EDGE = 8


def window_radius(q: int) -> int:
    """Rows of ``H`` an insert/evict can change around ``p``: the factor
    rebuild window 2q + 4, plus H's half-width 2q + 1, plus one row for the
    tie-separation bump."""
    return 4 * q + 6


def patch_size(q: int, C: int) -> int:
    """Static patch length of the truncated window solves (at most C)."""
    L = window_radius(q) + (2 * q + 2) + TRUNC_MARGIN
    return min(C, 2 * L + 1)


def _window(p, R: int, C: int):
    """Clipped index window ``p - R .. p + R`` per dim: (idx, valid);
    ``valid`` masks the duplicates that clipping makes."""
    u = p[:, None] - R + torch.arange(2 * R + 1, device=p.device)
    valid = (u >= 0) & (u < C)
    return u.clamp(0, C - 1), valid


def _splice_band(data, h: int, p, hout: int | None = None):
    """Band data (half-width ``hout >= h``) of ``P M P^T``, ``P`` inserting
    a decoupled slot at ``p`` into the canonical padded band ``data``
    (D, C, 2h+1). Rows and columns past ``p`` shift down by one; entries
    straddling ``p`` move one offset outward (``hout = h + 1`` keeps them;
    the G splices read only the stored +-h band, whose sources stay in
    band). Row and column ``p`` become the identity slot."""
    hout = h if hout is None else hout
    D, C, W = data.shape
    dev = data.device
    i = torch.arange(C, device=dev)[None, :, None]
    m = torch.arange(-hout, hout + 1, device=dev)[None, None, :]
    j = i + m
    pp = p[:, None, None]
    src_i = (i - (i > pp).long()).clamp(0, C - 1)  # (D, C, 1)
    src_m = j - (j > pp).long() - src_i  # m or m -+ 1
    d = torch.arange(D, device=dev)[:, None, None]
    zero = torch.zeros((), dtype=data.dtype, device=dev)
    val = data[d, src_i, (h + src_m).clamp(0, W - 1)]
    val = torch.where((src_m >= -h) & (src_m <= h), val, zero)
    ident = ((i == pp) & (m == 0)).to(data.dtype)
    val = torch.where((i == pp) | (j == pp), ident, val)
    return torch.where((j >= 0) & (j < C), val, zero)


def _widen(data, dh: int):
    """Pad band data (D, C, W) with ``dh`` zero offsets on each side."""
    return F.pad(data, (dh, dh))


def _onehot_cols(idx, valid, C: int, dtype):
    """(D, r) window indices -> (D, C, r) one-hot columns, invalid ones 0."""
    D, r = idx.shape
    out = torch.zeros((D, C, r), dtype=dtype, device=idx.device)
    d = torch.arange(D, device=idx.device)[:, None].expand(D, r)
    t = torch.arange(r, device=idx.device)[None, :].expand(D, r)
    out[d, idx, t] = valid.to(dtype)
    return out


def _window_block(delta, h: int, wr, vr, wc, vc):
    """M = delta[window rows, window cols], duplicates and invalid masked."""
    W = delta.shape[-1]
    off = wc[:, None, :] - wr[:, :, None]  # (D, r, c)
    d = torch.arange(delta.shape[0], device=delta.device)[:, None, None]
    vals = delta[d, wr[:, :, None], (h + off).clamp(0, W - 1)]
    keep = (off >= -h) & (off <= h) & vr[:, :, None] & vc[:, None, :]
    return torch.where(keep, vals, torch.zeros((), dtype=delta.dtype,
                                               device=delta.device))


def _low_rank_band(X, V, h: int):
    """Band (|offset| <= h) of ``X @ V``: out[d, i, m] = sum_t X[d, i, t]
    V[d, t, i + m], one gathered (D, P, 2h+1) term a window column."""
    P, r = X.shape[1], X.shape[2]
    dev = X.device
    j = (torch.arange(P, device=dev)[:, None]
         + torch.arange(-h, h + 1, device=dev)[None, :])
    jc = j.clamp(0, P - 1)
    out = X[:, :, 0, None] * V[:, 0][:, jc]
    for t in range(1, r):
        out = out + X[:, :, t, None] * V[:, t][:, jc]
    return torch.where((j >= 0) & (j < P), out,
                       torch.zeros((), dtype=X.dtype, device=dev))


def _new_hband(A: Banded, Phi: Banded, k_new, backend: str | None):
    """Canonical band data of the post-mutation ``H = A Phi^T``: one band
    product; the rows outside the rebuild window are products of unchanged
    factor rows, so they reproduce the spliced old band bit for bit."""
    H = mask_band(band_band_matmul(A, transpose(Phi), backend=backend))
    return canonical_band(H.data, H.lo, H.hi, k_new)


def _gather_patch(data, ps, P: int, h: int):
    """Principal submatrix rows ``ps .. ps + P - 1`` of a (D, C, 2h+1) band;
    entries whose column leaves the patch are dropped (the truncation)."""
    D = data.shape[0]
    dev = data.device
    i = torch.arange(P, device=dev)
    rows = ps[:, None] + i[None, :]
    patch = data[torch.arange(D, device=dev)[:, None], rows]
    jl = i[:, None] + torch.arange(-h, h + 1, device=dev)[None, :]
    return torch.where((jl >= 0) & (jl < P), patch,
                       torch.zeros((), dtype=data.dtype, device=dev))


def _solve_windows(Hdata, hs: int, E, F_, backend: str | None,
                   alg: str | None):
    """Patch columns ``X = H^{-1} E`` and rows ``Y^T = (H^{-T} F)^T``: the H
    and H^T systems as ONE stacked pivoted solve (a leading batch of 2),
    right-hand sides zero-padded to a common column count. ``alg`` is the
    GP's solve alg, as in the reference: "auto" resolves to block CR on
    these symmetric bands, "lu" to the pivoted banded LU."""
    r, c = E.shape[-1], F_.shape[-1]
    w = max(r, c)
    Hpair = torch.stack([Hdata, transpose(Banded(Hdata, hs, hs)).data])
    rhs = torch.stack([F.pad(E, (0, w - r)), F.pad(F_, (0, w - c))])
    out = solve(Banded(Hpair, hs, hs), rhs, pivot=True, backend=backend,
                alg=alg)
    return out[0][..., :r], out[1][..., :c].transpose(1, 2)


def _woodbury(Hsolve, hs: int, delta, hd: int, p, q: int, sign: float,
              backend: str | None, alg: str | None):
    """Shared window Woodbury: ``X``, ``V`` with correction ``sign * X V``.

    ``(H + E M F^T)^{-1} = H^{-1} - X (I + M F^T X)^{-1} M Y^T``,
    ``X = H^{-1} E``, ``Y^T = F^T H^{-1}``; ``sign = -1`` is the insert
    direction, ``+1`` the evict direction. ``Hsolve`` has half-width ``hs``,
    ``delta`` half-width ``hd``. ``X``, ``Yt``, ``V`` are patch-indexed and
    ``ps`` (D,) maps them back to global rows."""
    C = Hsolve.shape[1]
    R = window_radius(q)
    P = patch_size(q, C)
    ps = (p - (P - 1) // 2).clamp(0, C - P)
    wr, vr = _window(p, R, C)
    wc, vc = _window(p, R + hd, C)
    M = _window_block(delta, hd, wr, vr, wc, vc)  # (D, r, c)
    Hp = _gather_patch(Hsolve, ps, P, hs)
    E = _onehot_cols(wr - ps[:, None], vr, P, Hsolve.dtype)
    Fc = _onehot_cols(wc - ps[:, None], vc, P, Hsolve.dtype)
    X, Yt = _solve_windows(Hp, hs, E, Fc, backend, alg)
    r = M.shape[1]
    X_wc = torch.gather(X, 1, (wc - ps[:, None])[:, :, None].expand(-1, -1,
                                                                    r))
    eye = torch.eye(r, dtype=Hsolve.dtype, device=Hsolve.device)
    S = eye - sign * (M @ X_wc)  # (D, r, r); invalid rows stay e_t
    V = torch.linalg.solve_ex(S, M @ Yt)[0]  # (D, r, P)
    return X, V, Yt, ps


def _drift_estimate(corr, ps, k_new, gscale):
    """The correction's magnitude on the outermost ``DRIFT_EDGE`` patch rows
    relative to ``min(its peak, gscale)``, per dimension (D,), counted on a
    side only where the patch truncates there: exactly zero when the patch
    covers the active system. A correction that has not decayed by the
    patch edge means the no-decay regime where the truncation fails."""
    P = corr.shape[1]
    e = min(DRIFT_EDGE, P)
    absc = corr.abs()
    left = absc[:, :e].amax(dim=(1, 2))
    right = absc[:, P - e:].amax(dim=(1, 2))
    zero = torch.zeros((), dtype=corr.dtype, device=corr.device)
    edge = torch.maximum(torch.where(ps > 0, left, zero),
                         torch.where(ps + P < k_new, right, zero))
    peak = absc.amax(dim=(1, 2))
    scale = torch.clamp(torch.minimum(peak, gscale),
                        min=torch.finfo(corr.dtype).tiny)
    return edge / scale


def _add_patch_band(Gdata, corr, ps):
    """Add the patch-local band correction into the full band."""
    D, P = corr.shape[0], corr.shape[1]
    dev = Gdata.device
    d = torch.arange(D, device=dev)[:, None]
    rows = ps[:, None] + torch.arange(P, device=dev)[None, :]
    out = Gdata.clone()
    out[d, rows] = Gdata[d, rows] + corr
    return out


def _per_tenant_max(x, tenants: int | None):
    """max over all of ``x``, or (``tenants``) over each tenant's
    dimensions (leading axis T D): (T,)."""
    if tenants is None:
        return x.amax()
    return x.reshape(tenants, -1).amax(-1)


def gband_insert(Hband_old: Banded, A: Banded, Phi: Banded,
                 Gband_old: Banded, p, k_new, q: int, *,
                 backend: str | None = None, alg: str | None = None,
                 tenants: int | None = None):
    """Windowed ``(Gband, Hband, drift)`` after inserting at sorted
    positions ``p`` (D,): ``Hband_old``/``Gband_old`` the cached pre-insert
    canonical bands (D, C, 2h+1), ``A``/``Phi`` the post-insert factors,
    ``k_new`` the new active count (0-d tensor). ``drift`` is this
    mutation's :func:`_drift_estimate`, the largest over the dimensions.
    ``alg`` is the GP's solve alg, which routes the patch solve. A fleet
    passes its tenants' dimensions flattened (T D leading rows,
    ``k_new`` and the bands' counts per dimension) and ``tenants`` = T:
    the scales and the drift are then per tenant, drift (T,)."""
    h = A.lo + Phi.lo  # 2q + 1
    Hs = _splice_band(Hband_old.canonical().data, h, p, hout=h + 1)
    Hnew = _new_hband(A, Phi, k_new, backend)
    delta = _widen(Hnew, 1) - Hs
    X, V, _, ps = _woodbury(Hs, h + 1, delta, h + 1, p, q, -1.0, backend,
                            alg)
    Gs = _splice_band(Gband_old.canonical().data, h, p)
    corr = _low_rank_band(X, V, h)
    drift = _per_tenant_max(_drift_estimate(
        corr, ps, k_new, _per_dim_scale(Gs, tenants)), tenants)
    Gnew = canonical_band(_add_patch_band(Gs, -corr, ps), h, h, k_new)
    return Banded(Gnew, h, h, k_new), Banded(Hnew, h, h, k_new), drift


def _per_dim_scale(G, tenants: int | None):
    """The band's largest magnitude: over all of it, or per tenant and
    repeated over its dimensions (T D,)."""
    if tenants is None:
        return G.abs().amax()
    return _per_tenant_max(G.abs(), tenants).repeat_interleave(
        G.shape[0] // tenants)


def gband_evict(Hband_old: Banded, A: Banded, Phi: Banded,
                Gband_old: Banded, p, k_new, q: int, *,
                backend: str | None = None, alg: str | None = None,
                tenants: int | None = None):
    """Windowed ``(Gband, Hband, drift)`` after evicting sorted positions
    ``p`` (D,); arguments as :func:`gband_insert` (``A``/``Phi`` the
    post-evict factors), the solves against the cached ``Hband_old``."""
    h = A.lo + Phi.lo
    D, C, W = Hband_old.data.shape
    dev = Hband_old.data.device
    Hold = Hband_old.canonical().data
    Hnew = _new_hband(A, Phi, k_new, backend)
    Hs = _splice_band(Hnew, h, p, hout=h + 1)
    delta = _widen(Hold, 1) - Hs
    X, V, Yt, pstart = _woodbury(Hold, h, delta, h + 1, p, q, 1.0, backend,
                                 alg)
    Gold = Gband_old.canonical().data
    corr = _low_rank_band(X, V, h)
    drift = _per_tenant_max(_drift_estimate(
        corr, pstart, k_new, _per_dim_scale(Gold, tenants)), tenants)
    Gs = _add_patch_band(Gold, corr, pstart)

    # the 2h entries at offsets +-(h+1) that deleting row/column p shifts
    # into the band: rows p-h..p-1 of G_s' are Yt rows + correction, columns
    # p-h..p-1 X columns + correction (window slots R+1+s of the radius
    # R+h+1 column window and R-h+s of the radius-R row window)
    R = window_radius(q)
    P = X.shape[1]
    d = torch.arange(D, device=dev)[:, None]
    s = torch.arange(h, device=dev)[None, :]

    def _loc(idx):
        return (idx - pstart[:, None]).clamp(0, P - 1)

    def _dense_entries(base, rows, cols):
        out = base
        for t in range(V.shape[1]):
            out = out + X[d, _loc(rows), t] * V[d, t, _loc(cols)]
        return out

    pc = p[:, None]
    rows_up = (pc - h + s).clamp(0, C - 1)
    cols_up = (pc + 1 + s).clamp(0, C - 1)
    upper = _dense_entries(Yt[d, R + 1 + s, _loc(cols_up)], rows_up, cols_up)
    rows_lo = (pc + 1 + s).clamp(0, C - 1)
    cols_lo = (pc - h + s).clamp(0, C - 1)
    lower = _dense_entries(X[d, _loc(rows_lo), R - h + s], rows_lo, cols_lo)

    # delete row/column p: rows/cols past p shift up, straddling entries
    # move one offset outward (the +-(h+1) cases read upper/lower)
    i = torch.arange(C, device=dev)[None, :, None]
    m = torch.arange(-h, h + 1, device=dev)[None, None, :]
    j = i + m
    pp = p[:, None, None]
    src_i = (i + (i >= pp).long()).clamp(0, C - 1)
    src_m = j + (j >= pp).long() - src_i
    dd = torch.arange(D, device=dev)[:, None, None]
    val = Gs[dd, src_i, (h + src_m).clamp(0, W - 1)]
    up_case = (m == h) & (i < pp) & (j >= pp)
    lo_case = (m == -h) & (j < pp) & (i >= pp)
    off = i[..., 0].expand(D, C) - pc
    up_vals = torch.gather(upper, 1, (off + h).clamp(0, h - 1))[:, :, None]
    lo_vals = torch.gather(lower, 1, off.clamp(0, h - 1))[:, :, None]
    val = torch.where(up_case, up_vals, val)
    val = torch.where(lo_case, lo_vals, val)
    val = torch.where((j >= 0) & (j < C), val,
                      torch.zeros((), dtype=val.dtype, device=dev))
    Gnew = canonical_band(val, h, h, k_new)
    return Banded(Gnew, h, h, k_new), Banded(Hnew, h, h, k_new), drift
