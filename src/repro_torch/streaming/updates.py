"""Incremental posterior updates: the paper's Sec. 6 streaming formulas.

Counterpart of ``repro.streaming.updates``. A capacity-padded
:class:`AdditiveGP`
(``core.additive_gp.fit(..., capacity=)`` / ``with_capacity``) is mutated
at its fixed capacity, where it lives:

  * :func:`insert` adds one observation: its sorted position per dimension
    is a masked count on the device, the permutations update in closed
    form, the banded factors A, Phi, B, Psi are rebuilt only in the O(q)
    window of rows around the new point (every other row is a shifted copy,
    Thm 3 locality), and the posterior caches come from a warm-started
    backfitting solve (the pre-insert ``Mhat^{-1} S Y`` with the new slot
    seeded from its sorted neighbour), capped at ``iters``;
  * :func:`evict` drops the oldest observation (original index 0) with the
    mirrored windowed deletion and a warm re-solve;
  * the variance band follows by the windowed Woodbury update of
    ``core.gband_update`` (``GPConfig.gband="windowed"``, the default) or
    the full recompute (``"full"``); :func:`maybe_resync` /
    :func:`resync_gband` recompute it exactly when the drift sentinel asks.

The fleet's masked rounds (:func:`fleet_insert`, :func:`fleet_evict`,
:func:`fleet_resync`) run the same bodies over a ``GPFleet``'s stack: the
per-dimension splices and windows over its tenants' dimensions at once,
each at its tenant's count and sorted position, the warm solve as one
tenant-axis launch, then a per-lane select.

With ``count=`` (the host-known active count) a mutation reads nothing back
from the device; without it the capacity guard reads ``n_active`` and the
drift sentinel runs first (one fetch). A full or unpadded GP is first
re-homed one row larger.

:func:`refresh_local_cache` updates the dense acquisition cache of a full
GP after an insert: the new row and column copy the sorted neighbour's
(``mode="copy"``), and ``mode="window"`` recomputes the columns near the
insertion exactly with one narrow batch of solves.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import matern as mk
from ..core.additive_gp import (AdditiveGP, TIE_EPS, build_gp_hier,
                                mean_caches, with_capacity)
from ..core.backfitting import DimOps, solve_mhat
from ..core.band_inverse import variance_band
from ..core.banded import Banded, add, scale, solve, transpose
from ..core.bayesopt import LocalAcqCache
from ..core.fleet import select_tenants, tree_map
from ..core.gband_update import gband_evict, gband_insert
from ..core.kernel_packets import gram_band_rows, kp_coefficient_rows
from ..health import verdict as hv
from ..masking import canonical_band, lead_count, mask_rows

__all__ = ["insert", "evict", "with_capacity", "refresh_local_cache",
           "maybe_resync", "resync_gband", "fleet_insert", "fleet_evict",
           "fleet_resync"]


def _splice_vec(v, p, val):
    """(D, C) -> (D, C) with ``val`` (D,) inserted at positions ``p`` (D,)
    (the last slot drops)."""
    j = torch.arange(v.shape[1], device=v.device)
    src = (j - (j > p[:, None]).long()).clamp(0, v.shape[1] - 1)
    return torch.where(j == p[:, None], val[:, None], torch.gather(v, 1, src))


def _delete_vec(v, p):
    """(D, C) -> (D, C) with slot ``p`` (D,) removed (the last repeats)."""
    j = torch.arange(v.shape[1], device=v.device)
    src = (j + (j >= p[:, None]).long()).clamp(0, v.shape[1] - 1)
    return torch.gather(v, 1, src)


def _expand_rows(data, p):
    """(D, C, w): rows >= p shift down; row p is a placeholder copy (every
    row whose band pattern changes lies in the rebuild window)."""
    j = torch.arange(data.shape[1], device=data.device)
    src = (j - (j > p[:, None]).long()).clamp(0, data.shape[1] - 1)
    return torch.gather(data, 1, src[:, :, None].expand(data.shape))


def _delete_rows(data, p):
    """(D, C, w): row ``p`` removed, rows > p shift up."""
    j = torch.arange(data.shape[1], device=data.device)
    src = (j + (j >= p[:, None]).long()).clamp(0, data.shape[1] - 1)
    return torch.gather(data, 1, src[:, :, None].expand(data.shape))


def _rebuild_windows(q: int, omega, xs, a, phi, b, psi, p, hi, k1):
    """Rebuild the factor rows around sorted positions ``p`` (D,) of every
    dimension at the new active count ``k1``: rows within 2q + 4 of ``p``
    (A, Phi) and within 2q + 6 (B, Psi), clipped to ``[0, hi]``. ``a``,
    ``phi``, ``b``, ``psi`` are the shifted pre-mutation bands; the result
    is canonical."""
    D = xs.shape[0]
    dev = xs.device
    d = torch.arange(D, device=dev)[:, None]
    om = omega[:, None, None, None]

    # the counts against (D, r) rows: one, or a fleet's per dimension
    k1r = k1[..., None]

    def rows(r):
        idx = p[:, None] - r + torch.arange(2 * r + 1, device=dev)
        return torch.minimum(idx.clamp(min=0), hi[..., None])

    rows_a = rows(2 * q + 4)
    a_rows = kp_coefficient_rows(q, omega, xs, rows_a, n_active=k1r)
    a = a.clone()
    a[d, rows_a] = a_rows
    phi_rows = gram_band_rows(lambda x, y: mk.matern(q, om, x, y), xs,
                              a_rows, rows_a, q + 1, q + 1, q, n_active=k1r)
    phi = phi.clone()
    phi[d, rows_a] = phi_rows
    rows_b = rows(2 * q + 6)
    b_rows = kp_coefficient_rows(q + 1, omega, xs, rows_b, n_active=k1r)
    b = b.clone()
    b[d, rows_b] = b_rows
    psi_rows = gram_band_rows(lambda x, y: mk.matern_domega(q, om, x, y), xs,
                              b_rows, rows_b, q + 2, q + 2, q + 1,
                              n_active=k1r)
    psi = psi.clone()
    psi[d, rows_b] = psi_rows
    # canonical identity tails: the stored factors equal what a padded
    # fresh fit stores, bit for bit outside the rebuild windows
    return (canonical_band(a, q + 1, q + 1, k1),
            canonical_band(phi, q, q, k1),
            canonical_band(b, q + 2, q + 2, k1),
            canonical_band(psi, q + 1, q + 1, k1))


def _insert_dims(q: int, k, omega, xs, sort_idx, rank_idx, a, phi, b, psi,
                 x_val):
    """Every dimension's spliced order, permutations and band windows for
    an insert at the active count ``k`` (0-d tensor, or (D,) per dimension:
    a fleet's tenants' dimensions flattened); all tensors keep their
    capacity. ``x_val`` (D,) the new point."""
    C = xs.shape[1]
    dev = xs.device
    j = torch.arange(C, device=dev)
    kc = k[..., None]
    active = j < kc
    first = xs[:, :1]
    last = torch.gather(xs, 1, (kc - 1).long().expand(xs.shape[0], 1))
    span = (last - first + 1.0)[:, 0]
    # p = #active coords <= x: the capacity-safe searchsorted(side="right"),
    # matching fit's stable sort; an exact tie is separated like fit's
    # TIE_EPS bump, capped at half the gap to the right neighbour
    p = ((xs <= x_val[:, None]) & active).sum(dim=1)
    left = torch.gather(xs, 1, (p - 1).clamp(0, C - 1)[:, None])[:, 0]
    right = torch.gather(xs, 1, p.clamp(0, C - 1)[:, None])[:, 0]
    gap = torch.where(p < k, right - left,
                      torch.full((), float("inf"), dtype=xs.dtype,
                                 device=dev))
    bump = torch.minimum(span * TIE_EPS, 0.5 * gap)
    x_val = torch.where((p > 0) & (x_val <= left), left + bump, x_val)
    xs_new = _splice_vec(xs, p, x_val)
    # permutations in closed form, canonical identity tails past k + 1
    sort_new = _splice_vec(sort_idx, p, k.to(sort_idx.dtype).expand(
        sort_idx.shape[0]))
    sort_new = torch.where(j <= kc, sort_new, j.to(sort_idx.dtype))
    rank_new = torch.where(
        j < kc, rank_idx + (rank_idx >= p[:, None]).to(rank_idx.dtype),
        torch.where(j == kc, p[:, None].to(rank_idx.dtype),
                    j.to(rank_idx.dtype)))
    a, phi, b, psi = _rebuild_windows(
        q, omega, xs_new, _expand_rows(a, p), _expand_rows(phi, p),
        _expand_rows(b, p), _expand_rows(psi, p), p, k, k + 1)
    return xs_new, sort_new, rank_new, a, phi, b, psi, p


def _evict_dims(q: int, k, omega, xs, sort_idx, rank_idx, a, phi, b, psi,
                p):
    """Every dimension's windowed deletion at sorted positions ``p`` (D,)
    (the evicted point is original index 0, so every surviving original
    index decrements)."""
    C = xs.shape[1]
    j = torch.arange(C, device=xs.device)
    k1 = k - 1
    k1c = k1[..., None]
    xs_new = _delete_vec(xs, p)
    sort_new = torch.where(j < k1c, _delete_vec(sort_idx, p) - 1,
                           j.to(sort_idx.dtype))
    rank_shift = _delete_vec(rank_idx, torch.zeros_like(p))
    rank_new = torch.where(
        j < k1c, rank_shift - (rank_shift > p[:, None]).to(rank_idx.dtype),
        j.to(rank_idx.dtype))
    a, phi, b, psi = _rebuild_windows(
        q, omega, xs_new, _delete_rows(a, p), _delete_rows(phi, p),
        _delete_rows(b, p), _delete_rows(psi, p), p, (k1 - 1).clamp(min=0),
        k1)
    return xs_new, sort_new, rank_new, a, phi, b, psi


def _dims(u, lead: tuple):
    """(T, D, ...) -> (T D, ...): a fleet's tenants' dimensions as one
    axis of the per-dimension helpers (the identity for one GP)."""
    return u.reshape((-1,) + u.shape[len(lead) + 1:]) if lead else u


def _dim_counts(k, lead: tuple, D: int):
    """A count per dimension of :func:`_dims`: the 0-d count of one GP, or
    each tenant's count repeated over its D dimensions."""
    return k.repeat_interleave(D) if lead else k


def _flat_band(b: Banded, lead: tuple) -> Banded:
    """A stacked band with the tenant and dimension axes as one, its counts
    per dimension."""
    if not lead:
        return b
    return Banded(_dims(b.data, lead), b.lo, b.hi,
                  _dim_counts(b.n_active, lead, b.data.shape[-3]))


def _mutated_gband(gp: AdditiveGP, ops: DimOps, p, k1, evicting: bool):
    """Post-mutation ``(Gband, Hband, drift)``: the windowed Woodbury update
    with ``gband="windowed"`` and a cached ``Hband``, else the full
    recompute (``drift`` exactly zero). On a fleet ``p`` is per flattened
    dimension and ``drift`` (T,)."""
    config = gp.config
    lead = gp.lead
    if config.gband != "full" and gp.Hband is not None:
        fn = gband_evict if evicting else gband_insert
        G, H, drift = fn(*(_flat_band(b, lead) for b in (
            gp.Hband, ops.A, ops.Phi, gp.Gband)), p,
            _dim_counts(k1, lead, gp.D), config.q, backend=config.backend,
            alg=config.solve_alg, tenants=lead[0] if lead else None)
        if lead:
            G, H = (Banded(b.data.reshape(lead + (gp.D,) + b.data.shape[-2:]),
                           b.lo, b.hi, k1) for b in (G, H))
        return G, H, drift
    Gband, Hband = variance_band(ops.A, ops.Phi, backend=config.backend,
                                 return_h=True)
    return Gband, Hband, torch.zeros(lead, dtype=Gband.data.dtype,
                                     device=Gband.data.device)


def _mutated_health(gp: AdditiveGP, info, drift):
    """Post-mutation ``HealthState``: this mutation's classified warm solve
    and its Gband truncation estimate folded in (None when health is off)."""
    if gp.config.health != "on":
        return None
    base = (gp.health if gp.health is not None
            else hv.HealthState.fresh(gp.Y.dtype, gp.device, gp.lead))
    return base.with_solve(info).with_drift(drift)


def _rebuilt(gp: AdditiveGP, xs, sort_idx, rank_idx, a, phi, b, psi, k1, X,
             Y, x0, iters: int, p, evicting: bool) -> AdditiveGP:
    """The mutated GP from its new factors, data and warm start."""
    config = gp.config
    q = config.q
    A = Banded(a, q + 1, q + 1, k1)
    Phi = Banded(phi, q, q, k1)
    SAPhi = add(scale(A, lead_count(gp.sigma ** 2, a.ndim)), Phi)
    ops = DimOps(A=A, Phi=Phi, SAPhi=SAPhi, sort_idx=sort_idx,
                 rank_idx=rank_idx, sigma2=gp.sigma ** 2, pivot=config.pivot,
                 alg=config.solve_alg, n_active=k1)
    # the coarse levels are strided re-assemblies (no solve), rebuilt per
    # mutation when the config reads them
    hier = build_gp_hier(config, gp.omega, gp.sigma, X, xs, ops)
    info = None
    if config.health == "on":
        u_sy, bY, info = mean_caches(config, ops, Y, x0=x0, iters=iters,
                                     hier=hier, return_info=True)
    else:
        u_sy, bY = mean_caches(config, ops, Y, x0=x0, iters=iters, hier=hier)
    Gband, Hband, drift = _mutated_gband(gp, ops, p, k1, evicting)
    return AdditiveGP(X=X, Y=Y, omega=gp.omega, sigma=gp.sigma, xs=xs,
                      ops=ops, B=Banded(b, q + 2, q + 2, k1),
                      Psi=Banded(psi, q + 1, q + 1, k1), bY=bY, u_sy=u_sy,
                      Gband=Gband, config=config, Hband=Hband,
                      health=_mutated_health(gp, info, drift), hier=hier,
                      n_active=k1)


def _per_dim_call(fn, gp: AdditiveGP, k, *args):
    """``fn(q, k, omega, xs, sort_idx, rank_idx, a, phi, b, psi, *args)``
    over the GP's dimensions (a fleet's flattened, ``k`` per dimension),
    its tensor outputs unflattened to the GP's layout (the last, ``p``,
    left per flattened dimension)."""
    lead, D = gp.lead, gp.D
    out = fn(gp.config.q, _dim_counts(k, lead, D),
             *(_dims(u, lead) for u in (
                 gp.omega, gp.xs, gp.ops.sort_idx, gp.ops.rank_idx,
                 gp.ops.A.data, gp.ops.Phi.data, gp.B.data, gp.Psi.data)),
             *args)
    return tuple(u.reshape(lead + (D,) + u.shape[1:]) if lead else u
                 for u in out[:7]) + out[7:]


def _insert_core(gp: AdditiveGP, x_new, y_new, iters: int) -> AdditiveGP:
    """One insert (or, on a fleet's stack, one per tenant: x_new (T, D),
    y_new (T,))."""
    k = gp.n_active
    lead = gp.lead
    xs, sort_idx, rank_idx, a, phi, b, psi, p = _per_dim_call(
        _insert_dims, gp, k, _dims(x_new, lead))
    slot = k.long().reshape(lead + (1,))
    # the new observation's original index is k: one slot write
    X = gp.X.scatter(-2, slot[..., None].expand(lead + (1, gp.D)),
                     x_new[..., None, :])
    Y = mask_rows(gp.Y, k, axis=-1).scatter(-1, slot,
                                            y_new.reshape(lead + (1,)))
    # warm start: the pre-insert solution with slot k seeded from its
    # sorted left neighbour
    us = gp.ops.to_sorted(gp.u_sy)
    est = torch.gather(us, -1, (p - 1).clamp(0, gp.n - 1).reshape(
        lead + (gp.D, 1)))
    x0 = mask_rows(gp.u_sy, k, axis=-1).scatter(
        -1, slot[..., None].expand(lead + (gp.D, 1)), est)
    return _rebuilt(gp, xs, sort_idx, rank_idx, a, phi, b, psi, k + 1, X, Y,
                    x0, iters, p, evicting=False)


def _evict_core(gp: AdditiveGP, iters: int) -> AdditiveGP:
    """Drop the oldest observation (of each tenant on a fleet's stack)."""
    k = gp.n_active
    lead = gp.lead
    p = _dims(gp.ops.rank_idx, lead)[:, 0]  # sorted position of the oldest
    xs, sort_idx, rank_idx, a, phi, b, psi = _per_dim_call(
        _evict_dims, gp, k, p)
    k1 = k - 1
    # original order shifts down by one everywhere (index 0 evicted)
    X = torch.cat([gp.X[..., 1:, :], gp.X[..., -1:, :]], dim=-2)
    Y = mask_rows(torch.cat([gp.Y[..., 1:], gp.Y[..., -1:]], dim=-1), k1,
                  axis=-1)
    x0 = mask_rows(torch.cat([gp.u_sy[..., 1:], gp.u_sy[..., -1:]], dim=-1),
                   k1, axis=-1)
    return _rebuilt(gp, xs, sort_idx, rank_idx, a, phi, b, psi, k1, X, Y, x0,
                    iters, p, evicting=True)


def _default_iters(gp: AdditiveGP, iters):
    return max(8, gp.config.solver_iters // 4) if iters is None else int(
        iters)


def insert(gp: AdditiveGP, x_new, y_new, *, iters: int | None = None,
           count: int | None = None) -> AdditiveGP:
    """Grow ``gp`` by one observation with O(q)-window factor updates, on
    the GP's device.

    Mean and variance match a fresh ``fit`` on the grown data (the factors
    bit for bit outside the insertion window; a warm-started solve of
    ``iters`` iterations, default ``max(8, solver_iters // 4)``). ``count``
    is the host-known active count: with it the insert reads nothing back
    from the device. Without it the drift sentinel runs first
    (:func:`maybe_resync`, on the incoming GP) and the capacity guard reads
    ``n_active``. A full or unpadded GP is first re-homed one row larger;
    streams should pre-pad (``fit(..., capacity=)``)."""
    iters = _default_iters(gp, iters)
    if count is None:
        gp, _ = maybe_resync(gp)
    if gp.n_active is None or (
            gp.num_points() if count is None else int(count)) >= gp.n:
        gp = with_capacity(gp, gp.n + 1)
    x_new = torch.as_tensor(x_new, dtype=gp.X.dtype).to(gp.device).reshape(
        gp.D)
    y_new = torch.as_tensor(y_new, dtype=gp.Y.dtype).to(gp.device)
    return _insert_core(gp, x_new, y_new, iters)


def evict(gp: AdditiveGP, *, iters: int | None = None,
          count: int | None = None) -> AdditiveGP:
    """Drop the oldest observation (sliding-window mode), in place at the
    GP's capacity; ``iters`` and ``count`` as :func:`insert`."""
    iters = _default_iters(gp, iters)
    if count is None:
        gp, _ = maybe_resync(gp)
    if gp.n_active is None:
        gp = with_capacity(gp, gp.n)
    if (gp.num_points() if count is None else int(count)) <= 1:
        raise ValueError("cannot evict from a GP with a single observation")
    return _evict_core(gp, iters)


def resync_gband(gp: AdditiveGP) -> AdditiveGP:
    """Recompute ``Gband``/``Hband`` exactly (``variance_band``) and zero
    the drift sentinel's counters."""
    Gband, Hband = variance_band(gp.ops.A, gp.ops.Phi,
                                 backend=gp.config.backend, return_h=True)
    health = None if gp.health is None else gp.health.after_resync()
    return dataclasses.replace(gp, Gband=Gband, Hband=Hband, health=health)


def maybe_resync(gp: AdditiveGP, *, drift_tol: float = hv.DRIFT_TOL,
                 every: int = hv.RESYNC_EVERY):
    """The drift sentinel, on the host: reads the accumulated truncation
    estimate and the mutation count (one fetch) and resyncs the band when
    the estimate crosses ``drift_tol`` or after ``every`` windowed
    mutations. Returns ``(gp, resynced)``; no fetch for health-off GPs and
    ``gband="full"``."""
    if gp.health is None or gp.config.gband == "full":
        return gp, False
    drift, muts = torch.stack([gp.health.drift,
                               gp.health.muts.to(gp.health.drift.dtype)]
                              ).tolist()
    if drift > drift_tol or muts >= every:
        return resync_gband(gp), True
    return gp, False


def _lanes(fleet, do):
    """The host mask of a masked fleet round (default: every lane) and its
    device copy."""
    do_h = (np.ones(fleet.T, bool) if do is None
            else np.asarray(do, bool).reshape(fleet.T))
    return do_h, torch.as_tensor(do_h, device=fleet.gp.device)


def _fill_unselected(gp: AdditiveGP, do, do_h) -> AdditiveGP:
    """The stack a masked round computes on: unselected lanes hold a copy
    of the first selected lane, a state the round is valid on (an
    unselected lane may be full, or hold one point); the round's select
    discards what they compute."""
    s = int(np.argmax(do_h))
    return select_tenants(do, gp, tree_map(
        lambda a: a[s:s + 1].expand(a.shape), gp))


def _guard_counts(fleet, counts):
    """The per-tenant counts a masked round runs at: the host-known
    ``counts`` (no device read), or one read of the stack's."""
    return np.asarray(fleet.counts() if counts is None else counts,
                      np.int64).reshape(fleet.T)


def fleet_insert(fleet, x_new, y_new, do=None, *, iters: int | None = None,
                 counts=None):
    """Insert one observation into each selected tenant of a
    :class:`~repro_torch.core.fleet.GPFleet`, every lane in one batched
    body (the launches of one insert, whatever T).

    ``x_new`` (T, D), ``y_new`` (T,); ``do`` (T,) bool selects the tenants
    that mutate (default: all). A selected lane must have free capacity
    (re-home the tenant to a doubled tier first, as the fleet engine does):
    a full selected lane raises ``ValueError``. ``counts`` gives the
    host-known per-tenant counts and skips the guard's device read. Each
    selected tenant's new state equals ``insert`` on its unstacked GP;
    unselected lanes come back bit for bit (a select, so whatever their
    discarded computation made cannot reach them). The drift sentinel is
    not run here (the engine runs it per lane after the round)."""
    gp = fleet.gp
    iters = _default_iters(gp, iters)
    do_h, do = _lanes(fleet, do)
    counts_h = _guard_counts(fleet, counts)
    full = np.nonzero(do_h & (counts_h >= fleet.capacity))[0]
    if full.size:
        raise ValueError(
            f"fleet_insert into full tenant lanes {full.tolist()} at capacity "
            f"{fleet.capacity}; re-home those tenants to a larger tier first")
    if not do_h.any():
        return fleet
    x_new = torch.as_tensor(np.asarray(x_new, np.float64)).to(
        gp.device).reshape(fleet.T, fleet.D)
    y_new = torch.as_tensor(np.asarray(y_new, np.float64)).to(
        gp.device).reshape(fleet.T)
    new = _insert_core(_fill_unselected(gp, do, do_h), x_new, y_new, iters)
    return type(fleet)(gp=select_tenants(do, new, gp))


def fleet_evict(fleet, do=None, *, iters: int | None = None, counts=None):
    """Drop the oldest observation of each selected tenant, every lane in
    one batched body; a selected lane must keep one observation (a
    one-point selected lane raises ``ValueError``). ``do``, ``counts`` as
    :func:`fleet_insert`."""
    gp = fleet.gp
    iters = _default_iters(gp, iters)
    do_h, do = _lanes(fleet, do)
    counts_h = _guard_counts(fleet, counts)
    low = np.nonzero(do_h & (counts_h <= 1))[0]
    if low.size:
        raise ValueError(
            f"fleet_evict from tenant lanes {low.tolist()} holding a single "
            "observation")
    if not do_h.any():
        return fleet
    new = _evict_core(_fill_unselected(gp, do, do_h), iters)
    return type(fleet)(gp=select_tenants(do, new, gp))


def fleet_resync(fleet, do=None):
    """Exact variance-band recompute (:func:`resync_gband`) of the selected
    lanes, in one batched body; unselected lanes come back bit for bit."""
    _, do = _lanes(fleet, do)
    return type(fleet)(gp=select_tenants(do, resync_gband(fleet.gp),
                                         fleet.gp))


def refresh_local_cache(gp: AdditiveGP, cache: LocalAcqCache, *,
                        mode: str = "window",
                        exact_radius: int | None = None) -> LocalAcqCache:
    """Update the dense ``M~`` acquisition cache after one :func:`insert`.

    ``gp`` is the post-insert GP, full (``n_active == capacity``: the dense
    cache's shape is the point count); ``cache`` the pre-insert cache. Each
    dimension's new row and column start as copies of the nearest sorted
    neighbour's (``mode="copy"``: no solve, the paper's O(1) path);
    ``mode="window"`` recomputes the columns within ``exact_radius``
    (default 2q + 4) of each insertion exactly, with one batch of O(q D)
    right-hand sides."""
    D, n = gp.D, gp.n
    if gp.num_points() != n:
        raise ValueError(
            "refresh_local_cache needs a full GP (n_active == capacity); "
            f"got {gp.num_points()} active of {n}")
    if mode not in ("copy", "window"):
        raise ValueError(f"unknown mode {mode!r}; expected 'copy' or 'window'")
    q = gp.config.q
    R = exact_radius if exact_radius is not None else 2 * q + 4
    dev = gp.device
    M = cache.M_tilde  # (D, n-1, D, n-1), sorted indices on both sides
    p = gp.ops.rank_idx[:, n - 1]  # sorted insert position per dim
    j = torch.arange(n, device=dev)
    src = (j[None, :] - (j[None, :] > p[:, None]).long()).clamp(0, n - 2)
    d_i = torch.arange(D, device=dev)[:, None, None, None]
    e_i = torch.arange(D, device=dev)[None, None, :, None]
    M1 = M[d_i, src[:, :, None, None], e_i, src[None, None, :, :]]
    if mode == "copy":
        return LocalAcqCache(M_tilde=M1)
    W = 2 * R + 1
    c_idx = (p[:, None] - R + torch.arange(W, device=dev)).clamp(0, n - 1)
    K = D * W
    rhs = torch.zeros((D, n, K), dtype=M.dtype, device=dev)
    rhs[torch.arange(D, device=dev).repeat_interleave(W), c_idx.reshape(-1),
        torch.arange(K, device=dev)] = 1.0
    c = gp.config
    kw = dict(pivot=c.pivot, backend=c.backend, alg=c.solve_alg)
    w = gp.ops.from_sorted(gp.ops.phi_solve(rhs, **kw))
    z = solve_mhat(gp.ops, w, c.solve_cfg(), hier=gp.hier)
    y = solve(transpose(gp.ops.Phi), gp.ops.to_sorted(z), **kw)
    cols = y.reshape(D, n, D, W)  # cols[d, i, e, k] = M_new[d, i, e, c[e, k]]
    M1 = M1.clone()
    M1[d_i, j[None, :, None, None], e_i, c_idx[None, None, :, :]] = cols
    # mirror into the rows (M~ is symmetric)
    M1[torch.arange(D, device=dev)[:, None, None, None],
       c_idx[:, :, None, None], torch.arange(D, device=dev)[None, None, :,
                                                              None],
       j[None, None, None, :]] = cols.permute(2, 3, 0, 1)
    return LocalAcqCache(M_tilde=M1)
