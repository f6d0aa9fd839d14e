"""Additive Matérn GP with sparse (Kernel Packet) algebra.

Counterpart of ``repro.core.additive_gp`` (paper Sec. 5, Eqs. (12)-(15)):

    mean      mu(x*) = sum_d phi_d(x*)^T b_d,  b = Phi^{-T} P^T Mhat^{-1} S Y / s^2
    variance  s(x*)  = sum_d k_d(x*,x*) - sum_d phi_d^T G_d phi_d + w^T Mhat^{-1} w
    likelihood l     = -1/2 [ Y^T R Y + log|Mhat| + sum_d(log|Phi_d|-log|A_d|)
                              + 2n log s + n log 2pi ]
    gradient  dl/dw_d = 1/2 [ u^T (dK_d) u - tr(R dK_d) ],   u = R Y,
                        dK_d = P^T B_d^{-1} Psi_d P   (generalized KPs)

Device rule: ``fit``, ``posterior_mean``, ``posterior_var`` and
``fit_hyperparams`` run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no such argument they raise. The
likelihood and its gradients run where the fitted GP lives. On CUDA every
banded kernel of the path is a hand-written CUDA kernel; on the CPU the
plain versions run. With ``precond="kmg"`` (the "auto" choice at q == 0
and n >= 4096, as in the reference) ``fit`` builds the coarse hierarchy
(``gp.hier``) and every solve of the GP runs the V-cycle preconditioner.

Capacity padding: ``fit(..., capacity=)`` / :func:`with_capacity` return a
GP whose row-indexed tensors have ``capacity`` rows with ``n_active`` (a
0-d int32 tensor on the GP's device) of them real; the tail is padding that
every op treats as a decoupled identity block (``repro_torch.masking``).
Every entry point works on a padded GP, and its active results equal the
unpadded GP's; ``repro_torch.streaming`` mutates such a GP in place.

Randomness: where the reference takes a ``jax.random`` key, the port takes
a ``torch.Generator``; every probe is drawn through
``stochastic.rademacher_rows``. The private ``_log_likelihood`` and
``_mll_gradients`` take the probe blocks themselves.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..health import verdict as hv
from ..kernels import ops as _kops
from ..masking import lead_count, mask_rows
from . import matern as mk
from . import stochastic as st
from .backfitting import (DimOps, SolveConfig, check_solve_config, fused_mode,
                          mhat_matvec, solve_mhat)
from .band_inverse import variance_band
from .banded import Banded, add, logdet, matvec, scale, solve, transpose
from .kernel_packets import gkp_factors, kp_factors, phi_at, phi_grad_at

__all__ = ["GPConfig", "AdditiveGP", "fit", "with_capacity",
           "build_gp_hier", "mean_caches",
           "posterior_caches", "posterior_mean", "posterior_var",
           "posterior_mean_grad", "prior_var",
           "resolve_device", "log_likelihood", "mll_gradients",
           "fit_hyperparams", "TIE_EPS"]

LOGDET_METHODS = ("taylor", "taylor_pc")

# span-relative separation applied to exactly-tied sorted coordinates
TIE_EPS = 1e-9

# posterior_var solves its per-query Mhat right-hand sides in column chunks
# of this size, so peak memory is O(D n _VAR_CHUNK) for any query batch
_VAR_CHUNK = 32


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """The reference's configuration fields and defaults.

    Every ``solver`` ("pcg", "jacobi", "gauss_seidel") runs, with ``fused``
    "auto" (baked at ``fit`` to "whole" where the bands allow the fused
    kernels and the preconditioner is not kmg, else "off"; the fused
    kernels take every q, up to q = 3's half-width-4 bands), "whole" (one
    whole-solve launch per solve), "on" (a host loop of one-iteration
    launches) or "off" (the unfused host loops). ``precond`` "auto"
    resolves at ``fit`` to "kmg" at q == 0 and n >= 4096, else "none".
    ``pivot=True`` pivots every banded solve and log-determinant: block CR
    with block partial pivoting on the "cr" route, the pivoted banded LU
    (the reference's gbsv-style scan) with ``solve_alg="lu"``, under which
    "auto" fuses nothing ("off"). ``backend``: "auto" (by tensor device) |
    "cuda".
    """

    q: int = 0
    solver: str = "pcg"
    solver_iters: int = 50
    pivot: bool = False
    backend: str = "auto"
    solve_alg: str = "auto"
    fused: str = "auto"
    precond: str = "auto"
    precond_levels: int = 2
    precond_coarsen: int = 8
    precond_smooth: int = 1
    gband: str = "auto"
    health: str = "auto"
    logdet_order: int = 30
    logdet_probes: int = 16
    trace_probes: int = 16
    power_iters: int = 20
    logdet_method: str = "taylor_pc"

    def solve_cfg(self) -> SolveConfig:
        return SolveConfig(method=self.solver, iters=self.solver_iters,
                           pivot=self.pivot, backend=self.backend,
                           alg=self.solve_alg, fused=self.fused,
                           precond=self.precond,
                           precond_smooth=self.precond_smooth)


@dataclasses.dataclass(frozen=True)
class AdditiveGP:
    """Fitted additive GP: data, banded factors, posterior caches.

    Every row-indexed tensor has the static row count ``n``: the capacity
    when ``n_active`` (0-d int32 tensor on the GP's device) is set, and then
    only the first ``n_active`` rows are observations. ``None`` = fully
    active."""

    X: torch.Tensor  # (n, D)
    Y: torch.Tensor  # (n,)
    omega: torch.Tensor  # (D,)
    sigma: torch.Tensor  # scalar noise std
    xs: torch.Tensor  # (D, n) sorted coordinates
    ops: DimOps
    B: Banded  # generalized-KP coefficients (D, n, 2q+5)
    Psi: Banded  # generalized-KP Gram (D, n, 2q+3)
    bY: torch.Tensor  # (D, n) posterior-mean weights, sorted order
    u_sy: torch.Tensor  # (D, n) Mhat^{-1} (S Y), original order
    Gband: Banded  # (D, n, 4q+3) band of (A Phi^T)^{-1}
    config: GPConfig
    Hband: Banded | None = None  # (D, n, 4q+3) band of H = A Phi^T
    health: hv.HealthState | None = None
    # coarse KMG hierarchy (tuple of precond.CoarseLevel) when
    # config.precond == "kmg"; None otherwise
    hier: tuple | None = None
    n_active: torch.Tensor | None = None

    @property
    def n(self) -> int:
        """Static row count: the capacity when ``n_active`` is set."""
        return self.X.shape[-2]

    @property
    def capacity(self) -> int:
        return self.X.shape[-2]

    @property
    def lead(self) -> tuple:
        """() for one GP; (T,) for a fleet's stack (``core.fleet``)."""
        return tuple(self.X.shape[:-2])

    def active(self):
        """Active observation count: an int when unpadded, the 0-d
        ``n_active`` tensor otherwise (no host sync either way)."""
        return self.n if self.n_active is None else self.n_active

    def num_points(self) -> int:
        """The active count as an int (a host sync when padded)."""
        return self.n if self.n_active is None else int(self.n_active)

    @property
    def D(self) -> int:
        return self.X.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.X.device


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises without a GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _as_f64(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray) or not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(device=device, dtype=torch.float64)


def resolve_config(config: GPConfig, n: int, device) -> GPConfig:
    """Bake every "auto" to its concrete value and reject unknown values."""
    if config.backend not in _kops.BACKENDS:
        raise ValueError(f"unknown backend {config.backend!r}; expected one "
                         f"of {_kops.BACKENDS}")
    _kops.resolve_backend(config.backend, device)
    if config.q not in mk.SUPPORTED_Q:
        raise ValueError(f"q={config.q} not in {mk.SUPPORTED_Q}")
    if config.logdet_method not in LOGDET_METHODS:
        raise ValueError(f"unknown logdet_method {config.logdet_method!r}; "
                         f"expected one of {LOGDET_METHODS}")
    gband = "windowed" if config.gband == "auto" else config.gband
    health = "on" if config.health == "auto" else config.health
    if gband not in ("windowed", "full") or health not in ("on", "off"):
        raise ValueError(f"bad gband/health: {config.gband!r}, "
                         f"{config.health!r}")
    if config.solve_alg not in _kops.SOLVE_ALGS:
        raise ValueError(f"unknown solve alg {config.solve_alg!r}")
    precond = _kops.resolve_precond(config.precond, q=config.q, n=n)
    config = dataclasses.replace(config, precond=precond, gband=gband,
                                 health=health)
    cfg = config.solve_cfg()
    check_solve_config(cfg)
    # the bands every solve of this GP touches: A (q+1), Phi (q), SAPhi (q+1)
    q = config.q
    fused = fused_mode(cfg, (q + 1, q + 1), (q, q), (q + 1, q + 1))
    return dataclasses.replace(config, fused=fused)


def build_gp_hier(config: GPConfig, omega, sigma, X, xs, ops: DimOps):
    """Coarse KMG hierarchy of a fitted system; None unless precond="kmg".
    O(n) band assembly at the subsampled points, no solves."""
    if config.precond != "kmg":
        return None
    from ..precond.coarse import build_hierarchy

    return build_hierarchy(config.q, omega, sigma ** 2, X, xs, ops,
                           levels=config.precond_levels,
                           coarsen=config.precond_coarsen)


def mean_caches(config: GPConfig, ops: DimOps, Y, x0=None,
                iters: int | None = None, hier=None,
                return_info: bool = False):
    """(u_sy, bY) solve-dependent posterior-mean caches (+ SolveInfo);
    ``hier`` the KMG hierarchy (required when config.precond == "kmg").
    The streaming mutations pass ``x0``, the pre-mutation ``Mhat^{-1} S Y``
    spliced at the changed point, to warm-start the solve, and ``iters`` to
    cap it."""
    cfg = config.solve_cfg()
    if iters is not None:
        cfg = dataclasses.replace(cfg, iters=iters)
    SY = Y.unsqueeze(-2).expand(ops.lead + (ops.D, ops.n))
    res = solve_mhat(ops, SY, cfg, x0=x0, hier=hier, return_info=return_info)
    u_sy, info = res if return_info else (res, None)
    bY = solve(transpose(ops.Phi), ops.to_sorted(u_sy) / ops.s2(u_sy),
               pivot=config.pivot, backend=config.backend,
               alg=config.solve_alg)
    if not return_info:
        return u_sy, bY
    bad_by = torch.where(
        torch.isfinite(bY).reshape(ops.lead + (-1,)).all(-1), hv.OK,
        hv.NONFINITE)
    info = info._replace(
        verdict=torch.maximum(info.verdict, bad_by.to(torch.int32)))
    return u_sy, bY, info


def posterior_caches(config: GPConfig, ops: DimOps, Y, hier=None,
                     return_info: bool = False):
    """(u_sy, bY, Gband, Hband[, info]): mean caches + the RGF variance band."""
    res = mean_caches(config, ops, Y, hier=hier, return_info=return_info)
    Gband, Hband = variance_band(ops.A, ops.Phi, backend=config.backend,
                                 return_h=True)
    return res[:2] + (Gband, Hband) + res[2:]


def fit(config: GPConfig, X, Y, omega, sigma, device=None,
        capacity: int | None = None) -> AdditiveGP:
    """Build all sparse factors and posterior caches — O(n log n).

    ``capacity`` (>= n) returns the capacity-padded GP (:func:`with_capacity`
    of the unpadded fit: the active rows keep the unpadded fit's bits)."""
    device = resolve_device(device)
    X = _as_f64(X, device)
    Y = _as_f64(Y, device)
    omega = _as_f64(omega, device)
    sigma = _as_f64(sigma, device).reshape(())
    n, D = X.shape
    config = resolve_config(config, n, device)
    gp = _fit_core(config, X, Y, omega, sigma)
    return gp if capacity is None else with_capacity(gp, capacity)


def _fit_core(config: GPConfig, X, Y, omega, sigma) -> AdditiveGP:
    """:func:`fit`'s body on tensors where they live, with ``config``
    resolved: X (..., n, D), Y (..., n), omega (..., D), sigma (...); a
    leading tenant axis fits a fleet (``core.fleet.fleet_fit``), every op
    batched over it."""
    q = config.q
    lead = tuple(X.shape[:-2])
    XT = X.transpose(-1, -2)
    sort_idx = torch.argsort(XT, dim=-1, stable=True)
    xs = torch.gather(XT, -1, sort_idx)
    rank_idx = torch.argsort(sort_idx, dim=-1, stable=True)
    # KP construction needs distinct sorted points: separate exact ties by a
    # span-relative epsilon (order preserving)
    span = xs[..., -1:] - xs[..., :1] + 1.0
    gaps = torch.diff(xs, dim=-1)
    bump = torch.cumsum(torch.where(gaps <= 0, span * TIE_EPS,
                                    torch.zeros_like(gaps)), dim=-1)
    xs = torch.cat([xs[..., :1], xs[..., 1:] + bump], dim=-1)
    A, Phi = kp_factors(q, omega, xs)
    Bg, Psi = gkp_factors(q, omega, xs)
    SAPhi = add(scale(A, lead_count(sigma ** 2, A.data.ndim)), Phi)
    ops = DimOps(A=A, Phi=Phi, SAPhi=SAPhi, sort_idx=sort_idx,
                 rank_idx=rank_idx, sigma2=sigma ** 2, pivot=config.pivot,
                 alg=config.solve_alg)
    hier = build_gp_hier(config, omega, sigma, X, xs, ops)
    if config.health == "on":
        u_sy, bY, Gband, Hband, info = posterior_caches(
            config, ops, Y, hier=hier, return_info=True)
        health = hv.HealthState.fresh(Y.dtype, X.device,
                                      lead).with_solve(info)
    else:
        u_sy, bY, Gband, Hband = posterior_caches(config, ops, Y, hier=hier)
        health = None
    return AdditiveGP(X=X, Y=Y, omega=omega, sigma=sigma, xs=xs, ops=ops,
                      B=Bg, Psi=Psi, bY=bY, u_sy=u_sy, Gband=Gband,
                      Hband=Hband, config=config, health=health, hier=hier)


def _pad_rows(x, capacity: int, axis: int):
    """Zero-pad ``x`` to ``capacity`` rows along ``axis``."""
    ax = axis % x.ndim
    shape = list(x.shape)
    shape[ax] = capacity - x.shape[ax]
    return torch.cat([x, x.new_zeros(shape)], dim=ax)


def _pad_band_rows(b: Banded, capacity: int, n_active) -> Banded:
    """Pad a Banded to ``capacity`` rows with a decoupled identity tail."""
    tail = b.data.new_zeros(b.data.shape[:-2] + (capacity - b.n, b.width))
    tail[..., b.lo] = 1.0
    return Banded(torch.cat([b.data, tail], dim=-2), b.lo, b.hi, n_active)


def _pad_perm(idx, capacity: int):
    """Pad permutations (..., D, n) -> (..., D, capacity) with identity
    tails."""
    n = idx.shape[-1]
    tail = torch.arange(n, capacity, dtype=idx.dtype,
                        device=idx.device).expand(idx.shape[:-1] + (-1,))
    return torch.cat([idx, tail], dim=-1)


def with_capacity(gp: AdditiveGP, capacity: int) -> AdditiveGP:
    """Re-home a fitted GP into a ``capacity``-row padded allocation.

    Pure padding, no solve: active rows are copied bit for bit, band tails
    become decoupled identity rows, state tails zeros, permutation tails the
    identity; the kmg hierarchy is rebuilt at the new size. Works on
    unpadded and padded GPs alike (growing a full GP to the next tier)."""
    capacity = int(capacity)
    if capacity < gp.n:
        raise ValueError(
            f"capacity {capacity} < current allocation {gp.n} (capacity "
            "shrinking is not supported; evict instead)")
    if capacity == gp.n and gp.n_active is not None:
        return gp
    na = (torch.full(gp.lead, gp.n, dtype=torch.int32, device=gp.device)
          if gp.n_active is None else gp.n_active)
    ops = gp.ops
    ops_p = DimOps(A=_pad_band_rows(ops.A, capacity, na),
                   Phi=_pad_band_rows(ops.Phi, capacity, na),
                   SAPhi=_pad_band_rows(ops.SAPhi, capacity, na),
                   sort_idx=_pad_perm(ops.sort_idx, capacity),
                   rank_idx=_pad_perm(ops.rank_idx, capacity),
                   sigma2=ops.sigma2, pivot=ops.pivot, alg=ops.alg,
                   n_active=na)
    # xs tail values are never read through an active mask; keep them
    # finite and increasing above the active range
    span = gp.xs[..., -1:] - gp.xs[..., :1] + 1.0
    steps = torch.arange(1, capacity - gp.n + 1, dtype=gp.xs.dtype,
                         device=gp.device)
    xs_p = torch.cat([gp.xs, gp.xs[..., -1:] + span * steps], dim=-1)
    X_p = _pad_rows(gp.X, capacity, -2)
    return AdditiveGP(
        X=X_p, Y=_pad_rows(gp.Y, capacity, -1), omega=gp.omega,
        sigma=gp.sigma, xs=xs_p, ops=ops_p,
        B=_pad_band_rows(gp.B, capacity, na),
        Psi=_pad_band_rows(gp.Psi, capacity, na),
        bY=_pad_rows(gp.bY, capacity, -1),
        u_sy=_pad_rows(gp.u_sy, capacity, -1),
        Gband=_pad_band_rows(gp.Gband, capacity, na), config=gp.config,
        Hband=(None if gp.Hband is None
               else _pad_band_rows(gp.Hband, capacity, na)),
        health=gp.health,
        hier=build_gp_hier(gp.config, gp.omega, gp.sigma, X_p, xs_p, ops_p),
        n_active=na)


def _query(gp: AdditiveGP, Xq, device):
    device = resolve_device(device)
    if gp.device != device:
        raise ValueError(f"the GP lives on {gp.device}, the query asks for "
                         f"{device}; fit on the device you query on")
    return _as_f64(Xq, device)


def _phi_windows(gp: AdditiveGP, Xq, grad: bool = False):
    """Sparse phi_d(x*_d) for all dims/queries: rows, vals (D, m, 2q+2);
    ``grad``: d phi_d / d x*_d on the same rows."""
    q = gp.config.q
    A = Banded(gp.ops.A.data, q + 1, q + 1)
    return (phi_grad_at if grad else phi_at)(q, gp.omega, gp.xs, A,
                                             Xq.transpose(-1, -2)
                                             .contiguous(),
                                             n_active=gp.n_active)


def _window_gather(u, rows):
    """u (..., D, n) at each query's window rows (..., D, m, W)."""
    return torch.gather(u, -1, rows.reshape(rows.shape[:-2] + (-1,))
                        ).reshape(rows.shape)


def posterior_mean(gp: AdditiveGP, Xq, device=None):
    """mu(x*) for Xq (m, D) — Eq. (12); O(log n) per query."""
    Xq = _query(gp, Xq, device)
    rows, vals, _ = _phi_windows(gp, Xq)  # (D, m, W)
    return (vals * _window_gather(gp.bY, rows)).sum(dim=(-3, -1))


def _g_entries(gp: AdditiveGP, rows):
    """The variance band G_d over each query's window rows: (D, m, W, W)
    (a fleet's leading tenant axis folded into the dimensions' gather)."""
    W = rows.shape[-1]
    dev = rows.device
    ar = torch.arange(W, device=dev)
    off = ar[None, :] - ar[:, None]  # b - a
    data = gp.Gband.data.reshape((-1,) + gp.Gband.data.shape[-2:])
    r = rows.reshape((-1,) + rows.shape[-2:])
    out = data[torch.arange(r.shape[0], device=dev)[:, None, None, None],
               r[:, :, :, None], gp.Gband.lo + off[None, None]]
    return out.reshape(rows.shape + (W,))


def _var_chunks(gp: AdditiveGP, rows, vals):
    """The variance's Mhat solves, in column chunks of ``_VAR_CHUNK``
    queries (peak memory O(D n _VAR_CHUNK) for any batch): yields, per
    chunk, ``(rc, w, z)``: the chunk's window rows (D, mc, W), w_d = P^T
    Phi_d^{-1} phi_d(x*) and z = Mhat^{-1} w (D, n, mc). The last chunk is
    padded with zero KP values (zero columns of w and z). A caller that
    drops a chunk's w and z before asking for the next keeps one chunk
    alive. phi is scattered into dense columns by index_put_ with
    accumulation: rows that repeat at the clipped window ends carry zero
    values."""
    lead = rows.shape[:-3]
    D, m, W = rows.shape[-3:]
    G = lead.numel() * D  # a fleet's tenants x dimensions
    n = gp.n
    dev = rows.device
    mc = min(m, _VAR_CHUNK)
    nchunk = -(-m // mc)
    pad = nchunk * mc - m
    rows_p = torch.cat([rows, rows.new_zeros(lead + (D, pad, W))], dim=-2)
    vals_p = torch.cat([vals, vals.new_zeros(lead + (D, pad, W))], dim=-2)
    d_idx = torch.arange(G, device=dev)[:, None, None].expand(G, mc, W)
    m_idx = torch.arange(mc, device=dev)[None, :, None].expand(G, mc, W)
    cfg = gp.config.solve_cfg()
    for c in range(nchunk):
        rc = rows_p[..., c * mc:(c + 1) * mc, :]
        vc = vals_p[..., c * mc:(c + 1) * mc, :]
        phi_cols = torch.zeros(lead + (D, n, mc), dtype=vals.dtype,
                               device=dev)
        phi_cols.view(G, n, mc).index_put_(
            (d_idx, rc.reshape(G, mc, W), m_idx), vc.reshape(G, mc, W),
            accumulate=True)
        w_sorted = gp.ops.phi_solve(phi_cols, pivot=gp.config.pivot,
                                    backend=gp.config.backend,
                                    alg=gp.config.solve_alg)
        w = gp.ops.from_sorted(w_sorted)
        yield rc, w, solve_mhat(gp.ops, w, cfg, hier=gp.hier)


def posterior_var(gp: AdditiveGP, Xq, device=None):
    """s(x*) for Xq (m, D) — Eq. (13)."""
    Xq = _query(gp, Xq, device)
    m = Xq.shape[-2]
    rows, vals, _ = _phi_windows(gp, Xq)  # (D, m, W)
    # term 2: sum_d phi_d^T G_d phi_d — local window quadratic
    term2 = torch.einsum(_ein(gp, "dma,dmab,dmb->m"), vals,
                         _g_entries(gp, rows), vals)
    # term 3: w^T Mhat^{-1} w, w_d = P^T Phi_d^{-1} phi_d (a chunk's w and
    # z are let go before the next chunk's solve)
    term3 = []
    for _, w, z in _var_chunks(gp, rows, vals):
        term3.append((w * z).sum(dim=(-3, -2)))
        del w, z
    return (_per_query(prior_var(gp, Xq.dtype)) - term2
            + torch.cat(term3, dim=-1)[..., :m])


def _ein(gp: AdditiveGP, eq: str) -> str:
    """An einsum over a GP's (D, m, ...) windows, with the fleet's leading
    tenant axis where the GP is a stack."""
    if not gp.lead:
        return eq
    return ",".join("..." + t for t in eq.split("->")[0].split(",")) + \
        "->..." + eq.split("->")[1]


def _per_query(v):
    """A per-GP scalar (0-d, or (T,) on a fleet) against (..., m) rows."""
    return v if v.ndim == 0 else v[..., None]


def posterior_mean_grad(gp: AdditiveGP, Xq, device=None):
    """grad_x mu(x*) (m, D) — Eq. (30) left, from the sparse KP derivative
    windows; the query follows :func:`posterior_mean`'s device rule."""
    Xq = _query(gp, Xq, device)
    rows, dvals, _ = _phi_windows(gp, Xq, grad=True)  # (D, m, W)
    return (dvals * _window_gather(gp.bY, rows)).sum(dim=-1).transpose(-1,
                                                                      -2)


def prior_var(gp: AdditiveGP, dtype=torch.float64):
    """Prior variance sum_d k_d(x*, x*) from the kernel itself (per tenant
    on a fleet)."""
    zero = torch.zeros((), dtype=dtype, device=gp.device)
    return mk.matern(gp.config.q, gp.omega, zero, zero).sum(-1).to(dtype)


# ---------------------------------------------------------------------------
# Likelihood + gradients (Sec. 5.1, Eqs. (14)-(15))
# ---------------------------------------------------------------------------


def _count(gp: AdditiveGP):
    """The active count for the likelihood's constants: an int, or a 0-d
    float tensor of the GP's dtype when padded."""
    return gp.n if gp.n_active is None else gp.n_active.to(gp.Y.dtype)


def _r_apply(gp: AdditiveGP, v, cfg: SolveConfig):
    """R v = sigma^{-2} v - sigma^{-4} S^T Mhat^{-1} S v, v: (n,) or (n, B)."""
    SV = v[None].expand((gp.D,) + tuple(v.shape))
    z = solve_mhat(gp.ops, SV, cfg, hier=gp.hier)
    return v / gp.sigma ** 2 - z.sum(dim=0) / gp.sigma ** 4


def _probe_block(gp: AdditiveGP, generator: torch.Generator, Q: int):
    """Row-keyed Rademacher probes (D, n, Q), drawn as (n, D, Q) like the
    reference and masked to the active prefix: a padded GP sees the
    unpadded GP's probes there."""
    v = st.rademacher_rows(generator, gp.n, (gp.D, Q), dtype=gp.Y.dtype,
                           device=gp.device)
    return mask_rows(v.permute(1, 0, 2).contiguous(), gp.n_active, axis=1)


def _logdet_mhat(gp: AdditiveGP, pm_v0, probe_v):
    """log|Mhat| — paper Alg 8 ("taylor") or preconditioned ("taylor_pc"),
    with the power method's restarts ``pm_v0`` (D, n, 4) and the Hutchinson
    probes ``probe_v`` (D, n, Q) given. Under capacity padding the probes
    are masked to the active prefix, the operators act as the identity on
    the tail, and the dimension count is the active one."""
    c = gp.config
    n, D = gp.n, gp.D
    dim = D * _count(gp)
    pm_v0 = mask_rows(pm_v0, gp.n_active, axis=1)
    probe_v = mask_rows(probe_v, gp.n_active, axis=1)
    kw = dict(order=c.logdet_order, probes=probe_v.shape[-1],
              power_iters=c.power_iters, dtype=gp.Y.dtype, probe_v=probe_v,
              power_v0=pm_v0)
    lk = dict(pivot=c.pivot, backend=c.backend, alg=c.solve_alg)
    if c.logdet_method == "taylor":
        mv = lambda u: mhat_matvec(gp.ops, u, **lk)
        return st.logdet_taylor(mv, dim, (D, n), None, **kw)
    # taylor_pc: C = Khat^{-1} + sigma^{-2} I (block diagonal), log|C| exact:
    # log|K_d^{-1} + s^{-2} I| = log|A_d + s^{-2} Phi_d| - log|Phi_d|
    APhi = add(gp.ops.A, scale(gp.ops.Phi, 1.0 / gp.sigma ** 2))
    ld_c = logdet(APhi, **lk).sum() - logdet(gp.ops.Phi, **lk).sum()
    nv = lambda u: gp.ops.block_solve(mhat_matvec(gp.ops, u, **lk), **lk)
    return ld_c + st.logdet_taylor(nv, dim, (D, n), None, **kw)


def _log_likelihood(gp: AdditiveGP, pm_v0, probe_v,
                    return_verdict: bool = False):
    """Eq. (14) with the log-determinant's probe blocks given. Under
    capacity padding the quadratic term masks the tails, the banded
    log-determinants gain exactly 0 from the identity tails, and the
    constants use the active count."""
    n = _count(gp)
    Ym = mask_rows(gp.Y, gp.n_active, axis=0)
    um = mask_rows(gp.u_sy.sum(dim=0), gp.n_active, axis=0)
    quad = Ym @ Ym / gp.sigma ** 2 - (Ym @ um) / gp.sigma ** 4
    ld_mhat = _logdet_mhat(gp, pm_v0, probe_v)
    lk = dict(pivot=gp.config.pivot, backend=gp.config.backend,
              alg=gp.config.solve_alg)
    ld_k = logdet(gp.ops.Phi, **lk).sum() - logdet(gp.ops.A, **lk).sum()
    ll = -0.5 * (quad + ld_mhat + ld_k + 2.0 * n * torch.log(gp.sigma)
                 + n * math.log(2.0 * math.pi))
    if not return_verdict:
        return ll
    verdict = torch.where(torch.isfinite(ll), hv.OK, hv.NONFINITE).to(
        torch.int32)
    return ll, verdict


def log_likelihood(gp: AdditiveGP, generator: torch.Generator,
                   return_verdict: bool = False):
    """Eq. (14): exact quadratic term + stochastic log-det (Algs 6-8).

    The power method's 4 restarts and the ``logdet_probes`` Hutchinson
    probes are drawn from ``generator`` in that order.
    ``return_verdict=True`` also returns an int32 health code: the value
    reuses the fitted ``u_sy`` cache (no fresh Mhat solve), so the verdict is
    a nonfinite probe of it — NONFINITE or OK.
    """
    pm_v0 = _probe_block(gp, generator, 4)  # power_method's default restarts
    probe_v = _probe_block(gp, generator, gp.config.logdet_probes)
    return _log_likelihood(gp, pm_v0, probe_v, return_verdict=return_verdict)


def _dk_apply(gp: AdditiveGP, v):
    """Apply dK_d = P^T B_d^{-1} Psi_d P to v for all d: v (n, B) -> (D, n, B)."""
    c = gp.config
    vs = gp.ops.to_sorted(v[None].expand((gp.D,) + tuple(v.shape)))
    w = solve(gp.B, matvec(gp.Psi, vs, backend=c.backend), pivot=c.pivot,
              backend=c.backend, alg=c.solve_alg)
    return gp.ops.from_sorted(w)


def _mll_gradients(gp: AdditiveGP, V, return_info: bool = False):
    """Eq. (15) with the Hutchinson probe block ``V`` (n, Q) given. Under
    capacity padding the probes and ``u = R Y`` are masked to the active
    prefix and ``tr R``'s exact part uses the active count."""
    cfg = gp.config.solve_cfg()
    n, D = gp.n, gp.D
    Q = V.shape[-1]
    V = mask_rows(V, gp.n_active, axis=0)
    s2, s4 = gp.sigma ** 2, gp.sigma ** 4
    # u = R Y (exact, reusing the fitted Mhat^{-1} S Y)
    u = mask_rows(gp.Y / s2 - gp.u_sy.sum(dim=0) / s4, gp.n_active, axis=0)
    gu = _dk_apply(gp, u[:, None])[..., 0]  # (D, n)
    term1 = gu @ u  # (D,)

    # Hutchinson trace of R dK_d (Eq. (24)), batched over probes AND dims
    Wd = _dk_apply(gp, V)  # (D, n, Q)
    first = torch.einsum("nq,dnq->dq", V, Wd) / s2
    rhs = Wd.permute(1, 0, 2).reshape(1, n, D * Q).expand(D, n, D * Q)
    rz = solve_mhat(gp.ops, rhs, cfg, hier=gp.hier, return_info=return_info)
    z, info_z = rz if return_info else (rz, None)
    stz = z.sum(dim=0).reshape(n, D, Q)
    second = torch.einsum("nq,ndq->dq", V, stz) / s4
    trace = (first - second).mean(dim=1)  # (D,)
    grad_omega = 0.5 * (term1 - trace)

    # sigma: dMLL/dsigma^2 = 0.5 (||u||^2 - tr R), tr R with the same probes
    rzs = solve_mhat(gp.ops, V[None].expand(D, n, Q), cfg, hier=gp.hier,
                     return_info=return_info)
    zs, info_s = rzs if return_info else (rzs, None)
    quadS = torch.einsum("nq,nq->q", V, zs.sum(dim=0))
    tr_r = _count(gp) / s2 - quadS.mean() / s4
    grad_sigma = 0.5 * (u @ u - tr_r) * 2.0 * gp.sigma
    if not return_info:
        return grad_omega, grad_sigma
    fin = torch.isfinite(grad_omega).all() & torch.isfinite(grad_sigma)
    verdict = torch.maximum(
        torch.maximum(info_z.verdict, info_s.verdict),
        torch.where(fin, hv.OK, hv.NONFINITE).to(torch.int32))
    return grad_omega, grad_sigma, info_z._replace(verdict=verdict)


def mll_gradients(gp: AdditiveGP, generator: torch.Generator,
                  return_info: bool = False):
    """(d MLL / d omega (D,), d MLL / d sigma) — Eq. (15) + Hutchinson traces.

    The ``trace_probes`` probes (n, Q) are drawn from ``generator``.
    ``return_info=True`` also returns a :class:`SolveInfo` whose verdict is
    the worst over the two trace-probe Mhat solves and a nonfinite probe of
    the gradients.
    """
    V = st.rademacher_rows(generator, gp.n, (gp.config.trace_probes,),
                           dtype=gp.Y.dtype, device=gp.device)
    return _mll_gradients(gp, V, return_info=return_info)


def fit_hyperparams(config: GPConfig, X, Y, omega0, sigma0,
                    generator: torch.Generator, steps: int = 50,
                    lr: float = 0.1, device=None):
    """Adam ascent on (log omega, log sigma) using the sparse gradients.

    Each step refits and draws fresh gradient probes from ``generator``.
    Returns (fitted AdditiveGP, (omega, sigma), list of gradient norms).
    """
    device = resolve_device(device)
    X = _as_f64(X, device)
    Y = _as_f64(Y, device)
    log_om = torch.log(_as_f64(omega0, device))
    log_sg = torch.log(_as_f64(sigma0, device).reshape(()))
    m = torch.zeros(log_om.shape[0] + 1, dtype=X.dtype, device=device)
    v = torch.zeros_like(m)
    norms = []
    for i in range(steps):
        gp = fit(config, X, Y, torch.exp(log_om), torch.exp(log_sg),
                 device=device)
        g_om, g_sg = mll_gradients(gp, generator)
        g = torch.cat([g_om * torch.exp(log_om),
                       (g_sg * torch.exp(log_sg))[None]])
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** (i + 1.0))
        vh = v / (1 - 0.999 ** (i + 1.0))
        upd = lr * mh / (torch.sqrt(vh) + 1e-8)
        log_om, log_sg = log_om + upd[:-1], log_sg + upd[-1]
        norms.append(float(torch.linalg.norm(g)))
    omega, sigma = torch.exp(log_om), torch.exp(log_sg)
    return fit(config, X, Y, omega, sigma, device=device), (omega, sigma), norms
