"""Additive Matérn GP with sparse (Kernel Packet) algebra: the serving path.

Counterpart of ``repro.core.additive_gp``'s fit and query half (paper Sec.
5, Eqs. (12)-(13)):

    mean      mu(x*) = sum_d phi_d(x*)^T b_d,  b = Phi^{-T} P^T Mhat^{-1} S Y / s^2
    variance  s(x*)  = sum_d k_d(x*,x*) - sum_d phi_d^T G_d phi_d + w^T Mhat^{-1} w

Device rule: ``fit``, ``posterior_mean`` and ``posterior_var`` run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no such
argument they raise. On CUDA every banded kernel of the path is a
hand-written CUDA kernel; on the CPU the plain versions run. Paths that
are not ported yet raise ``NotImplementedError`` at ``fit``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..health import verdict as hv
from ..kernels import ops as _kops
from . import matern as mk
from .backfitting import DimOps, SolveConfig, check_solve_config, solve_mhat
from .band_inverse import variance_band
from .banded import Banded, add, scale, solve, transpose
from .kernel_packets import gkp_factors, kp_factors, phi_at

__all__ = ["GPConfig", "AdditiveGP", "fit", "mean_caches", "posterior_caches",
           "posterior_mean", "posterior_var", "prior_var", "resolve_device",
           "TIE_EPS"]

# span-relative separation applied to exactly-tied sorted coordinates
TIE_EPS = 1e-9

# posterior_var solves its per-query Mhat right-hand sides in column chunks
# of this size, so peak memory is O(D n _VAR_CHUNK) for any query batch
_VAR_CHUNK = 32


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """The reference's configuration fields and defaults.

    Values whose path is not ported raise ``NotImplementedError`` at
    ``fit``: ``solver`` other than "pcg", ``fused`` "on"/"off",
    ``pivot=True``, a ``precond`` that resolves to "kmg" (so ``q == 0,
    n >= 4096`` with "auto" raises: pass ``precond="none"``), and ``q >= 1``
    on CUDA. ``backend``: "auto" (by tensor device) | "cuda".
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
                           precond=self.precond)


@dataclasses.dataclass(frozen=True)
class AdditiveGP:
    """Fitted additive GP: data, banded factors, posterior caches."""

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

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def D(self) -> int:
        return self.X.shape[1]

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
    """Bake every "auto" to its concrete value and reject unported paths."""
    if config.backend not in _kops.BACKENDS:
        raise ValueError(f"unknown backend {config.backend!r}; expected one "
                         f"of {_kops.BACKENDS}")
    _kops.resolve_backend(config.backend, device)
    if config.q not in mk.SUPPORTED_Q:
        raise ValueError(f"q={config.q} not in {mk.SUPPORTED_Q}")
    if config.q >= 1 and torch.device(device).type == "cuda":
        raise NotImplementedError(
            "q >= 1 on CUDA needs the standalone block-CR kernel for its Phi "
            "solves (ROADMAP Queue 2, kernel #5); run q >= 1 on the CPU")
    gband = "windowed" if config.gband == "auto" else config.gband
    health = "on" if config.health == "auto" else config.health
    if gband not in ("windowed", "full") or health not in ("on", "off"):
        raise ValueError(f"bad gband/health: {config.gband!r}, "
                         f"{config.health!r}")
    if config.solve_alg not in _kops.SOLVE_ALGS:
        raise ValueError(f"unknown solve alg {config.solve_alg!r}")
    config = dataclasses.replace(
        config, precond=_kops.resolve_precond(config.precond, q=config.q, n=n),
        gband=gband, health=health)
    check_solve_config(config.solve_cfg())
    return config


def mean_caches(config: GPConfig, ops: DimOps, Y, return_info: bool = False):
    """(u_sy, bY) solve-dependent posterior-mean caches (+ SolveInfo)."""
    SY = Y[None, :].expand(ops.D, ops.n)
    res = solve_mhat(ops, SY, config.solve_cfg(), return_info=return_info)
    u_sy, info = res if return_info else (res, None)
    bY = solve(transpose(ops.Phi), ops.to_sorted(u_sy) / ops.sigma2,
               pivot=config.pivot, backend=config.backend,
               alg=config.solve_alg)
    if not return_info:
        return u_sy, bY
    bad_by = torch.where(torch.isfinite(bY).all(), hv.OK, hv.NONFINITE)
    info = info._replace(
        verdict=torch.maximum(info.verdict, bad_by.to(torch.int32)))
    return u_sy, bY, info


def posterior_caches(config: GPConfig, ops: DimOps, Y,
                     return_info: bool = False):
    """(u_sy, bY, Gband, Hband[, info]): mean caches + the RGF variance band."""
    res = mean_caches(config, ops, Y, return_info=return_info)
    Gband, Hband = variance_band(ops.A, ops.Phi, backend=config.backend,
                                 return_h=True)
    return res[:2] + (Gband, Hband) + res[2:]


def fit(config: GPConfig, X, Y, omega, sigma, device=None) -> AdditiveGP:
    """Build all sparse factors and posterior caches — O(n log n)."""
    device = resolve_device(device)
    X = _as_f64(X, device)
    Y = _as_f64(Y, device)
    omega = _as_f64(omega, device)
    sigma = _as_f64(sigma, device).reshape(())
    n, D = X.shape
    config = resolve_config(config, n, device)
    q = config.q
    sort_idx = torch.argsort(X.T, dim=1, stable=True)
    xs = torch.gather(X.T, 1, sort_idx)
    rank_idx = torch.argsort(sort_idx, dim=1, stable=True)
    # KP construction needs distinct sorted points: separate exact ties by a
    # span-relative epsilon (order preserving)
    span = xs[:, -1:] - xs[:, :1] + 1.0
    gaps = torch.diff(xs, dim=1)
    bump = torch.cumsum(torch.where(gaps <= 0, span * TIE_EPS,
                                    torch.zeros_like(gaps)), dim=1)
    xs = torch.cat([xs[:, :1], xs[:, 1:] + bump], dim=1)
    A, Phi = kp_factors(q, omega, xs)
    Bg, Psi = gkp_factors(q, omega, xs)
    SAPhi = add(scale(A, sigma ** 2), Phi)
    ops = DimOps(A=A, Phi=Phi, SAPhi=SAPhi, sort_idx=sort_idx,
                 rank_idx=rank_idx, sigma2=sigma ** 2)
    if config.health == "on":
        u_sy, bY, Gband, Hband, info = posterior_caches(config, ops, Y,
                                                        return_info=True)
        health = hv.HealthState.fresh(Y.dtype, device).with_solve(info)
    else:
        u_sy, bY, Gband, Hband = posterior_caches(config, ops, Y)
        health = None
    return AdditiveGP(X=X, Y=Y, omega=omega, sigma=sigma, xs=xs, ops=ops,
                      B=Bg, Psi=Psi, bY=bY, u_sy=u_sy, Gband=Gband,
                      Hband=Hband, config=config, health=health)


def _query(gp: AdditiveGP, Xq, device):
    device = resolve_device(device)
    if gp.device != device:
        raise ValueError(f"the GP lives on {gp.device}, the query asks for "
                         f"{device}; fit on the device you query on")
    return _as_f64(Xq, device)


def _phi_windows(gp: AdditiveGP, Xq):
    """Sparse phi_d(x*_d) for all dims/queries: rows, vals (D, m, 2q+2)."""
    q = gp.config.q
    A = Banded(gp.ops.A.data, q + 1, q + 1)
    return phi_at(q, gp.omega, gp.xs, A, Xq.T.contiguous())


def posterior_mean(gp: AdditiveGP, Xq, device=None):
    """mu(x*) for Xq (m, D) — Eq. (12); O(log n) per query."""
    Xq = _query(gp, Xq, device)
    rows, vals, _ = _phi_windows(gp, Xq)  # (D, m, W)
    D, m, W = rows.shape
    bwin = torch.gather(gp.bY, 1, rows.reshape(D, -1)).reshape(D, m, W)
    return (vals * bwin).sum(dim=(0, 2))


def posterior_var(gp: AdditiveGP, Xq, device=None):
    """s(x*) for Xq (m, D) — Eq. (13)."""
    Xq = _query(gp, Xq, device)
    q = gp.config.q
    W = 2 * q + 2
    D, n = gp.D, gp.n
    m = Xq.shape[0]
    dev = Xq.device
    rows, vals, _ = _phi_windows(gp, Xq)  # (D, m, W)

    # term 2: sum_d phi_d^T G_d phi_d — local window quadratic
    hw = gp.Gband.lo
    ar = torch.arange(W, device=dev)
    off = ar[None, :] - ar[:, None]  # b - a
    g_entries = gp.Gband.data[torch.arange(D, device=dev)[:, None, None, None],
                              rows[:, :, :, None], hw + off[None, None]]
    term2 = torch.einsum("dma,dmab,dmb->m", vals, g_entries, vals)

    # term 3: w^T Mhat^{-1} w, w_d = P^T Phi_d^{-1} phi_d, in column chunks
    mc = min(m, _VAR_CHUNK)
    nchunk = -(-m // mc)
    pad = nchunk * mc - m
    rows_p = torch.cat([rows, rows.new_zeros((D, pad, W))], dim=1)
    vals_p = torch.cat([vals, vals.new_zeros((D, pad, W))], dim=1)
    d_idx = torch.arange(D, device=dev)[:, None, None].expand(D, mc, W)
    m_idx = torch.arange(mc, device=dev)[None, :, None].expand(D, mc, W)
    cfg = gp.config.solve_cfg()
    term3 = []
    for c in range(nchunk):
        rc = rows_p[:, c * mc:(c + 1) * mc]
        vc = vals_p[:, c * mc:(c + 1) * mc]
        phi_cols = torch.zeros((D, n, mc), dtype=Xq.dtype, device=dev)
        phi_cols.index_put_((d_idx, rc, m_idx), vc, accumulate=True)
        w_sorted = solve(gp.ops.Phi, phi_cols, pivot=gp.config.pivot,
                         backend=gp.config.backend, alg=gp.config.solve_alg)
        w = gp.ops.from_sorted(w_sorted)
        z = solve_mhat(gp.ops, w, cfg)
        term3.append((w * z).sum(dim=(0, 1)))
    term3 = torch.cat(term3)[:m]
    return prior_var(gp, Xq.dtype) - term2 + term3


def prior_var(gp: AdditiveGP, dtype=torch.float64):
    """Prior variance sum_d k_d(x*, x*) from the kernel itself."""
    zero = torch.zeros((), dtype=dtype, device=gp.device)
    return mk.matern(gp.config.q, gp.omega, zero, zero).sum().to(dtype)
