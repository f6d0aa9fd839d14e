"""Backfitting solvers of the additive-GP system (paper Algorithm 4).

Counterpart of ``repro.core.backfitting``: applies
``Mhat^{-1} = [P Phi^{-1} A P^T + sigma^{-2} S S^T]^{-1}`` to (D, n, B)
stacks in original point order, by

  * ``gauss_seidel`` — the paper's Algorithm 4 (sequential over dimensions);
  * ``jacobi``       — all D block solves at once, damped;
  * ``pcg``          — conjugate gradients with the block preconditioner.

``SolveConfig.fused`` picks how a solve runs (``kernels.ops.resolve_fused``):
"whole" (the default that "auto" resolves to) is one launch of the
whole-solve kernel per solve (``kernels.mega_solve``); "on" is a host loop
of one-iteration kernels (``kernels.fused_sweep``); "off" is the unfused
host loop over the banded kernels of ``kernels.ops``. On CUDA tensors the
kernels launch, on CPU tensors their plain versions run. Every solver
agrees bit for bit between "whole" and "on". ``precond="kmg"`` (pcg only)
preconditions with the kernel-multigrid V-cycle over the coarse hierarchy
``hier`` (``precond.kmg_preconditioner``) in the unfused host loop.

``return_info=True`` residuals cost no extra matvec: pcg returns the
recursively updated ``r``, and the relaxation sweeps carry
``k_d = Khat_d^{-1} x_d``, from which ``v - k - (sum_d x_d)/sigma^2`` is
the exit residual elementwise (an explicit matvec only for iters == 0).

Tenant stacks (a fleet, ``core.fleet``): a ``DimOps`` whose tensors carry a
leading T axis (bands (T, D, n, w), permutations (T, D, n), ``sigma2`` and
``n_active`` (T,)) solves T independent systems; states are (T, D, n[, B]),
the cross-dimension sums and inner products stay within a tenant, and
``SolveInfo`` holds (T,) tensors. Every solver, fused mode and
preconditioner takes it: "whole" and "on" launch the tenant-axis kernels
once for the whole fleet, "off" runs the host loops over the stack (the
banded kernels fold the tenants into their batch), and a tol-exit pcg
stops each tenant on its own columns (an exited tenant keeps its state).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..health.verdict import classify_solve
from ..masking import canonical_perm, lead_count, mask_rows, tree_sum
from .banded import Banded, matvec, solve

__all__ = ["SolveConfig", "SolveInfo", "DimOps", "solve_mhat", "mhat_matvec"]

METHODS = ("gauss_seidel", "jacobi", "pcg")


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    method: str = "pcg"  # "gauss_seidel" | "jacobi" | "pcg"
    iters: int = 30
    damping: float = 0.0  # jacobi under-relaxation; 0 -> 1/D
    pivot: bool = False  # pivoted block solves
    # pcg early exit: stop once every column has |rz_k| <= tol^2 |rz_0|;
    # 0 -> fixed iteration count; the relaxation methods always run `iters`
    tol: float = 0.0
    backend: str = "auto"
    alg: str = "auto"
    fused: str = "auto"  # "auto" | "whole" | "on" | "off"
    # pcg preconditioner: "none" (per-dim block solve) | "kmg" (the V-cycle
    # over a coarse hierarchy: solve_mhat needs hier=) | "auto" (resolved at
    # fit; at a raw solve, kmg only when a hierarchy is passed)
    precond: str = "none"
    precond_smooth: int = 1  # deflated block-Jacobi sweeps per coarse solve


class SolveInfo(NamedTuple):
    """Diagnostics from ``solve_mhat(..., return_info=True)`` (tensors)."""

    iters: torch.Tensor  # iterations executed (== cfg.iters unless tol fired)
    n_active: torch.Tensor  # active system size the solve ran over
    resid: torch.Tensor  # L2 norm of v - Mhat x at exit
    rhs: torch.Tensor  # L2 norm of v
    verdict: torch.Tensor  # int32 health code


@dataclasses.dataclass(frozen=True)
class DimOps:
    """Stacked per-dimension banded factors + permutations.

    A, Phi: Banded with data (D, n, w); SAPhi = sigma^2 A + Phi;
    sort_idx (D, n): xs[d] = X[sort_idx[d], d]; rank_idx its inverse;
    sigma2 the noise variance (0-d tensor). ``pivot`` and ``alg`` are the
    pivot mode and solve alg of the GP's solves: where they route a band
    to block CR (SAPhi always, Phi at w >= 1), its block-CR factor is made
    once here (``kernels.ops.banded_factor``; one factor launch per band on
    CUDA tensors), and every solve with that band in the same mode applies
    it (``kernels.ops.factor_solve``), with the bits of a solve from the
    band. A solve in another mode solves from the band.

    ``n_active`` (0-d int32 tensor, optional) is the active length under
    capacity padding; the factor Bandeds carry the same value. Here it
    canonicalizes the permutations (identity tails) and keeps states
    exactly zero past the prefix.
    """

    A: Banded
    Phi: Banded
    SAPhi: Banded
    sort_idx: torch.Tensor
    rank_idx: torch.Tensor
    sigma2: torch.Tensor
    pivot: bool = False
    alg: str | None = None
    n_active: torch.Tensor | None = None
    phi_factor: object = dataclasses.field(default=None, init=False,
                                           repr=False, compare=False)
    saphi_factor: object = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def __post_init__(self):
        from ..kernels import ops as _kops

        for name, b in (("phi_factor", self.Phi),
                        ("saphi_factor", self.SAPhi)):
            object.__setattr__(self, name, _kops.banded_factor(
                b.data, b.lo, b.hi, pivot=self.pivot, alg=self.alg,
                n_active=self.n_active))

    @property
    def D(self) -> int:
        return self.sort_idx.shape[-2]

    @property
    def n(self) -> int:
        return self.sort_idx.shape[-1]

    @property
    def lead(self) -> tuple:
        """() for one system, (T,) for a tenant stack."""
        return tuple(self.sort_idx.shape[:-2])

    def s2(self, x):
        """sigma2 shaped to broadcast over a state ``x`` (per tenant on a
        stack)."""
        return lead_count(self.sigma2, x.ndim)

    def _permute(self, u, idx):
        """Gather along the point axis with the canonical permutation; the
        tail is zeroed again, so poisoned pad slots cannot leak."""
        k = len(self.lead)
        idx = canonical_perm(idx, self.n_active)
        idx = idx[..., None] if u.ndim == k + 3 else idx
        return mask_rows(torch.gather(u, k + 1, idx.expand(u.shape)),
                         self.n_active, axis=k + 1)

    def to_sorted(self, u):
        """(D, n[, B]) original order -> sorted order per dim."""
        return self._permute(u, self.sort_idx)

    def from_sorted(self, u):
        return self._permute(u, self.rank_idx)

    def _solve(self, band: Banded, factor, rhs, pivot: bool, backend,
               alg):
        """band^{-1} rhs, from the held factor when it was made for this
        pivot mode and ``alg`` routes the band to block CR."""
        from ..kernels import ops as _kops

        if (factor is not None and factor.pivot == pivot
                and _kops.resolve_solve_alg(alg, band.lo, band.hi) == "cr"):
            return _kops.factor_solve(factor, rhs, backend=backend)
        return solve(band, rhs, pivot=pivot, backend=backend, alg=alg)

    def phi_solve(self, rhs, pivot: bool = False,
                  backend: str | None = None, alg: str | None = None):
        """Phi^{-1} rhs per dim (sorted order), rhs (D, n[, B])."""
        return self._solve(self.Phi, self.phi_factor, rhs, pivot, backend,
                           alg)

    def khat_inv_mv(self, u, pivot: bool = False, backend: str | None = None,
                    alg: str | None = None):
        """Khat^{-1} u = P^T Phi^{-1} A P u (per dim), u: (D, n, B)."""
        w = self.phi_solve(matvec(self.A, self.to_sorted(u), backend=backend),
                           pivot=pivot, backend=backend, alg=alg)
        return self.from_sorted(w)

    def block_solve(self, r, pivot: bool = False, backend: str | None = None,
                    alg: str | None = None):
        """(Khat^{-1} + sigma^{-2} I)^{-1} r = sigma^2 P^T SAPhi^{-1} Phi P r."""
        y = matvec(self.Phi, self.to_sorted(r), backend=backend)
        w = self.s2(y) * self._solve(self.SAPhi, self.saphi_factor, y,
                                     pivot, backend, alg)
        return self.from_sorted(w)


def mhat_matvec(ops: DimOps, u, pivot: bool = False,
                backend: str | None = None, alg: str | None = None):
    """Mhat u = Khat^{-1} u + sigma^{-2} S S^T u; u: (D, n, B)."""
    k = len(ops.lead)
    ssT = tree_sum(u, axis=k).unsqueeze(k)
    return ops.khat_inv_mv(u, pivot=pivot, backend=backend,
                           alg=alg) + ssT / ops.s2(u)


def _det_dot(a, b, k: int = 0):
    """Per-column inner products over the (D, n) axes (after ``k`` leading
    tenant axes), fixed association."""
    return tree_sum(tree_sum(a * b, axis=k + 1), axis=k)


def check_solve_config(cfg: SolveConfig) -> None:
    """Reject unknown values, and kmg with a relaxation method."""
    from ..kernels import ops as _kops

    if cfg.method not in METHODS:
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.fused not in _kops.FUSED_MODES:
        raise ValueError(f"unknown fused mode {cfg.fused!r}")
    if cfg.precond not in _kops.PRECOND_MODES:
        raise ValueError(f"unknown precond {cfg.precond!r}")
    if cfg.precond == "kmg" and cfg.method != "pcg":
        raise ValueError(
            f"precond='kmg' applies to method='pcg' only (got "
            f"{cfg.method!r}); use precond='none' for relaxation sweeps")


def fused_mode(cfg: SolveConfig, a, phi, saphi) -> str:
    """``cfg.fused`` resolved for a solve over bands of (lo, hi) widths
    ``a``, ``phi``, ``saphi``: "whole" | "on" | "off". The fused kernels
    read A only for pcg and solve Phi and SAPhi by block CR only (w = 0 is
    a division), so an explicit alg="lu" keeps the unfused path."""
    from ..kernels import ops as _kops

    cr_ok = all(lo != hi or lo == 0
                or _kops.resolve_solve_alg(cfg.alg, lo, hi) == "cr"
                for lo, hi in (phi, saphi))
    widths = ([a] if cfg.method == "pcg" else []) + [phi, saphi]
    return _kops.resolve_fused(cfg.fused, widths=widths, cr_ok=cr_ok,
                               precond=cfg.precond)


def _resolved_fused(ops: DimOps, cfg: SolveConfig) -> str:
    return fused_mode(cfg, *((b.lo, b.hi) for b in (ops.A, ops.Phi,
                                                     ops.SAPhi)))


def _maybe_fused(ops: DimOps, v, cfg: SolveConfig):
    """Resolve ``cfg.fused`` for this solve: ``(mode, FusedSweep|None)``,
    mode "whole" | "on" | "off" (the FusedSweep is None when off). The
    FusedSweep takes the block-CR factors ``ops`` holds where they fit its
    padded stack (``FusedSweep``'s ``factors``), so a solve makes no factor
    of its own there."""
    from ..kernels.fused_sweep import FusedSweep

    need_a = cfg.method == "pcg"
    mode = _resolved_fused(ops, cfg)
    if mode == "off":
        return "off", None
    return mode, FusedSweep(
        ops.Phi.data, ops.SAPhi.data, ops.sort_idx, ops.rank_idx, ops.sigma2,
        w_p=ops.Phi.lo, w_s=ops.SAPhi.lo,
        a=ops.A.data if need_a else None, w_a=ops.A.lo, pivot=cfg.pivot,
        backend=cfg.backend, factors=(ops.phi_factor, ops.saphi_factor),
        n_active=ops.n_active)


def _kinv0(ops: DimOps, x0, cfg: SolveConfig):
    """Khat^{-1} x0 from the factors in hand (the warm unfused jacobi carry):
    P^T Phi^{-1} SAPhi P x0 = sigma^2 Khat^{-1} x0 + x0."""
    x0s = ops.to_sorted(x0)
    w = ops.phi_solve(matvec(ops.SAPhi, x0s, backend=cfg.backend),
                      pivot=cfg.pivot, backend=cfg.backend, alg=cfg.alg)
    return (ops.from_sorted(w) - x0) / ops.s2(x0)


def _resid_from_k(ops: DimOps, v, out, k):
    """Exit-residual norm from the carried Khat_d^{-1} x_d stack:
    r = v - k - (sum_d x_d) / sigma^2, elementwise only."""
    nb = len(ops.lead)
    r = v - k - tree_sum(out, axis=nb).unsqueeze(nb) / ops.s2(out)
    return torch.sqrt(tree_sum(_det_dot(r, r, nb), axis=-1))


def _rows(u, idx, na, axis: int):
    """``u`` gathered along ``axis`` at the canonical permutation ``idx``
    (over the leading axes of ``u`` before ``axis``), tail zeroed."""
    idx = canonical_perm(idx, na)
    idx = idx.reshape(idx.shape + (1,) * (u.ndim - idx.ndim)).expand(u.shape)
    return mask_rows(torch.gather(u, axis, idx), na, axis=axis)


def _gauss_seidel(ops: DimOps, v, cfg: SolveConfig, x0=None,
                  want_resid: bool = False):
    """Algorithm 4: block Gauss-Seidel sweeps, sequential over dimensions.

    Returns ``(out, resid|None)``; the residual depends only on the final
    sweep, so ``want_resid`` instruments just that sweep (None when
    ``cfg.iters == 0``: the caller falls back to an explicit matvec).
    """
    vt = torch.zeros_like(v) if x0 is None else x0
    want_resid = want_resid and cfg.iters > 0

    mode, fs = _maybe_fused(ops, v, cfg)
    if mode == "whole":
        from ..kernels.mega_solve import MegaSolve

        out, k = MegaSolve(fs).gauss_seidel(v, x0, iters=cfg.iters)
        return out, (_resid_from_k(ops, v, out, k) if want_resid else None)
    if fs is not None:
        v_p = fs.pad_state(v)
        u = fs.pad_state(vt)
        for _ in range(cfg.iters - 1 if want_resid else cfg.iters):
            u = fs.gauss_seidel_iter(v_p, u)
        if want_resid:
            u, k = fs.gauss_seidel_iter(v_p, u, want_resid=True)
            out = fs.unpad(u)
            return out, _resid_from_k(ops, v, out, fs.unpad(k))
        return fs.unpad(u), None

    kw = dict(pivot=cfg.pivot, backend=cfg.backend, alg=cfg.alg)

    na = ops.n_active
    k = len(ops.lead)

    def solve_one_dim(d, r_d):
        # dimension d's block solve (of every tenant), r_d: (..., n, B)
        saphi = Banded(ops.SAPhi.data[..., d, :, :], ops.SAPhi.lo,
                       ops.SAPhi.hi, na)
        phi = Banded(ops.Phi.data[..., d, :, :], ops.Phi.lo, ops.Phi.hi, na)
        rs = _rows(r_d, ops.sort_idx[..., d, :], na, k)
        w = ops.s2(r_d) * solve(saphi, matvec(phi, rs, backend=cfg.backend),
                                **kw)
        return _rows(w, ops.rank_idx[..., d, :], na, k)

    def sweep(vt, instrument=False):
        total = tree_sum(vt, axis=k)
        vt = vt.clone()
        s2 = ops.s2(total)
        ks = []
        for d in range(ops.D):
            r_d = v[..., d, :, :] - (total - vt[..., d, :, :]) / s2
            new_d = solve_one_dim(d, r_d)
            total = total - vt[..., d, :, :] + new_d
            vt[..., d, :, :] = new_d
            if instrument:
                # exact by the block solve: Khat_d^{-1} new_d = r_d - new_d/s^2
                ks.append(r_d - new_d / s2)
        return (vt, torch.stack(ks, dim=k)) if instrument else vt

    for _ in range(cfg.iters - 1 if want_resid else cfg.iters):
        vt = sweep(vt)
    if want_resid:
        vt, k = sweep(vt, instrument=True)
        return vt, _resid_from_k(ops, v, vt, k)
    return vt, None


def _jacobi(ops: DimOps, v, cfg: SolveConfig, x0=None,
            want_resid: bool = False):
    """Damped block Jacobi: all D block solves at once, alpha = damping or
    1/D (the iteration matrix's eigenvalues lie in (-(D-1), 1]).

    Returns ``(out, resid|None)``; ``want_resid`` carries the damped
    ``k ~ Khat^{-1} x`` stack through every sweep, from ``Khat^{-1} x0`` on
    a warm start.
    """
    vt = torch.zeros_like(v) if x0 is None else x0
    alpha = cfg.damping if cfg.damping > 0 else 1.0 / ops.D
    want_resid = want_resid and cfg.iters > 0

    mode, fs = _maybe_fused(ops, v, cfg)
    if mode == "whole":
        from ..kernels.mega_solve import MegaSolve

        out, k = MegaSolve(fs).jacobi(v, x0, alpha=alpha, iters=cfg.iters)
        return out, (_resid_from_k(ops, v, out, k) if want_resid else None)
    if fs is not None:
        v_p = fs.pad_state(v)
        u = fs.pad_state(vt)
        if not want_resid:
            for _ in range(cfg.iters):
                u = fs.jacobi_iter(v_p, u, alpha)
            return fs.unpad(u), None
        # the first sweep seeds k as the whole solve does: Khat^{-1} x0 on
        # a warm start, zero on a cold one
        if x0 is None:
            u, k = fs.jacobi_iter(v_p, u, alpha, k=torch.zeros_like(u))
        else:
            u, k = fs.jacobi_iter(v_p, u, alpha, warm=True)
        for _ in range(cfg.iters - 1):
            u, k = fs.jacobi_iter(v_p, u, alpha, k=k)
        out = fs.unpad(u)
        return out, _resid_from_k(ops, v, out, fs.unpad(k))

    nb = len(ops.lead)
    s2 = ops.s2(v)

    def sweep(vt):
        total = tree_sum(vt, axis=nb).unsqueeze(nb)
        r = v - (total - vt) / s2
        new = ops.block_solve(r, pivot=cfg.pivot, backend=cfg.backend,
                              alg=cfg.alg)
        return (1.0 - alpha) * vt + alpha * new, r, new

    if not want_resid:
        for _ in range(cfg.iters):
            vt = sweep(vt)[0]
        return vt, None
    k = torch.zeros_like(v) if x0 is None else _kinv0(ops, x0, cfg)
    for _ in range(cfg.iters):
        vt, r, new = sweep(vt)
        k = (1.0 - alpha) * k + alpha * (r - new / s2)
    return vt, _resid_from_k(ops, v, vt, k)


def _norm(r, k: int = 0):
    """L2 norm of a state over its (D, n, B) axes, per tenant."""
    return torch.sqrt(tree_sum(_det_dot(r, r, k), axis=-1))


def _pcg(ops: DimOps, v, cfg: SolveConfig, x0=None, hier=None):
    """Preconditioned CG on Mhat x = v; returns ``(x, iters_used, resid)``.

    The preconditioner is the per-dim block solve (``precond="none"``),
    run by the whole-solve kernel ("whole"), a host loop of one-iteration
    kernels ("on") or the unfused host loop ("off"); or the kernel-multigrid
    V-cycle over ``hier`` (``precond="kmg"``) in the unfused host loop. With
    ``cfg.tol > 0`` the loop exits once every column has
    ``|rz_k| <= tol^2 |rz_0|``; the magnitudes matter, since the V-cycle is
    symmetric but can be indefinite on part of the spectrum, so rz may pass
    through negative values on the way down. On a tenant stack each tenant
    exits on its own columns (``fused_sweep.pcg_loop``: an exited tenant
    keeps its state, its count its own; one host read a step for the whole
    stack), and ``iters_used`` is (T,).
    """
    kw = dict(pivot=cfg.pivot, backend=cfg.backend, alg=cfg.alg)
    # kmg resolves to "off" (an explicit "on"/"whole" raises there)
    mode, fs = _maybe_fused(ops, v, cfg)
    if mode == "whole":
        from ..kernels.mega_solve import MegaSolve

        x, r, iters_used = MegaSolve(fs).pcg(v, x0, iters=cfg.iters,
                                             tol=cfg.tol)
        return x, iters_used, _norm(r, len(ops.lead))
    if mode == "on":
        from ..kernels.fused_sweep import pcg_loop

        (x, r, _, _), i = pcg_loop(fs.pcg_iter, fs.pcg_seed(v, x0),
                                   iters=cfg.iters, tol=cfg.tol)
        x, r = fs.unpad(x), fs.unpad(r)
        return (x, torch.as_tensor(i, dtype=torch.int32, device=v.device),
                _norm(r, len(ops.lead)))
    if cfg.precond == "kmg":
        if hier is None:
            raise ValueError(
                "precond='kmg' needs the coarse hierarchy: pass hier= to "
                "solve_mhat (fitted GPs carry it as gp.hier)")
        from ..precond.vcycle import kmg_preconditioner

        pre = kmg_preconditioner(ops, hier, damping=cfg.damping,
                                 smooth=cfg.precond_smooth, **kw)
    else:
        def pre(u):
            return ops.block_solve(u, **kw)

    from ..kernels.fused_sweep import pcg_loop

    def amv(u):
        return mhat_matvec(ops, u, **kw)

    nb = len(ops.lead)
    # per-column scalars broadcast over the (D, n) axes of each tenant
    sc = ops.lead + (1, 1, v.shape[-1]) if nb else (v.shape[-1],)

    def dot(a, b):
        return _det_dot(a, b, nb).reshape(sc)

    def iterate(x, r, p, rz):
        ap = amv(p)
        denom = dot(p, ap)
        alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = x + alpha * p
        r = r - alpha * ap
        z = pre(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        return x, r, z + beta * p, rz_new

    x = torch.zeros_like(v) if x0 is None else x0
    # amv(0) == 0 exactly: a cold start skips it
    r = v if x0 is None else v - amv(x0)
    z = pre(r)
    (x, r, _, _), i = pcg_loop(iterate, (x, r, z, dot(r, z)),
                               iters=cfg.iters, tol=cfg.tol)
    return (x, torch.as_tensor(i, dtype=torch.int32, device=v.device),
            _norm(r, nb))


def solve_mhat(ops: DimOps, v, cfg: SolveConfig = SolveConfig(), x0=None,
               return_info: bool = False, hier=None):
    """Apply Mhat^{-1} to v: (D, n) or (D, n, B), original point order.

    ``x0`` warm-starts the iteration. ``return_info=True`` also returns a
    :class:`SolveInfo` with the realized iteration count and the verdict.
    ``hier`` is the coarse hierarchy of ``precond.build_hierarchy`` (fitted
    GPs carry it as ``gp.hier``): required with ``precond="kmg"``, ignored
    otherwise. ``precond="auto"`` takes kmg only when ``hier`` is given, by
    the fit's rule (q == 0 and n >= ``KMG_AUTO_MIN_N``).
    """
    check_solve_config(cfg)
    if cfg.precond == "auto":
        from ..kernels import ops as _kops

        precond = ("none" if hier is None or cfg.method != "pcg" else
                   _kops.resolve_precond("auto", q=ops.Phi.lo, n=ops.n))
        cfg = dataclasses.replace(cfg, precond=precond)
    k = len(ops.lead)
    vec_in = v.ndim == k + 2
    if vec_in:
        v = v[..., None]
        x0 = None if x0 is None else x0[..., None]
    dtype = torch.promote_types(v.dtype, ops.SAPhi.data.dtype)
    # under capacity padding the state tails are zeroed up front: every
    # iterate stays exactly zero past the active prefix, so the inner
    # products and residual norms run over the prefix only
    v = mask_rows(v.to(dtype), ops.n_active, axis=k + 1)
    x0 = None if x0 is None else mask_rows(x0.to(dtype), ops.n_active,
                                           axis=k + 1)
    iters_used = torch.full(ops.lead, cfg.iters, dtype=torch.int32,
                            device=v.device)
    if cfg.method == "gauss_seidel":
        out, resid = _gauss_seidel(ops, v, cfg, x0, want_resid=return_info)
    elif cfg.method == "jacobi":
        out, resid = _jacobi(ops, v, cfg, x0, want_resid=return_info)
    else:
        out, iters_used, resid = _pcg(ops, v, cfg, x0, hier)
    result = out[..., 0] if vec_in else out
    if not return_info:
        return result
    if resid is None:
        # only the degenerate iters == 0 relaxation solve reaches here (the
        # sweeps otherwise carry their own residual): one explicit matvec
        r = v - mhat_matvec(ops, out, pivot=cfg.pivot, backend=cfg.backend,
                            alg=cfg.alg)
        resid = _norm(r, k)
    rhs_norm = _norm(v, k)
    verdict = classify_solve(out, resid, rhs_norm,
                             at_cap=iters_used >= cfg.iters)
    n_active = (torch.full(ops.lead, ops.n, dtype=torch.int32,
                           device=v.device)
                if ops.n_active is None else ops.n_active.to(torch.int32))
    return result, SolveInfo(iters=iters_used, n_active=n_active, resid=resid,
                             rhs=rhs_norm, verdict=verdict)
