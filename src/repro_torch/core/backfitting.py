"""Backfitting solve of the additive-GP system (paper Algorithm 4, PCG form).

Counterpart of ``repro.core.backfitting``: applies
``Mhat^{-1} = [P Phi^{-1} A P^T + sigma^{-2} S S^T]^{-1}`` to (D, n, B)
stacks in original point order. Only the preconditioned-CG method with the
block preconditioner is ported, and it always runs as the whole-solve
kernel (``kernels.mega_solve``): one launch per solve on CUDA tensors, the
plain version on CPU tensors. ``gauss_seidel``, ``jacobi`` and
``precond="kmg"`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..health.verdict import classify_solve
from ..masking import tree_sum
from .banded import Banded, matvec, solve

__all__ = ["SolveConfig", "SolveInfo", "DimOps", "solve_mhat", "mhat_matvec"]


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    method: str = "pcg"  # only "pcg" is ported
    iters: int = 30
    pivot: bool = False
    # pcg early exit: stop once every column has |rz_k| <= tol^2 |rz_0|;
    # 0 -> fixed iteration count
    tol: float = 0.0
    backend: str = "auto"
    alg: str = "auto"
    fused: str = "auto"  # "auto" | "whole": the whole-solve kernel
    precond: str = "none"  # "none" (block preconditioner)


class SolveInfo(NamedTuple):
    """Diagnostics from ``solve_mhat(..., return_info=True)`` (tensors)."""

    iters: torch.Tensor  # iterations executed (== cfg.iters unless tol fired)
    n_active: torch.Tensor  # system size the solve ran over
    resid: torch.Tensor  # L2 norm of v - Mhat x at exit (the carried r)
    rhs: torch.Tensor  # L2 norm of v
    verdict: torch.Tensor  # int32 health code


@dataclasses.dataclass(frozen=True)
class DimOps:
    """Stacked per-dimension banded factors + permutations.

    A, Phi: Banded with data (D, n, w); SAPhi = sigma^2 A + Phi;
    sort_idx (D, n): xs[d] = X[sort_idx[d], d]; rank_idx its inverse;
    sigma2 the noise variance (0-d tensor).
    """

    A: Banded
    Phi: Banded
    SAPhi: Banded
    sort_idx: torch.Tensor
    rank_idx: torch.Tensor
    sigma2: torch.Tensor

    @property
    def D(self) -> int:
        return self.sort_idx.shape[0]

    @property
    def n(self) -> int:
        return self.sort_idx.shape[1]

    def _permute(self, u, idx):
        idx = idx[..., None] if u.ndim == 3 else idx
        return torch.gather(u, 1, idx.expand(u.shape))

    def to_sorted(self, u):
        """(D, n[, B]) original order -> sorted order per dim."""
        return self._permute(u, self.sort_idx)

    def from_sorted(self, u):
        return self._permute(u, self.rank_idx)

    def khat_inv_mv(self, u, backend: str | None = None,
                    alg: str | None = None):
        """Khat^{-1} u = P^T Phi^{-1} A P u (per dim), u: (D, n, B)."""
        w = solve(self.Phi, matvec(self.A, self.to_sorted(u), backend=backend),
                  pivot=False, backend=backend, alg=alg)
        return self.from_sorted(w)

    def block_solve(self, r, backend: str | None = None,
                    alg: str | None = None):
        """(Khat^{-1} + sigma^{-2} I)^{-1} r = sigma^2 P^T SAPhi^{-1} Phi P r."""
        y = matvec(self.Phi, self.to_sorted(r), backend=backend)
        w = self.sigma2 * solve(self.SAPhi, y, pivot=False, backend=backend,
                                alg=alg)
        return self.from_sorted(w)


def mhat_matvec(ops: DimOps, u, backend: str | None = None,
                alg: str | None = None):
    """Mhat u = Khat^{-1} u + sigma^{-2} S S^T u; u: (D, n, B)."""
    ssT = tree_sum(u, axis=0)[None]
    return ops.khat_inv_mv(u, backend=backend, alg=alg) + ssT / ops.sigma2


def _det_dot(a, b):
    """Per-column inner products over the (D, n) axes, fixed association."""
    return tree_sum(tree_sum(a * b, axis=1), axis=0)


def check_solve_config(cfg: SolveConfig) -> None:
    """Raise ``NotImplementedError`` for solve paths the port lacks."""
    if cfg.method in ("gauss_seidel", "jacobi"):
        raise NotImplementedError(
            f"solver={cfg.method!r} is not ported yet (ROADMAP Queue 2, "
            "kernels #7/#8/#10/#11); use solver='pcg'")
    if cfg.method != "pcg":
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.fused in ("on", "off"):
        raise NotImplementedError(
            f"fused={cfg.fused!r} is not ported yet (ROADMAP Queue 2, kernel "
            "#9 and the unfused dispatch path); every pcg solve takes the "
            "whole-solve kernel (fused='auto' or 'whole')")
    if cfg.fused not in ("auto", "whole"):
        raise ValueError(f"unknown fused mode {cfg.fused!r}")
    if cfg.pivot:
        raise NotImplementedError(
            "pivot=True is not ported yet (ROADMAP Queue 1, pivoted solves)")
    if cfg.precond == "kmg":
        raise NotImplementedError(
            "precond='kmg' is not ported yet (ROADMAP Queue 1, precond/); "
            "pass precond='none'")
    if cfg.precond not in ("none", "auto"):
        raise ValueError(f"unknown precond {cfg.precond!r}")


def _pcg(ops: DimOps, v, cfg: SolveConfig, x0=None):
    """Whole-solve PCG; returns ``(x, iters_used, resid)``."""
    from ..kernels.fused_sweep import FusedSweep
    from ..kernels.mega_solve import MegaSolve

    for b in (ops.A, ops.Phi, ops.SAPhi):
        if b.lo != b.hi:
            raise ValueError("the whole-solve kernel needs symmetric bands")
    fs = FusedSweep(ops.Phi.data, ops.SAPhi.data, ops.sort_idx, ops.rank_idx,
                    ops.sigma2, w_p=ops.Phi.lo, w_s=ops.SAPhi.lo,
                    a=ops.A.data, w_a=ops.A.lo)
    x, r_fin, iters_used = MegaSolve(fs).pcg(v, x0, iters=cfg.iters,
                                             tol=cfg.tol, backend=cfg.backend)
    resid = torch.sqrt(tree_sum(_det_dot(r_fin, r_fin), axis=0))
    return x, iters_used, resid


def solve_mhat(ops: DimOps, v, cfg: SolveConfig = SolveConfig(), x0=None,
               return_info: bool = False):
    """Apply Mhat^{-1} to v: (D, n) or (D, n, B), original point order.

    ``x0`` warm-starts the iteration. ``return_info=True`` also returns a
    :class:`SolveInfo` with the realized iteration count and the verdict.
    """
    check_solve_config(cfg)
    vec_in = v.ndim == 2
    if vec_in:
        v = v[..., None]
        x0 = None if x0 is None else x0[..., None]
    dtype = torch.promote_types(v.dtype, ops.SAPhi.data.dtype)
    v = v.to(dtype)
    x0 = None if x0 is None else x0.to(dtype)
    out, iters_used, resid = _pcg(ops, v, cfg, x0)
    result = out[..., 0] if vec_in else out
    if not return_info:
        return result
    rhs_norm = torch.sqrt(tree_sum(_det_dot(v, v), axis=0))
    verdict = classify_solve(out, resid, rhs_norm,
                             at_cap=iters_used >= cfg.iters)
    n_active = torch.tensor(ops.n, dtype=torch.int32, device=v.device)
    return result, SolveInfo(iters=iters_used, n_active=n_active, resid=resid,
                             rhs=rhs_norm, verdict=verdict)
