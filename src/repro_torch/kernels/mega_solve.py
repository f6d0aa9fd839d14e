"""The whole backfitting solve in one launch: CUDA kernels and plain versions.

Counterpart of ``repro.kernels.mega_solve``: the whole solve of
``Mhat x = v`` in ONE kernel launch, for each method.

* PCG (``mega_pcg_solve_pallas``, ``csrc/mega_pcg.cu``): the warm-start
  residual, the preconditioner seed, the bounded convergence loop with the
  tol check, and the exit state (x, the recursively updated r and the
  realized iteration count). Per iteration it applies

      Mhat p   = P^T Phi^{-1} A P p + (sum_d p_d) / s^2          (per dim d)
      M_pre r  = s^2 P^T SAPhi^{-1} Phi P r

  in the reference's op order, with the two inner products per RHS column
  over all (D, npad) rows. With ``tol > 0`` the loop runs while
  ``i < iters and any_b |rz_b| > tol^2 |rz0_b|``; every column iterates
  until then. ``tol == 0`` runs exactly ``iters`` iterations. A tol-exit
  solve of more than ``MAX_B`` columns runs its column chunks in lockstep
  under that one exit (:meth:`MegaSolve.pcg`). The
  per-iteration kernel of ``fused_sweep.py`` is this kernel's carry mode
  run for one iteration, and the plain whole solve loops the plain
  iteration, so the host loop of ``fused="on"`` agrees bit for bit.
* Damped Jacobi (``mega_jacobi_solve_pallas``, ``csrc/jacobi.cu``) and
  Gauss-Seidel (``mega_gauss_seidel_solve_pallas``,
  ``csrc/gauss_seidel.cu``): exactly ``iters`` sweeps of the
  per-iteration kernels of ``fused_sweep.py``, returning ``(x, k)`` with
  ``k = Khat^{-1} x`` as the final sweep carries it (Jacobi: damped, from
  ``k0 = Khat^{-1} x0`` on a warm start; Gauss-Seidel: exact). The CUDA
  launch is the sweep kernel run for ``iters`` sweeps, and the plain
  version is a loop of the plain sweep, so each agrees bit for bit with a
  host loop of single sweeps. Both solve from the block-CR factors a
  ``FusedSweep`` holds (the Jacobi kernel SAPhi's, and Phi's for a warm
  start; the Gauss-Seidel kernel SAPhi's).
"""
from __future__ import annotations

import torch

from .fused_sweep import (K_WARM, K_ZERO, MAX_B, MAX_WIDTH, PCG_COLD,
                          PCG_WARM, FusedSweep, _check_factors, by_tenant,
                          _khat_inv_dim, _launch_gauss_seidel, _launch_jacobi, _launch_pcg,
                          fused_gauss_seidel_iter_plain,
                          fused_jacobi_iter_plain, fused_pcg_iter_plain,
                          pcg_loop, pcg_seed_plain)
from .ops import resolve_backend

__all__ = ["MegaSolve", "mega_pcg_solve", "mega_pcg_plain",
           "mega_jacobi_solve", "mega_jacobi_plain",
           "mega_gauss_seidel_solve", "mega_gauss_seidel_plain", "MAX_B",
           "MAX_WIDTH"]


def mega_pcg_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                   w_a: int, w_p: int, w_s: int, iters: int, tol: float = 0.0,
                   warm: bool = False, pivot: bool = False):
    """Plain PyTorch whole PCG solve on padded operands: the plain seed and
    a loop of the plain iteration (:func:`pcg_loop`), as the kernel runs
    them. Returns ``(x, r, iters_used)``; ``iters_used`` an int32 0-d
    tensor. A tenant stack (a leading T axis on every operand, ``sigma2``
    (T,)) is solved tenant by tenant, each with its own exit; then
    ``iters_used`` is (T,)."""
    kw = dict(w_a=w_a, w_p=w_p, w_s=w_s, pivot=pivot)
    if v.ndim == 4:
        return by_tenant(
            lambda *o: mega_pcg_plain(*o, iters=iters, tol=tol, warm=warm,
                                      **kw),
            (a, phi, saphi, sort_idx, rank_idx), (v, x0), sigma2)
    ops = (a, phi, saphi, sort_idx, rank_idx, sigma2)
    state = pcg_seed_plain(*ops, v, x0, warm=warm, **kw)
    (x, r, _, _), i = pcg_loop(
        lambda *st: fused_pcg_iter_plain(*ops, *st, **kw), state,
        iters=iters, tol=tol)
    return x, r, torch.full((), i, dtype=torch.int32, device=v.device)


def mega_pcg_solve(a, phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                   w_a: int, w_p: int, w_s: int, iters: int, tol: float = 0.0,
                   warm: bool = False, pivot: bool = False,
                   backend: str | None = None, factors=None,
                   cols: int | None = None):
    """Whole PCG solve on padded operands; returns ``(x, r, iters_used)``.

    Bands (D, npad, 2w+1) float64, permutations (D, npad) int32,
    ``sigma2`` a 1-element float64 tensor, states (D, npad, B) float64;
    or a stack of T tenants: each of these with a leading T axis,
    ``sigma2`` (T,), and then ``iters_used`` (T,) (each tenant exits on its
    own columns). CUDA tensors launch ``csrc/mega_pcg.cu`` (one cooperative
    launch; a tenant stack of T > 1 its tenant-axis kernel),
    solving from ``factors`` (``fused_sweep.pcg_factors`` of the bands;
    None: made for this call; another pivot mode raises) in items of
    ``cols`` columns (None: ``fused_sweep.pcg_solve_cols``).
    """
    kw = dict(w_a=w_a, w_p=w_p, w_s=w_s, iters=iters, tol=tol, pivot=pivot)
    _check_factors(factors, pivot)
    if resolve_backend(backend, v.device) == "plain":
        return mega_pcg_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, v,
                              x0, warm=warm, **kw)
    x, r, _, _, it = _launch_pcg("mega_pcg", a, phi, saphi, sort_idx,
                                 rank_idx, sigma2, v, x0, None,
                                 mode=PCG_WARM if warm else PCG_COLD,
                                 factors=factors, cols=cols, **kw)
    return x, r, it


def mega_jacobi_plain(phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                      w_p: int, w_s: int, alpha: float, iters: int,
                      pivot: bool = False, warm: bool = False):
    """Plain whole damped-Jacobi solve on padded operands: ``iters`` plain
    sweeps carrying k from ``Khat^{-1} x0`` (warm) or zero; ``(x, k)``. A
    tenant stack is solved tenant by tenant."""
    kw = dict(w_p=w_p, w_s=w_s, pivot=pivot)
    if v.ndim == 4:
        return by_tenant(
            lambda *o: mega_jacobi_plain(*o, alpha=alpha, iters=iters,
                                         warm=warm, **kw),
            (phi, saphi, sort_idx, rank_idx), (v, x0), sigma2)
    k = (_khat_inv_dim(saphi, phi, sort_idx, rank_idx, sigma2.reshape(()), x0,
                       **kw) if warm else torch.zeros_like(v))
    x = x0
    for _ in range(iters):
        x, k = fused_jacobi_iter_plain(phi, saphi, sort_idx, rank_idx, sigma2,
                                       v, x, k, alpha=alpha, **kw)
    return (x0.clone() if iters == 0 else x), k


def mega_jacobi_solve(phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                      w_p: int, w_s: int, alpha: float, iters: int,
                      pivot: bool = False, warm: bool = False,
                      backend: str | None = None, factors=None,
                      cols: int | None = None):
    """Whole damped-Jacobi solve on padded operands (as
    :func:`mega_pcg_solve`, a tenant stack included); returns ``(x, k)``.
    CUDA tensors launch ``csrc/jacobi.cu`` once for all ``iters`` sweeps
    (a tenant stack of T > 1 counted ``mega_jacobi_fleet``), solving from
    ``factors`` (``(Phi's or None, SAPhi's)`` ``fused_sweep.sweep_factor``,
    Phi's read only when ``warm`` at w_p >= 1; None: made for this call;
    another pivot mode raises) in items of ``cols`` columns (None:
    ``fused_sweep.jacobi_cols``)."""
    kw = dict(w_p=w_p, w_s=w_s, alpha=alpha, iters=iters, pivot=pivot)
    _check_factors(factors, pivot)
    if resolve_backend(backend, v.device) == "plain":
        return mega_jacobi_plain(phi, saphi, sort_idx, rank_idx, sigma2, v,
                                 x0, warm=warm, **kw)
    return _launch_jacobi("mega_jacobi", phi, saphi, sort_idx, rank_idx,
                          sigma2, v, x0, None,
                          kmode=K_WARM if warm else K_ZERO, factors=factors,
                          cols=cols, **kw)


def mega_gauss_seidel_plain(phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                            w_p: int, w_s: int, iters: int,
                            pivot: bool = False):
    """Plain whole Gauss-Seidel solve on padded operands: ``iters`` plain
    sweeps; ``(x, k)`` with k from the final sweep (zero if none). A tenant
    stack is solved tenant by tenant."""
    if v.ndim == 4:
        return by_tenant(
            lambda *o: mega_gauss_seidel_plain(*o, w_p=w_p, w_s=w_s,
                                               iters=iters, pivot=pivot),
            (phi, saphi, sort_idx, rank_idx), (v, x0), sigma2)
    x, k = x0, torch.zeros_like(v)
    for _ in range(iters):
        x, k = fused_gauss_seidel_iter_plain(
            phi, saphi, sort_idx, rank_idx, sigma2, v, x, w_p=w_p, w_s=w_s,
            pivot=pivot, want_resid=True)
    return (x0.clone() if iters == 0 else x), k


def mega_gauss_seidel_solve(phi, saphi, sort_idx, rank_idx, sigma2, v, x0,
                            *, w_p: int, w_s: int, iters: int,
                            pivot: bool = False, backend: str | None = None,
                            factors=None, cols: int | None = None):
    """Whole Gauss-Seidel solve on padded operands (a tenant stack
    included); returns ``(x, k)``. CUDA tensors launch
    ``csrc/gauss_seidel.cu`` once for all ``iters`` sweeps (a tenant stack
    of T > 1 counted ``mega_gauss_seidel_fleet``), solving from
    ``factors`` (SAPhi's
    ``fused_sweep.sweep_factor``; None: made for this call; another pivot
    mode raises) in items of ``cols`` columns (None:
    ``fused_sweep.gauss_seidel_cols``)."""
    _check_factors(factors, pivot)
    if resolve_backend(backend, v.device) == "plain":
        return mega_gauss_seidel_plain(phi, saphi, sort_idx, rank_idx, sigma2,
                                       v, x0, w_p=w_p, w_s=w_s, iters=iters,
                                       pivot=pivot)
    return _launch_gauss_seidel("mega_gauss_seidel", phi, saphi, sort_idx,
                                rank_idx, sigma2, v, x0, w_p=w_p, w_s=w_s,
                                iters=iters, want_k=True, pivot=pivot,
                                factors=factors, cols=cols)


class MegaSolve:
    """Whole-solve dispatch over a :class:`FusedSweep`'s padded operands;
    states in and out are unpadded (D, n, B), or (T, D, n, B) on a tenant
    stack (column chunks of at most ``FusedSweep.max_cols``).

    A solve of more than ``MAX_B`` columns (the kernels' limit) runs as
    column chunks of at most ``MAX_B``: the columns of a relaxation solve
    and of a fixed-count PCG (``tol == 0``) are independent, so the result
    is the same. With ``tol > 0`` the reference's PCG exit waits for every
    column, so a wider PCG solve runs its chunks in lockstep: one
    per-iteration launch per chunk and iteration (``fused="on"``'s loop),
    the exit tested on the host over all columns; every column iterates
    until the exit, as in one whole solve.
    """

    def __init__(self, fs: FusedSweep):
        self.fs = fs

    def _solve(self, solve, v, x0, step):
        """``solve(v_p, x0_p)`` on padded column chunks of at most ``step``
        (``FusedSweep.by_columns``); its state outputs come back unpadded
        and joined."""
        fs = self.fs

        def one(v_c, x0_c):
            v_p = fs.pad_state(v_c)
            x0_p = (torch.zeros_like(v_p) if x0_c is None
                    else fs.pad_state(x0_c))
            return tuple(fs.unpad(o) if o.dim() >= 3 else o
                         for o in solve(v_p, x0_p))

        return fs.by_columns(one, v, x0, step=step)

    def pcg(self, v, x0, *, iters: int, tol: float):
        fs = self.fs
        if fs.a is None:
            raise ValueError("PCG needs the A factor stack")
        if tol > 0 and v.shape[-1] > fs.max_cols(MAX_B):
            (x, r, _, _), i = pcg_loop(fs.pcg_iter, fs.pcg_seed(v, x0),
                                       iters=iters, tol=tol)
            return (fs.unpad(x), fs.unpad(r),
                    torch.as_tensor(i, dtype=torch.int32, device=v.device))
        return self._solve(lambda v_p, x0_p: mega_pcg_solve(
            fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p,
            x0_p, w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=iters, tol=tol,
            warm=x0 is not None, pivot=fs.pivot, backend=fs.backend,
            factors=fs.cr_factors()),
            v, x0, fs.max_cols(MAX_B))

    def jacobi(self, v, x0, *, alpha: float, iters: int):
        """Whole damped-Jacobi solve from ``FusedSweep.cr_factors`` (Phi's
        only for a warm start; one set for every column chunk); returns
        ``(x, k)`` unpadded."""
        fs = self.fs
        warm = x0 is not None
        fac = fs.cr_factors(phi=warm)
        return self._solve(lambda v_p, x0_p: mega_jacobi_solve(
            fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p, x0_p,
            w_p=fs.w_p, w_s=fs.w_s, alpha=alpha, iters=iters, pivot=fs.pivot,
            warm=warm, backend=fs.backend, factors=fac), v, x0,
            fs.max_cols(MAX_B))

    def gauss_seidel(self, v, x0, *, iters: int):
        """Whole Gauss-Seidel solve from ``FusedSweep.saphi_factor`` (one
        factor for every column chunk); returns ``(x, k)`` unpadded."""
        fs = self.fs
        fac = fs.saphi_factor()
        return self._solve(lambda v_p, x0_p: mega_gauss_seidel_solve(
            fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p, x0_p,
            w_p=fs.w_p, w_s=fs.w_s, iters=iters, pivot=fs.pivot,
            backend=fs.backend, factors=fac), v, x0, fs.max_cols(MAX_B))
