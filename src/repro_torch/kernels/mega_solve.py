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
  until then. ``tol == 0`` runs exactly ``iters`` iterations.
* Damped Jacobi (``mega_jacobi_solve_pallas``, ``csrc/jacobi.cu``) and
  Gauss-Seidel (``mega_gauss_seidel_solve_pallas``,
  ``csrc/gauss_seidel.cu``): exactly ``iters`` sweeps of the
  per-iteration kernels of ``fused_sweep.py``, returning ``(x, k)`` with
  ``k = Khat^{-1} x`` as the final sweep carries it (Jacobi: damped, from
  ``k0 = Khat^{-1} x0`` on a warm start; Gauss-Seidel: exact). The CUDA
  launch is the sweep kernel run for ``iters`` sweeps, and the plain
  version is a loop of the plain sweep, so each agrees bit for bit with a
  host loop of single sweeps.
"""
from __future__ import annotations

import torch

from . import _build
from .fused_sweep import (K_WARM, K_ZERO, MAX_B, MAX_WIDTH, FusedSweep,
                          _block_solve_dim, _gather, _khat_inv_dim,
                          _launch_gauss_seidel, _launch_jacobi, _mv,
                          _solve_sym, fused_gauss_seidel_iter_plain,
                          fused_jacobi_iter_plain)
from .ops import resolve_backend

__all__ = ["MegaSolve", "mega_pcg_solve", "mega_pcg_plain",
           "mega_jacobi_solve", "mega_jacobi_plain",
           "mega_gauss_seidel_solve", "mega_gauss_seidel_plain", "MAX_B",
           "MAX_WIDTH"]


def mega_pcg_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                   w_a: int, w_p: int, w_s: int, iters: int, tol: float = 0.0,
                   warm: bool = False, pivot: bool = False):
    """Plain PyTorch whole PCG solve on padded operands (the kernel's math).

    Returns ``(x, r, iters_used)``; ``iters_used`` is an int32 0-d tensor.
    """
    s2 = sigma2.reshape(())

    def apply_mhat(u):
        tp = u.sum(dim=0)
        wv = _solve_sym(phi, _mv(a, _gather(u, sort_idx), w_a), w_p, pivot)
        return _gather(wv, rank_idx) + tp / s2

    def precondition(r):
        return _block_solve_dim(saphi, phi, sort_idx, rank_idx, s2, r,
                                w_p=w_p, w_s=w_s, pivot=pivot)

    x = x0.clone()
    r = v - apply_mhat(x) if warm else v.clone()
    z = precondition(r)
    p = z
    rz = (r * z).sum(dim=(0, 1))
    thresh = tol ** 2 * torch.abs(rz)
    i = 0
    while i < iters and (tol <= 0 or bool((torch.abs(rz) > thresh).any())):
        ap = apply_mhat(p)
        denom = (p * ap).sum(dim=(0, 1))
        alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = x + alpha * p
        r = r - alpha * ap
        z = precondition(r)
        rz_new = (r * z).sum(dim=(0, 1))
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        p = z + beta * p
        rz = rz_new
        i += 1
    return x, r, torch.tensor(i, dtype=torch.int32, device=v.device)


def mega_pcg_solve(a, phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                   w_a: int, w_p: int, w_s: int, iters: int, tol: float = 0.0,
                   warm: bool = False, pivot: bool = False,
                   backend: str | None = None):
    """Whole PCG solve on padded operands; returns ``(x, r, iters_used)``.

    Bands (D, npad, 2w+1) float64, permutations (D, npad) int32,
    ``sigma2`` a 1-element float64 tensor, states (D, npad, B) float64.
    CUDA tensors launch ``csrc/mega_pcg.cu`` (one cooperative launch).
    """
    if resolve_backend(backend, v.device) == "plain":
        return mega_pcg_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, v,
                              x0, w_a=w_a, w_p=w_p, w_s=w_s, iters=iters,
                              tol=tol, warm=warm, pivot=pivot)
    D, npad, B = v.shape
    if not 1 <= B <= MAX_B:
        raise ValueError(f"mega_pcg kernel takes 1 <= B <= {MAX_B} columns")
    if max(w_a, w_p, w_s) > MAX_WIDTH:
        raise ValueError(f"mega_pcg kernel takes half-widths <= {MAX_WIDTH}")
    for w in (w_p, w_s):
        if w > 0 and npad % w:
            raise ValueError(f"npad={npad} is not a multiple of width {w}")
    dev = v.device
    f64 = torch.float64
    _build.expect(a, "a", f64, (D, npad, 2 * w_a + 1), dev)
    _build.expect(phi, "phi", f64, (D, npad, 2 * w_p + 1), dev)
    _build.expect(saphi, "saphi", f64, (D, npad, 2 * w_s + 1), dev)
    _build.expect(sort_idx, "sort_idx", torch.int32, (D, npad), dev)
    _build.expect(rank_idx, "rank_idx", torch.int32, (D, npad), dev)
    _build.expect(sigma2, "sigma2", f64, (1,), dev)
    _build.expect(v, "v", f64, (D, npad, B), dev)
    _build.expect(x0, "x0", f64, (D, npad, B), dev)
    lib = _build.load_library()
    nwork = lib.repro_mega_pcg_workspace(D, npad, B, w_p, w_s, int(pivot))
    if nwork < 0:
        _build.check(int(-nwork), "mega_pcg workspace query")
    work = torch.empty((nwork,), dtype=f64, device=dev)
    x = torch.empty_like(v)
    r = torch.empty_like(v)
    it = torch.empty((1,), dtype=torch.int32, device=dev)
    err = lib.repro_mega_pcg_f64(
        a.data_ptr(), phi.data_ptr(), saphi.data_ptr(), sort_idx.data_ptr(),
        rank_idx.data_ptr(), sigma2.data_ptr(), v.data_ptr(), x0.data_ptr(),
        x.data_ptr(), r.data_ptr(), it.data_ptr(), work.data_ptr(), D, npad,
        B, w_a, w_p, w_s, iters, float(tol), int(warm), int(pivot),
        _build.stream_handle(dev))
    _build.check(err, "mega_pcg")
    _build.count_launch("mega_pcg")
    return x, r, it[0]


def mega_jacobi_plain(phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                      w_p: int, w_s: int, alpha: float, iters: int,
                      pivot: bool = False, warm: bool = False):
    """Plain whole damped-Jacobi solve on padded operands: ``iters`` plain
    sweeps carrying k from ``Khat^{-1} x0`` (warm) or zero; ``(x, k)``."""
    kw = dict(w_p=w_p, w_s=w_s, pivot=pivot)
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
                      backend: str | None = None):
    """Whole damped-Jacobi solve on padded operands (as
    :func:`mega_pcg_solve`); returns ``(x, k)``. CUDA tensors launch
    ``csrc/jacobi.cu`` once for all ``iters`` sweeps."""
    kw = dict(w_p=w_p, w_s=w_s, alpha=alpha, iters=iters, pivot=pivot)
    if resolve_backend(backend, v.device) == "plain":
        return mega_jacobi_plain(phi, saphi, sort_idx, rank_idx, sigma2, v,
                                 x0, warm=warm, **kw)
    return _launch_jacobi("mega_jacobi", phi, saphi, sort_idx, rank_idx,
                          sigma2, v, x0, None,
                          kmode=K_WARM if warm else K_ZERO, **kw)


def mega_gauss_seidel_plain(phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                            w_p: int, w_s: int, iters: int,
                            pivot: bool = False):
    """Plain whole Gauss-Seidel solve on padded operands: ``iters`` plain
    sweeps; ``(x, k)`` with k from the final sweep (zero if none)."""
    x, k = x0, torch.zeros_like(v)
    for _ in range(iters):
        x, k = fused_gauss_seidel_iter_plain(
            phi, saphi, sort_idx, rank_idx, sigma2, v, x, w_p=w_p, w_s=w_s,
            pivot=pivot, want_resid=True)
    return (x0.clone() if iters == 0 else x), k


def mega_gauss_seidel_solve(phi, saphi, sort_idx, rank_idx, sigma2, v, x0,
                            *, w_p: int, w_s: int, iters: int,
                            pivot: bool = False, backend: str | None = None):
    """Whole Gauss-Seidel solve on padded operands; returns
    ``(x, k)``. CUDA tensors launch ``csrc/gauss_seidel.cu`` once for all
    ``iters`` sweeps."""
    if resolve_backend(backend, v.device) == "plain":
        return mega_gauss_seidel_plain(phi, saphi, sort_idx, rank_idx, sigma2,
                                       v, x0, w_p=w_p, w_s=w_s, iters=iters,
                                       pivot=pivot)
    return _launch_gauss_seidel("mega_gauss_seidel", phi, saphi, sort_idx,
                                rank_idx, sigma2, v, x0, w_p=w_p, w_s=w_s,
                                iters=iters, want_k=True, pivot=pivot)


class MegaSolve:
    """Whole-solve dispatch over a :class:`FusedSweep`'s padded operands;
    states in and out are unpadded (D, n, B).

    A solve of more than ``MAX_B`` columns (the kernels' limit) runs as
    column chunks of at most ``MAX_B``: the columns of a relaxation solve
    and of a fixed-count PCG (``tol == 0``) are independent, so the result
    is the same. With ``tol > 0`` the reference's PCG exit waits for every
    column, so on CUDA a wider PCG solve raises instead of changing when the
    chunks stop (the plain version takes it whole).
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
            return tuple(fs.unpad(o) if o.dim() else o
                         for o in solve(v_p, x0_p))

        return fs.by_columns(one, v, x0, step=step)

    def pcg(self, v, x0, *, iters: int, tol: float):
        fs = self.fs
        if fs.a is None:
            raise ValueError("PCG needs the A factor stack")
        B = v.shape[-1]
        if (B > MAX_B and tol > 0
                and resolve_backend(fs.backend, v.device) == "cuda"):
            raise ValueError(
                f"a tol-exit solve of {B} > {MAX_B} columns cannot be split "
                "(the exit waits for every column); pass tol=0 or fewer "
                "columns")
        return self._solve(lambda v_p, x0_p: mega_pcg_solve(
            fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p,
            x0_p, w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=iters, tol=tol,
            warm=x0 is not None, pivot=fs.pivot, backend=fs.backend),
            v, x0, MAX_B if tol == 0 else B)

    def jacobi(self, v, x0, *, alpha: float, iters: int):
        """Whole damped-Jacobi solve; returns ``(x, k)`` unpadded."""
        fs = self.fs
        return self._solve(lambda v_p, x0_p: mega_jacobi_solve(
            fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p, x0_p,
            w_p=fs.w_p, w_s=fs.w_s, alpha=alpha, iters=iters, pivot=fs.pivot,
            warm=x0 is not None, backend=fs.backend), v, x0, MAX_B)

    def gauss_seidel(self, v, x0, *, iters: int):
        """Whole Gauss-Seidel solve; returns ``(x, k)`` unpadded."""
        fs = self.fs
        return self._solve(lambda v_p, x0_p: mega_gauss_seidel_solve(
            fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p, x0_p,
            w_p=fs.w_p, w_s=fs.w_s, iters=iters, pivot=fs.pivot,
            backend=fs.backend), v, x0, MAX_B)
