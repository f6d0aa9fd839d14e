"""The whole PCG backfitting solve in one launch: CUDA kernel and plain version.

Counterpart of ``repro.kernels.mega_solve.mega_pcg_solve_pallas``: the
warm-start residual, the preconditioner seed, the bounded convergence loop
with the tol check, and the exit state (x, the recursively updated r and
the realized iteration count) in ONE kernel launch
(``csrc/mega_pcg.cu``). Per iteration it applies

    Mhat p   = P^T Phi^{-1} A P p + (sum_d p_d) / s^2          (per dim d)
    M_pre r  = s^2 P^T SAPhi^{-1} Phi P r

in the reference's op order, with the two inner products per RHS column
over all (D, npad) rows. With ``tol > 0`` the loop runs while
``i < iters and any_b |rz_b| > tol^2 |rz0_b|``; every column iterates
until then. ``tol == 0`` runs exactly ``iters`` iterations.
"""
from __future__ import annotations

import torch

from . import _build
from .fused_sweep import FusedSweep, _block_solve_dim, _gather, _mv, _solve_sym
from .ops import resolve_backend

__all__ = ["MegaSolve", "mega_pcg_solve", "mega_pcg_plain", "MAX_B",
           "MAX_WIDTH"]

MAX_B = 256  # RHS columns per launch (csrc/mega_pcg.cu NT)
MAX_WIDTH = 3  # w_a, w_p, w_s <= 3 (csrc/cr.cuh instantiations)


def mega_pcg_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                   w_a: int, w_p: int, w_s: int, iters: int, tol: float = 0.0,
                   warm: bool = False):
    """Plain PyTorch whole PCG solve on padded operands (the kernel's math).

    Returns ``(x, r, iters_used)``; ``iters_used`` is an int32 0-d tensor.
    """
    s2 = sigma2.reshape(())

    def apply_mhat(u):
        tp = u.sum(dim=0)
        wv = _solve_sym(phi, _mv(a, _gather(u, sort_idx), w_a), w_p)
        return _gather(wv, rank_idx) + tp / s2

    def precondition(r):
        return _block_solve_dim(saphi, phi, sort_idx, rank_idx, s2, r,
                                w_p=w_p, w_s=w_s)

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
                   warm: bool = False, backend: str | None = None):
    """Whole PCG solve on padded operands; returns ``(x, r, iters_used)``.

    Bands (D, npad, 2w+1) float64, permutations (D, npad) int32,
    ``sigma2`` a 1-element float64 tensor, states (D, npad, B) float64.
    CUDA tensors launch ``csrc/mega_pcg.cu`` (one cooperative launch).
    """
    if resolve_backend(backend, v.device) == "plain":
        return mega_pcg_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, v,
                              x0, w_a=w_a, w_p=w_p, w_s=w_s, iters=iters,
                              tol=tol, warm=warm)
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
    nwork = lib.repro_mega_pcg_workspace(D, npad, B, w_p, w_s)
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
        B, w_a, w_p, w_s, iters, float(tol), int(warm),
        _build.stream_handle(dev))
    _build.check(err, "mega_pcg")
    _build.count_launch("mega_pcg")
    return x, r, it[0]


class MegaSolve:
    """Whole-solve dispatch over a :class:`FusedSweep`'s padded operands;
    states in and out are unpadded (D, n, B).

    A fixed-count solve (``tol == 0``) of more than ``MAX_B`` columns runs
    as column chunks of at most ``MAX_B`` (the kernel's limit): the columns
    of a fixed-count PCG are independent, so the result is the same. With
    ``tol > 0`` the reference's exit waits for every column, so on CUDA a
    wider solve raises instead of changing when the chunks stop (the plain
    version takes it whole).
    """

    def __init__(self, fs: FusedSweep):
        self.fs = fs

    def pcg(self, v, x0, *, iters: int, tol: float, backend=None):
        fs = self.fs
        if fs.a is None:
            raise ValueError("PCG needs the A factor stack")
        B = v.shape[-1]
        if (B > MAX_B and tol > 0
                and resolve_backend(backend, v.device) == "cuda"):
            raise ValueError(
                f"a tol-exit solve of {B} > {MAX_B} columns cannot be split "
                "(the exit waits for every column); pass tol=0 or fewer "
                "columns")
        step = MAX_B if B > MAX_B and tol == 0 else B
        xs, rs, its = [], [], []
        for c0 in range(0, B, step):
            v_p = fs.pad_state(v[..., c0:c0 + step])
            x0_p = (torch.zeros_like(v_p) if x0 is None
                    else fs.pad_state(x0[..., c0:c0 + step]))
            x, r, it = mega_pcg_solve(
                fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2,
                v_p, x0_p, w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=iters,
                tol=tol, warm=x0 is not None, backend=backend)
            xs.append(fs.unpad(x))
            rs.append(fs.unpad(r))
            its.append(it)
        if len(xs) == 1:
            return xs[0], rs[0], its[0]
        return torch.cat(xs, dim=-1), torch.cat(rs, dim=-1), its[0]
