"""One backfitting iteration per launch, and the padded operand stack of the
backfitting kernels: CUDA kernels and plain versions.

Counterpart of ``repro.kernels.fused_sweep``: the padding/layout contract
(``_pad_len``, ``FusedSweep``), the value-level building blocks the
reference's kernels share (``_mv``, ``_gather``, ``_solve_sym``,
``_block_solve_dim``), and the per-iteration kernels
``fused_jacobi_iter_pallas`` (``csrc/jacobi.cu``),
``fused_gauss_seidel_iter_pallas`` (``csrc/gauss_seidel.cu``) and
``fused_pcg_iter_pallas`` (``csrc/mega_pcg.cu``). ``fused="on"`` runs a
host loop of them. Each per-iteration launch runs the whole-solve kernel
of ``mega_solve.py`` for one iteration (PCG: after one seed launch that
forms r, z, p and rz the way the whole solve starts), and each plain whole
solve is a loop of the plain iteration, so a host loop and the whole solve
agree bit for bit. The CUDA kernels solve Phi and SAPhi from block-CR
factors (``sweep_factor``) that a ``FusedSweep`` holds for all its
launches; the plain versions solve from the bands.

Padding: rows are padded to ``npad`` (n rounded up to the lcm of the solved
half-bandwidths) so every block-CR solve sees whole ``w x w`` blocks. Band
tails are decoupled identity rows, state tails zero, permutation tails map
to themselves, so pad rows stay exactly zero through gathers, matvecs and
solves. The cross-dimension total is summed over d = 0..D-1 in order, as
the kernels sum it.
"""
from __future__ import annotations

import math

import torch

from ..masking import canonical_band, canonical_perm, mask_rows
from . import _build
from .block_cr import block_cr_factor, cr_factor_size, cr_solve_values
from .ops import BandFactor, resolve_backend

__all__ = ["FusedSweep", "_pad_len", "_mv", "_gather", "_solve_sym",
           "_block_solve_dim", "_khat_inv_dim", "_sum_dims",
           "fused_jacobi_iter", "fused_jacobi_iter_plain",
           "fused_gauss_seidel_iter", "fused_gauss_seidel_iter_plain",
           "fused_pcg_iter", "fused_pcg_iter_plain", "pcg_seed",
           "pcg_seed_plain", "pcg_loop", "sweep_backward_error", "MAX_B",
           "MAX_WIDTH", "NARROW_WIDTH", "sweep_factor", "pcg_factors",
           "pcg_solve_cols", "gauss_seidel_cols", "gauss_seidel_grid",
           "jacobi_cols", "jacobi_grid", "pcg_fleet_cols",
           "jacobi_fleet_cols", "gauss_seidel_fleet_cols"]

MAX_B = 256  # RHS columns per launch (csrc/sweep.cuh SWEEP_NT)
# tenants x columns of one launch over a tenant stack (csrc/sweep.cuh MAX_TB)
MAX_TB = 4096
# w_a, w_p, w_s <= 4: each kernel has two instantiations (csrc/sweep.cuh
# apply_cols' MAXW), one for bands up to half-width 3 (q <= 2) and one for
# 4 (q = 3's A and SAPhi), whose launches count under the name + "_w4"
MAX_WIDTH = 4
NARROW_WIDTH = 3


# csrc/jacobi.cu: how the sweep kernel starts k
K_NONE, K_IN, K_ZERO, K_WARM = 0, 1, 2, 3
# csrc/mega_pcg.cu: a cold or warm seed, or a carried (x, r, p, rz)
PCG_COLD, PCG_WARM, PCG_CARRY = 0, 1, 2


def _maxw(*widths) -> int:
    """The instantiation a launch over bands of these half-widths runs:
    NARROW_WIDTH, or MAX_WIDTH where a band is wider."""
    return MAX_WIDTH if max(widths) > NARROW_WIDTH else NARROW_WIDTH


def _counted(name: str, *widths) -> str:
    """The launch-count name of a launch over these half-widths."""
    return name + "_w4" if _maxw(*widths) == MAX_WIDTH else name


def _pad_len(n: int, widths) -> int:
    """n rounded up so every solved band's w x w block view tiles evenly."""
    L = 1
    for w in widths:
        if w > 0:
            L = L * w // math.gcd(L, w)
    return -(-n // L) * L


def _mv(band, x, w):
    """Banded matvec over rows, batched: band (..., npad, 2w+1), x (...,
    npad, B); the reference's shift-multiply order with zero fill."""
    npad = x.shape[-2]
    acc = torch.zeros_like(x)
    for m in range(-w, w + 1):
        sh = torch.zeros_like(x)
        k = max(npad - abs(m), 0)
        if m >= 0:
            sh[..., :k, :] = x[..., npad - k:, :]
        else:
            sh[..., npad - k:, :] = x[..., :k, :]
        acc = acc + band[..., :, w + m, None] * sh
    return acc


def _gather(x, idx):
    """x[..., idx[i], :] over rows: x (..., npad, B), idx (..., npad)."""
    return torch.gather(x, -2, idx.long()[..., :, None].expand(x.shape))


def _sum_dims(u):
    """sum_d u[d] over the leading axis, d = 0..D-1 in order."""
    acc = u[0]
    for d in range(1, u.shape[0]):
        acc = acc + u[d]
    return acc


def _solve_sym(band, rhs, w, pivot: bool = False):
    """Symmetric-bandwidth banded solve over a (G, npad, .) batch: block CR,
    or division when w == 0."""
    if w == 0:
        return rhs / band[..., :, :1]
    nb = band.shape[-2] // w
    x, _ = cr_solve_values(band, rhs, w=w, nb=nb,
                           steps=max(0, (nb - 1).bit_length()), pivot=pivot)
    return x


def _block_solve_dim(saphi, phi, sort_idx, rank_idx, s2, r, *, w_p, w_s,
                     pivot: bool = False):
    """(Khat^{-1} + s^{-2} I)^{-1} r = s^2 P^T SAPhi^{-1} Phi P r, for all
    dims at once (leading D axis)."""
    rs = _gather(r, sort_idx)
    y = _mv(phi, rs, w_p)
    xw = s2 * _solve_sym(saphi, y, w_s, pivot)
    return _gather(xw, rank_idx)


def _khat_inv_dim(saphi, phi, sort_idx, rank_idx, s2, u, *, w_p, w_s,
                  pivot: bool = False):
    """Khat^{-1} u from the sweep's own factors (no A stack):
    P^T Phi^{-1} SAPhi P u = s^2 Khat^{-1} u + u."""
    y = _mv(saphi, _gather(u, sort_idx), w_s)
    wv = _solve_sym(phi, y, w_p, pivot)
    return (_gather(wv, rank_idx) - u) / s2


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the kernels' arithmetic in the same order)
# ---------------------------------------------------------------------------


def fused_jacobi_iter_plain(phi, saphi, sort_idx, rank_idx, sigma2, v, vt,
                            k=None, *, w_p: int, w_s: int, alpha: float,
                            pivot: bool = False, warm: bool = False):
    """One damped block-Jacobi sweep on padded operands.

    With ``k`` (or ``warm``, which first sets k = Khat^{-1} vt, the whole
    solve's warm start) the sweep also carries the damped
    ``Khat_d^{-1} x_d`` stack and returns ``(out, k_out)``. A tenant stack
    (a leading T axis on every operand, ``sigma2`` (T,)) sweeps tenant by
    tenant (:func:`by_tenant`).
    """
    if v.ndim == 4:
        return by_tenant(
            lambda *o: fused_jacobi_iter_plain(*o, w_p=w_p, w_s=w_s,
                                               alpha=alpha, pivot=pivot,
                                               warm=warm),
            (phi, saphi, sort_idx, rank_idx), (v, vt, k), sigma2)
    s2 = sigma2.reshape(())
    if warm:
        k = _khat_inv_dim(saphi, phi, sort_idx, rank_idx, s2, vt, w_p=w_p,
                          w_s=w_s, pivot=pivot)
    total = _sum_dims(vt)
    r = v - (total - vt) / s2
    new = _block_solve_dim(saphi, phi, sort_idx, rank_idx, s2, r, w_p=w_p,
                           w_s=w_s, pivot=pivot)
    out = (1.0 - alpha) * vt + alpha * new
    if k is None:
        return out
    return out, (1.0 - alpha) * k + alpha * (r - new / s2)


def fused_gauss_seidel_iter_plain(phi, saphi, sort_idx, rank_idx, sigma2, v,
                                  vt, *, w_p: int, w_s: int,
                                  pivot: bool = False,
                                  want_resid: bool = False):
    """One Gauss-Seidel sweep, dims in sequence, on padded operands; with
    ``want_resid`` also the per-dim ``k_d = Khat_d^{-1} x_d``: (out, k). A
    tenant stack sweeps tenant by tenant (:func:`by_tenant`)."""
    if v.ndim == 4:
        return by_tenant(
            lambda *o: fused_gauss_seidel_iter_plain(
                *o, w_p=w_p, w_s=w_s, pivot=pivot, want_resid=want_resid),
            (phi, saphi, sort_idx, rank_idx), (v, vt), sigma2)
    s2 = sigma2.reshape(())
    out = vt.clone()
    k = torch.zeros_like(vt) if want_resid else None
    total = _sum_dims(vt)
    for d in range(vt.shape[0]):
        sl = slice(d, d + 1)
        cur = out[d]
        r = v[d] - (total - cur) / s2
        new = _block_solve_dim(saphi[sl], phi[sl], sort_idx[sl],
                               rank_idx[sl], s2, r[None], w_p=w_p, w_s=w_s,
                               pivot=pivot)[0]
        # the reference's update order: total - old + new
        total = total - cur + new
        out[d] = new
        if want_resid:
            k[d] = r - new / s2
    return (out, k) if want_resid else out


def _dot(a, b):
    """Per-column inner products over the (D, npad) rows."""
    return (a * b).sum(dim=(0, 1))


def _mhat_dim(a, phi, sort_idx, rank_idx, s2, u, *, w_a, w_p,
              pivot: bool = False):
    """Mhat u = P^T Phi^{-1} A P u + (sum_d u_d) / s^2, all dims at once."""
    wv = _solve_sym(phi, _mv(a, _gather(u, sort_idx), w_a), w_p, pivot)
    return _gather(wv, rank_idx) + u.sum(dim=0) / s2


def by_tenant(fn, ops, states, sigma2):
    """``fn(*ops_t, sigma2_t, *states_t)`` for each tenant t of a stack
    (operands and states with a leading T axis, ``sigma2`` (T,)), the
    outputs stacked over t: the plain versions' tenant axis."""
    T = states[0].shape[0]
    outs = [fn(*(None if o is None else o[t] for o in ops),
               sigma2[t:t + 1],
               *(None if u is None else u[t] for u in states))
            for t in range(T)]
    if not isinstance(outs[0], tuple):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


def pcg_seed_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *,
                   w_a: int, w_p: int, w_s: int, warm: bool,
                   pivot: bool = False):
    """The PCG seed on padded operands: ``(x, r, p, rz)`` with x = x0,
    r = v - Mhat x0 (v when cold: Mhat 0 = 0), p = z = M_pre^{-1} r and
    rz = <r, z> of shape (1, B). A tenant stack (a leading T axis on every
    operand, ``sigma2`` (T,)) is seeded tenant by tenant."""
    if v.ndim == 4:
        return by_tenant(
            lambda *o: pcg_seed_plain(*o, w_a=w_a, w_p=w_p, w_s=w_s,
                                      warm=warm, pivot=pivot),
            (a, phi, saphi, sort_idx, rank_idx), (v, x0), sigma2)
    s2 = sigma2.reshape(())
    r = (v - _mhat_dim(a, phi, sort_idx, rank_idx, s2, x0, w_a=w_a, w_p=w_p,
                       pivot=pivot) if warm else v.clone())
    z = _block_solve_dim(saphi, phi, sort_idx, rank_idx, s2, r, w_p=w_p,
                         w_s=w_s, pivot=pivot)
    return x0.clone(), r, z, _dot(r, z)[None]


def fused_pcg_iter_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, x, r, p,
                         rz, *, w_a: int, w_p: int, w_s: int,
                         pivot: bool = False):
    """One PCG iteration on Mhat with the block preconditioner, on padded
    operands; ``rz`` (1, B) the carried <r, z>. Returns ``(x, r, p, rz)``.
    A tenant stack (as :func:`pcg_seed_plain`) iterates tenant by tenant."""
    if x.ndim == 4:
        return by_tenant(
            lambda *o: fused_pcg_iter_plain(*o, w_a=w_a, w_p=w_p, w_s=w_s,
                                            pivot=pivot),
            (a, phi, saphi, sort_idx, rank_idx), (x, r, p, rz), sigma2)
    s2 = sigma2.reshape(())
    ap = _mhat_dim(a, phi, sort_idx, rank_idx, s2, p, w_a=w_a, w_p=w_p,
                   pivot=pivot)
    rz = rz[0]
    denom = _dot(p, ap)
    alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
    x = x + alpha * p
    r = r - alpha * ap
    z = _block_solve_dim(saphi, phi, sort_idx, rank_idx, s2, r, w_p=w_p,
                         w_s=w_s, pivot=pivot)
    rz_new = _dot(r, z)
    beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
    return x, r, z + beta * p, rz_new[None]


def pcg_loop(iterate, state, *, iters: int, tol: float):
    """``state = iterate(*state)`` on the PCG state (x, r, p, rz) while
    fewer than ``iters`` iterations ran and (``tol == 0`` or some column
    has |rz| > tol^2 |rz_0|): the whole-solve kernel's exit, checked on the
    host (one read of rz per iteration when ``tol > 0``). Returns
    ``(state, iterations run)``. On a tenant stack (x (T, D, n, B), ``rz``
    with a leading T axis) each tenant exits on its own columns, as the
    tenant-axis kernel does: an exited tenant keeps its state (a select
    after each iteration) and the count is (T,) int32."""
    if state[0].ndim == 4:
        return _pcg_loop_tenants(iterate, state, iters=iters, tol=tol)
    thresh = tol * tol * torch.abs(state[3])
    i = 0
    while i < iters and (tol <= 0
                         or bool((torch.abs(state[3]) > thresh).any())):
        state = iterate(*state)
        i += 1
    return state, i


def _pcg_loop_tenants(iterate, state, *, iters: int, tol: float):
    T = state[3].shape[0]
    dev = state[3].device
    thresh = tol * tol * torch.abs(state[3])
    its = torch.zeros(T, dtype=torch.int32)
    act = torch.ones(T, dtype=torch.bool)
    for _ in range(iters):
        if tol > 0:
            act = (torch.abs(state[3]) > thresh).reshape(T, -1).any(1).cpu()
            if not bool(act.any()):
                break
        new = iterate(*state)
        if bool(act.all()):
            state = new
        else:
            keep = act.to(dev)
            state = tuple(torch.where(keep.reshape((T,) + (1,) * (u.ndim - 1)),
                                      n, u) for n, u in zip(new, state))
        its += act.to(torch.int32)
    return state, its.to(dev)


def sweep_backward_error(phi, saphi, sort_idx, rank_idx, sigma2, v, vt, new,
                         *, w_p: int, w_s: int, sequential: bool) -> float:
    """Largest normwise backward error of the SAPhi solves of one undamped
    sweep that took ``vt`` to ``new`` (Jacobi at alpha = 1, or Gauss-Seidel
    with ``sequential``), over every (dimension, column):
    |SAPhi y - Phi P r|_inf / (|SAPhi|_inf |y|_inf + |Phi P r|_inf), with
    y = P new / s^2 and r rebuilt from v, vt and new in the sweep's order.
    A stable solve reads a few eps however ill-conditioned SAPhi is, so
    this tells two solvers' rounding gap (up to cond(SAPhi) eps) from a
    wrong result."""
    s2 = sigma2.reshape(())
    total = _sum_dims(vt)
    r = torch.empty_like(v)
    for d in range(v.shape[0]):
        r[d] = v[d] - (total - vt[d]) / s2
        if sequential:
            total = total - vt[d] + new[d]
    y = _gather(new, sort_idx) / s2
    rhs = _mv(phi, _gather(r, sort_idx), w_p)
    res = (_mv(saphi, y, w_s) - rhs).abs().amax(1)
    norm = saphi.abs().sum(-1).amax(-1)[:, None]
    return float((res / (norm * y.abs().amax(1)
                         + rhs.abs().amax(1))).max())


# ---------------------------------------------------------------------------
# launches (shared with the whole-solve wrappers of mega_solve.py)
# ---------------------------------------------------------------------------


def _check_operands(phi, saphi, sort_idx, rank_idx, sigma2, states, w_p,
                    w_s):
    """(lead, D, npad, B, device): ``lead`` is () for one system and (T,)
    for a stack of T tenants (every operand with that leading axis,
    ``sigma2`` then (T,))."""
    lead = tuple(states[0].shape[:-3])
    D, npad, B = states[0].shape[-3:]
    if not 1 <= B <= MAX_B:
        raise ValueError(f"the sweep kernels take 1 <= B <= {MAX_B} columns")
    if not (0 <= w_p <= MAX_WIDTH and 1 <= w_s <= MAX_WIDTH):
        raise ValueError(f"the sweep kernels take w_p <= {MAX_WIDTH} and "
                         f"1 <= w_s <= {MAX_WIDTH}")
    for w in (w_p, w_s):
        if w > 0 and npad % w:
            raise ValueError(f"npad={npad} is not a multiple of width {w}")
    dev, f64 = states[0].device, torch.float64
    _build.expect(phi, "phi", f64, lead + (D, npad, 2 * w_p + 1), dev)
    _build.expect(saphi, "saphi", f64, lead + (D, npad, 2 * w_s + 1), dev)
    _build.expect(sort_idx, "sort_idx", torch.int32, lead + (D, npad), dev)
    _build.expect(rank_idx, "rank_idx", torch.int32, lead + (D, npad), dev)
    _build.expect(sigma2, "sigma2", f64, lead or (1,), dev)
    for i, t in enumerate(states):
        _build.expect(t, f"state {i}", f64, lead + (D, npad, B), dev)
    return lead, D, npad, B, dev


def _tenants(lead, B):
    """T of a launch over operands with leading axes ``lead`` (() or (T,)),
    checked against the kernels' (tenant, column) limit."""
    T = lead[0] if lead else 1
    if T * B > MAX_TB:
        raise ValueError(f"a launch takes T * B <= {MAX_TB}; got T = {T}, "
                         f"B = {B}")
    return T


def _fleet_name(name, T, *widths):
    """The launch-count name of a launch over T tenants and these widths."""
    return _counted(name if T == 1 else name + "_fleet", *widths)


def _launch_jacobi(name, phi, saphi, sort_idx, rank_idx, sigma2, v, x_in,
                   k_in, *, w_p, w_s, alpha, iters, kmode, pivot,
                   factors=None, cols=None):
    """``csrc/jacobi.cu`` for ``iters`` sweeps; returns (x, k or None).
    ``factors`` are ``(Phi's or None, SAPhi's)`` :func:`sweep_factor` in
    this pivot mode; Phi's is read only by a warm start at w_p >= 1 (None:
    each made here where it is read, one ``cr_factor`` launch each).
    ``cols`` the columns per solve item (None: :func:`jacobi_cols`). A
    stack of T tenants (every operand with a leading T axis, ``sigma2``
    (T,)) is one launch of the same kernel; with T > 1 it counts as
    ``name + "_fleet"``."""
    states = (v, x_in) if k_in is None else (v, x_in, k_in)
    lead, D, npad, B, dev = _check_operands(phi, saphi, sort_idx, rank_idx,
                                            sigma2, states, w_p, w_s)
    T = _tenants(lead, B)
    need_p = w_p > 0 and kmode == K_WARM
    if factors is None:
        factors = pcg_factors(phi, saphi, w_p=w_p if need_p else 0, w_s=w_s,
                              pivot=pivot)
    fac_p = (_factor_data(factors[0], "Phi", w_p, T * D, npad, dev)
             if need_p else None)
    fac_s = _factor_data(factors[1], "SAPhi", w_s, T * D, npad, dev)
    _check_cols(cols)
    lib = _build.load_library()
    work = torch.empty((lib.repro_jacobi_workspace(T, D, npad, B),),
                       dtype=torch.float64, device=dev)
    x = torch.empty_like(v)
    k = None if kmode == K_NONE else torch.empty_like(v)
    err = lib.repro_jacobi_f64(
        phi.data_ptr(), saphi.data_ptr(),
        None if fac_p is None else fac_p.data_ptr(), fac_s.data_ptr(),
        sort_idx.data_ptr(), rank_idx.data_ptr(), sigma2.data_ptr(),
        v.data_ptr(), x_in.data_ptr(),
        None if k_in is None else k_in.data_ptr(), x.data_ptr(),
        None if k is None else k.data_ptr(), work.data_ptr(), T, D, npad,
        B, w_p, w_s, iters, cols or 0, float(alpha), kmode, int(pivot),
        _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(_fleet_name(name, T, w_p, w_s))
    return x, k


def _check_cols(cols):
    if cols is not None and cols < 1:
        raise ValueError(f"cols must be >= 1, got {cols}")


def sweep_factor(band, w: int, pivot: bool = False) -> BandFactor:
    """The block-CR factor of a padded band stack (..., D, npad, 2w+1) as
    the sweep kernels take it (``factors=``): one ``block_cr_factor`` launch
    over every band of the stack, with the pivot mode it was made in."""
    npad = band.shape[-2]
    return BandFactor(block_cr_factor(band.reshape((-1,) + band.shape[-2:]),
                                      w, pivot=pivot),
                      tuple(band.shape[:-2]), npad, w, pivot)


def _check_factors(factors, pivot: bool):
    """Reject, on either device, a ``factors=`` argument that is not
    :func:`sweep_factor`'s (or None) or was made in another pivot mode: its
    data has the same shape, and a kernel would solve wrongly from it."""
    for f in factors if isinstance(factors, tuple) else (factors,):
        if f is None:
            continue
        if not isinstance(f, BandFactor):
            raise TypeError("factors must come from sweep_factor (or "
                            f"FusedSweep), not {type(f).__name__}")
        if f.pivot != pivot:
            raise ValueError(f"a factor made with pivot={f.pivot} passed "
                             f"to a solve with pivot={pivot}")


def _factor_data(fac, name, w, D, npad, dev):
    """The data of a :func:`sweep_factor` of D (every tenant's dimensions,
    flattened) bands (npad rows) of half-width ``w``, checked for a
    launch."""
    if fac is None:
        raise ValueError(f"the launch solves with {name}: its factor is "
                         "needed, got None")
    if (fac.w, fac.n) != (w, npad):
        raise ValueError(f"{name} factor is of w = {fac.w}, n = {fac.n}; "
                         f"the operands have w = {w}, npad = {npad}")
    _build.expect(fac.data, f"{name} factor", torch.float64,
                  (D, cr_factor_size(npad // w, w)), dev)
    return fac.data


def _launch_gauss_seidel(name, phi, saphi, sort_idx, rank_idx, sigma2, v,
                         x_in, *, w_p, w_s, iters, want_k, pivot,
                         factors=None, cols=None):
    """``csrc/gauss_seidel.cu`` for ``iters`` sweeps; returns (x, k or
    None). ``factors`` is SAPhi's :func:`sweep_factor` in this pivot mode
    (None: made here, one ``cr_factor`` launch); ``cols`` the columns per
    solve item (None: :func:`gauss_seidel_cols`). A tenant stack is one
    launch, as :func:`_launch_jacobi`'s."""
    lead, D, npad, B, dev = _check_operands(phi, saphi, sort_idx, rank_idx,
                                            sigma2, (v, x_in), w_p, w_s)
    T = _tenants(lead, B)
    if factors is None:
        factors = sweep_factor(saphi, w_s, pivot=pivot)
    fac = _factor_data(factors, "SAPhi", w_s, T * D, npad, dev)
    _check_cols(cols)
    lib = _build.load_library()
    work = torch.empty((lib.repro_gauss_seidel_workspace(T, D, npad, B),),
                       dtype=torch.float64, device=dev)
    x = torch.empty_like(v)
    k = torch.empty_like(v) if want_k else None
    err = lib.repro_gauss_seidel_f64(
        phi.data_ptr(), saphi.data_ptr(), fac.data_ptr(),
        sort_idx.data_ptr(), rank_idx.data_ptr(), sigma2.data_ptr(),
        v.data_ptr(), x_in.data_ptr(), x.data_ptr(),
        None if k is None else k.data_ptr(), work.data_ptr(), T, D, npad, B,
        w_p, w_s, iters, cols or 0, int(pivot), _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(_fleet_name(name, T, w_p, w_s))
    return x, k


def _query(fn, what, *args):
    out = fn(*args)
    if out < 0:
        _build.check(-out, what)
    return out


def pcg_fleet_cols(T: int, D: int, B: int, pivot: bool = False,
                   maxw: int = NARROW_WIDTH) -> int:
    """:func:`pcg_solve_cols` of a launch over T tenants: auto_cols over the
    T D dimensions' items."""
    return _query(_build.load_library().repro_mega_pcg_cols,
                  "mega_pcg column query", T, D, B, int(pivot), maxw)


def pcg_solve_cols(D: int, B: int, pivot: bool = False,
                   maxw: int = NARROW_WIDTH) -> int:
    """Columns per (dimension, column chunk) item of the PCG kernel's
    block-CR solves when the launch leaves ``cols`` open: ``csrc/sweep.cuh``
    auto_cols, the narrowest power of two (at most B) that gives every one
    of the D ceil(B / c) items a block of the kernel's cooperative grid
    (``csrc/mega_pcg.cu``; the widths are measured in PERF.md). ``maxw``,
    here and in the queries below: the launch's widest band, which picks
    its instantiation."""
    return pcg_fleet_cols(1, D, B, pivot, maxw)


def gauss_seidel_grid(pivot: bool = False, maxw: int = NARROW_WIDTH) -> int:
    """Blocks of the Gauss-Seidel kernel's cooperative grid (at most two a
    SM, as its occupancy allows)."""
    return _query(_build.load_library().repro_gauss_seidel_grid,
                  "gauss_seidel grid query", int(pivot), maxw)


def gauss_seidel_fleet_cols(T: int, B: int, pivot: bool = False,
                            maxw: int = NARROW_WIDTH) -> int:
    """:func:`gauss_seidel_cols` of a launch over T tenants: auto_cols over
    the active dimension of every tenant."""
    return _query(_build.load_library().repro_gauss_seidel_cols,
                  "gauss_seidel column query", T, B, int(pivot), maxw)


def gauss_seidel_cols(B: int, pivot: bool = False,
                      maxw: int = NARROW_WIDTH) -> int:
    """The Gauss-Seidel kernel's items' columns when the launch leaves
    ``cols`` open: auto_cols (as :func:`pcg_solve_cols`) with D = 1, one
    dimension a step, over its grid (``csrc/gauss_seidel.cu``)."""
    return gauss_seidel_fleet_cols(1, B, pivot, maxw)


def jacobi_grid(pivot: bool = False, maxw: int = NARROW_WIDTH) -> int:
    """Blocks of the Jacobi kernel's cooperative grid (at most two a SM, as
    its occupancy allows)."""
    return _query(_build.load_library().repro_jacobi_grid,
                  "jacobi grid query", int(pivot), maxw)


def jacobi_fleet_cols(T: int, D: int, B: int, pivot: bool = False,
                      maxw: int = NARROW_WIDTH) -> int:
    """:func:`jacobi_cols` of a launch over T tenants: auto_cols over the
    T D dimensions' items."""
    return _query(_build.load_library().repro_jacobi_cols,
                  "jacobi column query", T, D, B, int(pivot), maxw)


def jacobi_cols(D: int, B: int, pivot: bool = False,
                maxw: int = NARROW_WIDTH) -> int:
    """The Jacobi kernel's items' columns when the launch leaves ``cols``
    open: auto_cols (as :func:`pcg_solve_cols`) over the D dimensions'
    items and its grid (``csrc/jacobi.cu``)."""
    return jacobi_fleet_cols(1, D, B, pivot, maxw)


def pcg_factors(phi, saphi, *, w_p: int, w_s: int, pivot: bool = False):
    """The block-CR factors the PCG kernel solves from: ``(Phi's or None
    at w_p = 0, SAPhi's)``, one :func:`sweep_factor` launch each."""
    return (sweep_factor(phi, w_p, pivot=pivot) if w_p else None,
            sweep_factor(saphi, w_s, pivot=pivot))


def _launch_pcg(name, a, phi, saphi, sort_idx, rank_idx, sigma2, v, x0,
                carry, *, w_a, w_p, w_s, iters, tol, mode, pivot,
                factors=None, cols=None):
    """``csrc/mega_pcg.cu``: a seed launch from ``(v, x0)`` (mode PCG_COLD
    or PCG_WARM) or a carry launch from ``carry = (x, r, p, rz)``, for up
    to ``iters`` iterations; returns ``(x, r, p, rz, iterations run)``.
    ``factors`` are :func:`pcg_factors` of the bands (None: made here);
    ``cols`` the columns per solve item (None: :func:`pcg_solve_cols`).
    A stack of T tenants (every operand with a leading T axis, ``sigma2``
    (T,), ``rz`` (T, 1, B)) is one launch of the same kernel, the count
    (T,); with T > 1 it counts as ``name + "_fleet"``."""
    states = (v, x0) if carry is None else carry[:3]
    lead, D, npad, B, dev = _check_operands(phi, saphi, sort_idx, rank_idx,
                                            sigma2, states, w_p, w_s)
    T = _tenants(lead, B)
    if not 0 <= w_a <= MAX_WIDTH:
        raise ValueError(f"the PCG kernel takes w_a <= {MAX_WIDTH}")
    f64 = torch.float64
    _build.expect(a, "a", f64, lead + (D, npad, 2 * w_a + 1), dev)
    if carry is None:
        x, r, p = (torch.empty_like(v) for _ in range(3))
        rz = torch.empty(lead + (1, B), dtype=f64, device=dev)
    else:
        _build.expect(carry[3], "rz", f64, lead + (1, B), dev)
        x, r, p, rz = (t.clone() for t in carry)
    if factors is None:
        factors = pcg_factors(phi, saphi, w_p=w_p, w_s=w_s, pivot=pivot)
    fac_p, fac_s = (_factor_data(fac, nm, w, T * D, npad, dev) if w else None
                    for w, fac, nm in ((w_p, factors[0], "Phi"),
                                       (w_s, factors[1], "SAPhi")))
    _check_cols(cols)
    lib = _build.load_library()
    nwork = lib.repro_mega_pcg_workspace(T, D, npad, B, int(pivot),
                                         _maxw(w_a, w_p, w_s))
    if nwork < 0:
        _build.check(int(-nwork), f"{name} workspace query")
    work = torch.empty((nwork,), dtype=f64, device=dev)
    it = torch.empty((T,), dtype=torch.int32, device=dev)
    err = lib.repro_mega_pcg_f64(
        a.data_ptr(), phi.data_ptr(), saphi.data_ptr(),
        None if fac_p is None else fac_p.data_ptr(), fac_s.data_ptr(),
        sort_idx.data_ptr(), rank_idx.data_ptr(), sigma2.data_ptr(),
        None if v is None else v.data_ptr(),
        None if x0 is None else x0.data_ptr(), x.data_ptr(), r.data_ptr(),
        p.data_ptr(), rz.data_ptr(), it.data_ptr(), work.data_ptr(), T, D,
        npad, B, w_a, w_p, w_s, iters, cols or 0, float(tol), mode,
        int(pivot), _build.stream_handle(dev))
    _build.check(err, name)
    _build.count_launch(_fleet_name(name, T, w_a, w_p, w_s))
    return x, r, p, rz, (it if lead else it[0])


def _lane_factor(f, t: int):
    """Tenant ``t``'s part of a :func:`sweep_factor` of a tenant stack."""
    if f is None:
        return None
    D = f.batch[-1]
    return BandFactor(f.data[t * D:(t + 1) * D], f.batch[1:], f.n, f.w,
                      f.pivot)


def fused_pcg_iter(a, phi, saphi, sort_idx, rank_idx, sigma2, x, r, p, rz, *,
                   w_a: int, w_p: int, w_s: int, pivot: bool = False,
                   backend: str | None = None, factors=None):
    """One PCG iteration on padded operands (bands (D, npad, 2w+1) float64,
    permutations (D, npad) int32, ``sigma2`` a 1-element float64 tensor,
    states (D, npad, B) float64, ``rz`` (1, B)); returns ``(x, r, p, rz)``.
    CUDA tensors launch ``csrc/mega_pcg.cu`` on the carried state for one
    iteration, solving from ``factors`` (:func:`pcg_factors`; None: made
    for this call; a factor of the other pivot mode raises)."""
    kw = dict(w_a=w_a, w_p=w_p, w_s=w_s, pivot=pivot)
    _check_factors(factors, pivot)
    if resolve_backend(backend, x.device) == "plain":
        return fused_pcg_iter_plain(a, phi, saphi, sort_idx, rank_idx, sigma2,
                                    x, r, p, rz, **kw)
    return _launch_pcg("fused_pcg_iter", a, phi, saphi, sort_idx, rank_idx,
                       sigma2, None, None, (x, r, p, rz), iters=1, tol=0.0,
                       mode=PCG_CARRY, factors=factors, **kw)[:4]


def pcg_seed(a, phi, saphi, sort_idx, rank_idx, sigma2, v, x0, *, w_a: int,
             w_p: int, w_s: int, warm: bool, pivot: bool = False,
             backend: str | None = None, factors=None):
    """The first launch of the per-iteration PCG loop: ``(x, r, p, rz)`` as
    :func:`pcg_seed_plain` forms them. CUDA tensors launch
    ``csrc/mega_pcg.cu``'s seed for 0 iterations (counted with
    ``fused_pcg_iter``: the path's launches are its iterations plus one)."""
    kw = dict(w_a=w_a, w_p=w_p, w_s=w_s, pivot=pivot)
    _check_factors(factors, pivot)
    if resolve_backend(backend, v.device) == "plain":
        return pcg_seed_plain(a, phi, saphi, sort_idx, rank_idx, sigma2, v,
                              x0, warm=warm, **kw)
    return _launch_pcg("fused_pcg_iter", a, phi, saphi, sort_idx, rank_idx,
                       sigma2, v, x0, None, iters=0, tol=0.0,
                       mode=PCG_WARM if warm else PCG_COLD, factors=factors,
                       **kw)[:4]


def fused_jacobi_iter(phi, saphi, sort_idx, rank_idx, sigma2, v, vt, k=None,
                      *, w_p: int, w_s: int, alpha: float,
                      pivot: bool = False, warm: bool = False,
                      backend: str | None = None, factors=None,
                      cols: int | None = None):
    """One damped block-Jacobi sweep on padded operands: bands
    (D, npad, 2w+1) float64, permutations (D, npad) int32, ``sigma2`` a
    1-element float64 tensor, states (D, npad, B) float64; or a stack of T
    tenants (each with a leading T axis, ``sigma2`` (T,)). Returns ``out``,
    or ``(out, k_out)`` when ``k`` is given or ``warm`` (k = Khat^{-1} vt
    first). CUDA tensors launch ``csrc/jacobi.cu`` for one sweep, solving
    from ``factors`` (``(Phi's or None, SAPhi's)`` :func:`sweep_factor`,
    Phi's read only when ``warm`` at w_p >= 1, as :meth:`FusedSweep.
    cr_factors` holds them; None: made for this call; another pivot mode
    raises on either device), in items of ``cols`` columns (None:
    :func:`jacobi_cols`); the plain version solves from the bands."""
    kw = dict(w_p=w_p, w_s=w_s, alpha=alpha, pivot=pivot)
    _check_factors(factors, pivot)
    if resolve_backend(backend, v.device) == "plain":
        return fused_jacobi_iter_plain(phi, saphi, sort_idx, rank_idx, sigma2,
                                       v, vt, k, warm=warm, **kw)
    kmode = K_WARM if warm else (K_NONE if k is None else K_IN)
    x, k_out = _launch_jacobi("fused_jacobi_iter", phi, saphi, sort_idx,
                              rank_idx, sigma2, v, vt,
                              None if warm else k, iters=1, kmode=kmode,
                              factors=factors, cols=cols, **kw)
    return x if k_out is None else (x, k_out)


def fused_gauss_seidel_iter(phi, saphi, sort_idx, rank_idx, sigma2, v, vt, *,
                            w_p: int, w_s: int, pivot: bool = False,
                            want_resid: bool = False,
                            backend: str | None = None, factors=None,
                            cols: int | None = None):
    """One Gauss-Seidel sweep on padded operands (as
    :func:`fused_jacobi_iter`); with ``want_resid`` returns ``(out, k)``.
    CUDA tensors launch ``csrc/gauss_seidel.cu`` for one sweep, solving
    from ``factors``, SAPhi's :func:`sweep_factor` in this pivot mode
    (None: made for this call; another pivot mode raises on either device),
    in items of ``cols`` columns (None: :func:`gauss_seidel_cols`); the
    plain version solves from the band."""
    _check_factors(factors, pivot)
    if resolve_backend(backend, v.device) == "plain":
        return fused_gauss_seidel_iter_plain(
            phi, saphi, sort_idx, rank_idx, sigma2, v, vt, w_p=w_p, w_s=w_s,
            pivot=pivot, want_resid=want_resid)
    x, k = _launch_gauss_seidel("fused_gauss_seidel_iter", phi, saphi,
                                sort_idx, rank_idx, sigma2, v, vt, w_p=w_p,
                                w_s=w_s, iters=1, want_k=want_resid,
                                pivot=pivot, factors=factors, cols=cols)
    return (x, k) if want_resid else x


class FusedSweep:
    """Padded factor stack + static widths for the backfitting kernels.

    ``phi``/``saphi``/``a`` are (D, n, 2w+1) band stacks with symmetric
    half-widths ``w_p``/``w_s``/``w_a`` (``a`` may be None: the relaxation
    sweeps never apply Khat^{-1} through A); ``sort_idx``/``rank_idx``
    (D, n) permutations; ``sigma2`` the noise variance; ``pivot`` selects
    the pivoted block solves; ``backend`` the kernels' backend. Bands get
    identity tails, permutations self-mapping tails (int32, as the kernels
    read them). The block-CR factors the CUDA kernels solve from are kept:
    Phi's and SAPhi's for PCG and a warm Jacobi start (:meth:`cr_factors`),
    SAPhi's alone for Gauss-Seidel and the Jacobi sweeps
    (:meth:`saphi_factor`). ``factors`` may hand over ``(Phi's, SAPhi's)``
    (``kernels.ops.banded_factor`` of the unpadded bands, either None, as a
    ``core.backfitting.DimOps`` holds them): each is taken where it was made
    for this pivot mode and the band's padding to whole blocks is this
    stack's ``npad``; the others are made at the first launch that needs
    them.

    ``n_active`` (0-d int32 tensor, optional) is the capacity-padded active
    length: rows in ``[n_active, n)`` get the same canonical identity tail
    as the rows in ``[n, npad)``, and states a zero tail, so the kernels see
    one uninterrupted decoupled tail.

    A tenant stack has a leading T axis on every band, permutation and
    state, ``sigma2`` and ``n_active`` (T,): every launch then takes all
    tenants at once (``csrc/mega_pcg.cu``, ``jacobi.cu``,
    ``gauss_seidel.cu``), in column chunks of at most :meth:`max_cols`.
    """

    def __init__(self, phi, saphi, sort_idx, rank_idx, sigma2, *, w_p: int,
                 w_s: int, a=None, w_a: int = 0, pivot: bool = False,
                 backend: str | None = None, factors=(None, None),
                 n_active=None):
        D, n = sort_idx.shape[-2:]
        self.lead = tuple(sort_idx.shape[:-2])
        self.D, self.n = D, n
        self.n_active = n_active
        self.w_a, self.w_p, self.w_s = w_a, w_p, w_s
        self.pivot, self.backend = pivot, backend
        self.npad = _pad_len(n, (w_p, w_s))
        self.dtype = saphi.dtype
        self.device = saphi.device
        self.phi = self._pad_band(phi, w_p)
        self.saphi = self._pad_band(saphi, w_s)
        self.a = None if a is None else self._pad_band(a, w_a)
        self.sort_idx = self._pad_idx(sort_idx)
        self.rank_idx = self._pad_idx(rank_idx)
        self.sigma2 = torch.as_tensor(sigma2, dtype=self.dtype,
                                      device=self.device).reshape(
                                          self.lead or (1,))
        self._factors = {}
        batch = self.lead + (D,)
        for name, w, f in zip(("phi", "saphi"), (w_p, w_s), factors):
            if (f is not None and (f.batch, f.n, f.w, f.pivot)
                    == (batch, n, w, pivot) and -(-n // w) * w == self.npad
                    and f.n_active is n_active):
                self._factors[name] = BandFactor(f.data, batch, self.npad, w,
                                                 pivot)

    def _pad_band(self, data, w):
        out = torch.zeros(self.lead + (self.D, self.npad, 2 * w + 1),
                          dtype=self.dtype, device=self.device)
        out[..., w] = 1.0
        out[..., :self.n, :] = canonical_band(data, w, w,
                                              self.n_active).to(self.dtype)
        return out

    def _pad_idx(self, idx):
        tail = torch.arange(self.n, self.npad, dtype=torch.int32,
                            device=self.device).expand(
                                self.lead + (self.D, -1))
        idx = canonical_perm(idx, self.n_active)
        return torch.cat([idx.to(torch.int32), tail], dim=-1).contiguous()

    def pad_state(self, u):
        """(..., D, n, B) -> (..., D, npad, B) with a zero tail."""
        k = len(self.lead)
        out = torch.zeros(self.lead + (self.D, self.npad)
                          + tuple(u.shape[k + 2:]),
                          dtype=self.dtype, device=self.device)
        out[..., :self.n, :] = mask_rows(u, self.n_active,
                                         axis=k + 1).to(self.dtype)
        return out

    def unpad(self, u):
        return u[..., :self.n, :]

    def _ops(self):
        return (self.phi, self.saphi, self.sort_idx, self.rank_idx,
                self.sigma2)

    def max_cols(self, limit: int | None = None) -> int:
        """Columns a launch takes: ``limit`` (default the kernels'
        ``MAX_B``), and on a tenant stack at most ``MAX_TB`` (tenant,
        column) pairs."""
        limit = MAX_B if limit is None else limit
        if not self.lead:
            return limit
        return max(1, min(limit, MAX_TB // self.lead[0]))

    def by_columns(self, fn, *states, step: int | None = None):
        """``fn(*states)`` over column chunks of at most ``step`` (default
        the kernels' limit :meth:`max_cols`), joined along the columns; an
        iteration count (0-d, or (T,) on a tenant stack) is taken from the
        first chunk. The columns of a sweep and of a relaxation or
        fixed-count PCG solve are independent, so the result is that of
        one call."""
        B = states[0].shape[-1]
        step = self.max_cols() if step is None else step
        if B <= step:
            return fn(*states)
        outs = [fn(*(None if s is None else s[..., c:c + step].contiguous()
                     for s in states)) for c in range(0, B, step)]
        if not isinstance(outs[0], tuple):
            return torch.cat(outs, dim=-1)
        return tuple(torch.cat(p, dim=-1) if p[0].dim() >= 2 else p[0]
                     for p in zip(*outs))

    def jacobi_iter(self, v, vt, alpha: float, k=None, warm: bool = False):
        """One sweep; pass ``k`` (or ``warm``: k = Khat^{-1} vt first) to
        also carry the residual stack: ``(out, k)``. Solves from
        :meth:`cr_factors` (Phi's only for ``warm``); column chunks share
        them."""
        fac = self.cr_factors(phi=warm)
        return self.by_columns(
            lambda v_, vt_, k_: fused_jacobi_iter(
                *self._ops(), v_, vt_, k_, w_p=self.w_p, w_s=self.w_s,
                alpha=alpha, pivot=self.pivot, warm=warm,
                backend=self.backend, factors=fac), v, vt, k)

    def gauss_seidel_iter(self, v, vt, want_resid: bool = False):
        """One sweep from :meth:`saphi_factor`; column chunks share it."""
        fac = self.saphi_factor()
        return self.by_columns(
            lambda v_, vt_: fused_gauss_seidel_iter(
                *self._ops(), v_, vt_, w_p=self.w_p, w_s=self.w_s,
                pivot=self.pivot, want_resid=want_resid,
                backend=self.backend, factors=fac), v, vt)

    def _factor(self, name):
        if name not in self._factors:
            band, w = ((self.phi, self.w_p) if name == "phi"
                       else (self.saphi, self.w_s))
            self._factors[name] = sweep_factor(band, w, pivot=self.pivot)
        return self._factors[name]

    def saphi_factor(self):
        """SAPhi's block-CR factor (:func:`sweep_factor`), the one the
        Gauss-Seidel and Jacobi kernels solve from, handed over at
        construction or made at the first call (one ``cr_factor`` launch)
        and kept: (3 nb + 2 sum_k ceil(nb / 2^{k+1})) w^2, about 5 npad w,
        doubles per dimension (12 MB at npad = 30000, D = 10, q = 0). None
        on the plain backend, which solves from the band."""
        if resolve_backend(self.backend, self.device) == "plain":
            return None
        return self._factor("saphi")

    def cr_factors(self, phi: bool = True):
        """The block-CR factors the PCG kernel (and a warm Jacobi start)
        solves from, ``(Phi's or None, SAPhi's)`` (as :func:`pcg_factors`;
        Phi's None at w_p = 0 or without ``phi``), each handed over or made
        at its first use and kept (SAPhi's is :meth:`saphi_factor`'s). None
        on the plain backend."""
        if resolve_backend(self.backend, self.device) == "plain":
            return None
        return (self._factor("phi") if phi and self.w_p else None,
                self._factor("saphi"))

    def _pcg_kw(self):
        if self.a is None:
            raise ValueError("PCG needs the A factor stack")
        return dict(w_a=self.w_a, w_p=self.w_p, w_s=self.w_s,
                    pivot=self.pivot, backend=self.backend,
                    factors=self.cr_factors())

    def pcg_seed(self, v, x0=None):
        """The PCG seed ``(x, r, p, rz)``, padded, from unpadded ``v`` and
        ``x0`` (None: a cold start), in column chunks of ``MAX_B``."""
        kw = self._pcg_kw()

        def one(v_, x0_):
            v_p = self.pad_state(v_)
            x0_p = (torch.zeros_like(v_p) if x0_ is None
                    else self.pad_state(x0_))
            return pcg_seed(self.a, *self._ops(), v_p, x0_p,
                            warm=x0_ is not None, **kw)

        return self.by_columns(one, v, x0)

    def pcg_iter(self, x, r, p, rz):
        """One PCG iteration on the padded state, in column chunks of
        ``MAX_B``; ``(x, r, p, rz)``."""
        kw = self._pcg_kw()
        return self.by_columns(
            lambda *st: fused_pcg_iter(self.a, *self._ops(), *st, **kw),
            x, r, p, rz)
