"""The port's CUDA kernels against their plain versions, on the card.

Every test needs an NVIDIA GPU and nvcc and skips without them. Run on the
card with ``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(``--noconftest``: the repository's conftest imports JAX, which the card's
machine does not need). Inputs come from numpy seeds; the kernel and its
plain version get the same CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import (GPConfig, fit, log_likelihood, mll_gradients,
                              posterior_mean, posterior_var)
from repro_torch.core.band_inverse import _to_blocks
from repro_torch.kernels import _build, ops
from repro_torch.kernels.band_matmul import band_matmul, band_matmul_plain
from repro_torch.kernels.banded_lu import (banded_lu, banded_lu_pivot,
                                           banded_lu_pivot_plain,
                                           banded_lu_plain)
from repro_torch.kernels.banded_matvec import (banded_matvec,
                                               banded_matvec_plain)
from repro_torch.core.backfitting import SolveConfig, solve_mhat
from repro_torch.kernels.block_cr import (block_cr, block_cr_apply,
                                          block_cr_apply_cols,
                                          block_cr_apply_plain,
                                          block_cr_factor,
                                          block_cr_factor_plain,
                                          block_cr_plain, pad_band)
from repro_torch.kernels.fused_sweep import (fused_gauss_seidel_iter,
                                             fused_gauss_seidel_iter_plain,
                                             fused_jacobi_iter,
                                             fused_jacobi_iter_plain,
                                             fused_pcg_iter,
                                             fused_pcg_iter_plain,
                                             gauss_seidel_cols,
                                             gauss_seidel_grid, jacobi_cols,
                                             jacobi_grid, pcg_factors,
                                             pcg_seed,
                                             pcg_seed_plain, pcg_solve_cols,
                                             sweep_backward_error,
                                             sweep_factor)
from repro_torch.core.kernel_packets import kp_factors
from repro_torch.kernels.kp_gram import (kp_gram, kp_gram_plain,
                                        kp_gram_table_plain)
from repro_torch.precond import kmg_preconditioner
from repro_torch.kernels.mega_solve import (MegaSolve, mega_gauss_seidel_plain,
                                            mega_gauss_seidel_solve,
                                            mega_jacobi_plain,
                                            mega_jacobi_solve, mega_pcg_plain,
                                            mega_pcg_solve)
from repro_torch.kernels.rgf import (rgf_blocks, rgf_blocks_cr_plain,
                                     rgf_blocks_plain, rgf_tile_rows)
from torch_port_inputs import (band, dim_ops, fleet_operands,
                               padded_operands, points,
                               solve_operands)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (2, 2), (1, 2)])
def test_banded_lu_kernel(dev, lo, hi):
    rng = np.random.default_rng(1)
    bd = torch.as_tensor(band(rng, 3, 300, lo, hi), device=dev)
    rhs = torch.as_tensor(rng.standard_normal((3, 300, 5)), device=dev)
    x, ld = banded_lu(bd, rhs, lo, hi)
    xr, ldr = banded_lu_plain(bd, rhs, lo, hi)
    assert _rel(x, xr) < 1e-12 and _rel(ld, ldr) < 1e-12


@pytest.mark.parametrize("widths", [(1, 1, 0, 0), (2, 2, 1, 1)])
def test_band_matmul_kernel(dev, widths):
    rng = np.random.default_rng(2)
    a_lo, a_hi, b_lo, b_hi = widths
    a = torch.as_tensor(band(rng, 4, 257, a_lo, a_hi), device=dev)
    b = torch.as_tensor(band(rng, 4, 257, b_lo, b_hi), device=dev)
    assert _rel(band_matmul(a, b, *widths), band_matmul_plain(a, b, *widths)) < 1e-14


def test_band_matmul_path_shape(dev):
    """At the path's widths, A (1, 1) times Phi^T (0, 0), every output is
    one product, so the kernel and the plain version agree bit for bit."""
    rng = np.random.default_rng(6)
    a = torch.as_tensor(band(rng, 10, 30000, 1, 1), device=dev)
    b = torch.as_tensor(band(rng, 10, 30000, 0, 0), device=dev)
    assert torch.equal(band_matmul(a, b, 1, 1, 0, 0),
                       band_matmul_plain(a, b, 1, 1, 0, 0))


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("T", [1, 2, 3, 37, "tiles"])
def test_rgf_kernel(dev, w, T):
    """The kernel's block-CR order against the RGF order (1e-10, the
    reference's bar) and against its plain twin ``rgf_blocks_cr_plain``
    (1e-12: the same order; only the w x w inverses' rounding and the
    card's fused multiply-adds differ). "tiles": two tiles and a part of
    a third, so the tile edges and the top levels run."""
    T = 2 * rgf_tile_rows(w) + 5 if T == "tiles" else T
    rng = np.random.default_rng(3)
    data = torch.as_tensor(band(rng, 3, T * w, w, w), device=dev)
    blocks = [t.contiguous() for t in _to_blocks(data, w, w, w)]
    out = rgf_blocks(*blocks)
    for k, p in zip(out, rgf_blocks_plain(*blocks)):
        assert _rel(k, p) < 1e-10
    for k, p in zip(out, rgf_blocks_cr_plain(*blocks)):
        assert _rel(k, p) < 1e-12
    assert not out[1][:, -1].any() and not out[2][:, -1].any()


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("warm", [False, True])
def test_mega_pcg_kernel(dev, q, B, warm):
    rng = np.random.default_rng(4)
    ops = solve_operands(rng, 131, 3, q)
    fs, v, x0 = padded_operands(ops, dev, B, rng)
    v_p, x0_p = fs.pad_state(torch.as_tensor(v)), fs.pad_state(torch.as_tensor(x0))
    if not warm:
        x0_p = torch.zeros_like(v_p)
    args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p, x0_p)
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=25, warm=warm)
    # r is updated recursively (r -= alpha A p, |alpha A p| >> |r| once
    # converged), so its rounding is judged against the right-hand side's
    # scale; the kernel's and the plain version's summation orders leave
    # ~5e-9 of |v| there on the card
    scale = float(v_p.abs().max())
    x, r, it = mega_pcg_solve(*args, **kw)
    xr, rr, itr = mega_pcg_plain(*args, **kw)
    assert _rel(x, xr) < 1e-9 and int(it) == int(itr) == 25
    assert float((r - rr).abs().max()) / scale < 1e-7
    x, r, it = mega_pcg_solve(*args, tol=1e-8, **kw)
    xr, rr, itr = mega_pcg_plain(*args, tol=1e-8, **kw)
    assert int(it) == int(itr) and _rel(x, xr) < 1e-9


def test_gp_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    n, D = 700, 3
    X = points(rng, n, D)
    Y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    Xq = rng.uniform(0, 4, (40, D))
    cfg = GPConfig(q=0, solver_iters=40, precond="none")
    omega = np.full(D, 2.0)
    _build.reset_launch_counts()
    g = fit(cfg, X, Y, omega, 0.5)
    mu, var = posterior_mean(g, Xq), posterior_var(g, Xq)
    counts = _build.launch_counts()
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    assert _rel(mu, posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(var, posterior_var(c, Xq, device="cpu")) < 1e-7
    serving = ("banded_lu", "band_matmul", "rgf_blocks", "mega_pcg")
    assert all(counts[k] > 0 for k in serving), counts


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (2, 2), (1, 2), (3, 3),
                                   (8, 8)])
def test_banded_matvec_kernel(dev, lo, hi):
    rng = np.random.default_rng(6)
    bd = torch.as_tensor(band(rng, 3, 301, lo, hi), device=dev)
    x = torch.as_tensor(rng.standard_normal((3, 301, 7)), device=dev)
    assert _rel(banded_matvec(bd, x, lo, hi),
                banded_matvec_plain(bd, x, lo, hi)) < 1e-13
    # the vector form through ops (a trailing axis of one column)
    y = ops.banded_matvec(bd, x[..., 0], lo, hi)
    assert y.shape == (3, 301)
    assert _rel(y, banded_matvec_plain(bd, x, lo, hi)[..., 0]) < 1e-13


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [8, 301])
@pytest.mark.parametrize("pivot", [False, True])
def test_block_cr_kernel(dev, w, n, pivot):
    rng = np.random.default_rng(7)
    bd = torch.as_tensor(band(rng, 3, n, w, w), device=dev)
    rhs = torch.as_tensor(rng.standard_normal((3, n, 5)), device=dev)
    x, ld = block_cr(bd, rhs, w, pivot=pivot)
    xr, ldr = block_cr_plain(bd, rhs, w, pivot=pivot)
    assert _rel(x, xr) < 1e-12 and _rel(ld, ldr) < 1e-12
    x0, ld0 = block_cr(bd, rhs, w, pivot=pivot, solve=False)
    assert x0 is None and _rel(ld0, ldr) < 1e-12


@pytest.mark.parametrize("B", [160, 300])
def test_mega_pcg_column_chunks(dev, B):
    """More than MAX_B = 256 columns: fixed-count solves run in chunks; a
    tol-exit solve runs its chunks in lockstep under one exit (a seed and
    one per-iteration launch per chunk and iteration) and takes the plain
    version's iterations."""
    rng = np.random.default_rng(8)
    ops_np = solve_operands(rng, 131, 3, 0)
    fs, v, _ = padded_operands(ops_np, dev, B, rng)
    v_t = torch.as_tensor(v, device=dev)
    _build.reset_launch_counts()
    x, r, it = MegaSolve(fs).pcg(v_t, None, iters=25, tol=0.0)
    assert _build.launch_counts()["mega_pcg"] == -(-B // 256)
    args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2,
            fs.pad_state(v_t), torch.zeros_like(fs.pad_state(v_t)))
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s)
    xr, rr, itr = mega_pcg_plain(*args, iters=25, **kw)
    assert x.shape == v_t.shape and int(it) == int(itr) == 25
    assert _rel(x, fs.unpad(xr)) < 1e-9
    _build.reset_launch_counts()
    # tol 1e-4 exits after ~24 iterations; from ~30 on, this small system
    # amplifies any rounding difference (a 1e-15 change of v moves x by
    # 1e-7 at tol 1e-6, plain against plain)
    x, r, it = MegaSolve(fs).pcg(v_t, None, iters=100, tol=1e-4)
    counts = _build.launch_counts()
    xr, rr, itr = mega_pcg_plain(*args, iters=100, tol=1e-4, **kw)
    assert int(it) == int(itr) < 100 and _rel(x, fs.unpad(xr)) < 1e-9
    chunks = -(-B // 256)
    if B > 256:
        assert counts["mega_pcg"] == 0
        assert counts["fused_pcg_iter"] == chunks * (int(it) + 1), counts
    else:
        assert counts["mega_pcg"] == 1


def _gp_data(rng, n, D):
    X = points(rng, n, D)
    Y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, Y, rng.uniform(0, 4, (40, D))


def test_likelihood_and_gradients_card_match_cpu(dev):
    """Same probes on the card and the CPU (one CPU generator seed)."""
    rng = np.random.default_rng(9)
    X, Y, _ = _gp_data(rng, 700, 3)
    cfg = GPConfig(q=0, solver_iters=40, precond="none")
    omega = np.full(3, 2.0)
    _build.reset_launch_counts()
    g = fit(cfg, X, Y, omega, 0.5)
    ll, vd = log_likelihood(g, torch.Generator().manual_seed(0),
                            return_verdict=True)
    go, gs, info = mll_gradients(g, torch.Generator().manual_seed(1),
                                 return_info=True)
    counts = _build.launch_counts()
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    llc = log_likelihood(c, torch.Generator().manual_seed(0))
    goc, gsc = mll_gradients(c, torch.Generator().manual_seed(1))
    assert int(vd) == 0 and int(info.verdict) == 0
    assert _rel(ll, llc) < 1e-7
    assert _rel(go, goc) < 1e-7 and _rel(gs, gsc) < 1e-7
    learning = ("banded_lu", "band_matmul", "rgf_blocks", "mega_pcg",
                "banded_matvec", "cr_factor", "cr_apply")
    assert all(counts[k] > 0 for k in learning), counts


def test_q1_card_matches_cpu(dev):
    rng = np.random.default_rng(10)
    X, Y, Xq = _gp_data(rng, 500, 3)
    cfg = GPConfig(q=1, solver_iters=60, precond="none")
    omega = np.full(3, 4.0)
    g = fit(cfg, X, Y, omega, 0.5)
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    assert _rel(posterior_mean(g, Xq), posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(posterior_var(g, Xq), posterior_var(c, Xq, device="cpu")) < 1e-7
    assert _rel(log_likelihood(g, torch.Generator().manual_seed(2)),
                log_likelihood(c, torch.Generator().manual_seed(2))) < 1e-7


def test_q2_card_matches_cpu(dev):
    """q = 2 on a jittered grid with omega * spacing = 0.1, where the KP
    windows are well conditioned (ROADMAP Queue 3)."""
    rng = np.random.default_rng(11)
    n, D = 400, 3
    span = 0.1 * n / 4.0
    X = points(rng, n, D, span=span)
    Y = np.sin(X * 6.0 * np.pi / span).sum(1) + 0.1 * rng.standard_normal(n)
    Xq = rng.uniform(0, span, (40, D))
    cfg = GPConfig(q=2, solver_iters=60, precond="none")
    omega = np.full(D, 4.0)
    _build.reset_launch_counts()
    g = fit(cfg, X, Y, omega, 0.5)
    mu, var = posterior_mean(g, Xq), posterior_var(g, Xq)
    counts = _build.launch_counts()
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    assert _rel(mu, posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(var, posterior_var(c, Xq, device="cpu")) < 1e-7
    assert counts["rgf_blocks"] > 0 and counts["mega_pcg"] > 0, counts
    go, gs = mll_gradients(g, torch.Generator().manual_seed(3))
    goc, gsc = mll_gradients(c, torch.Generator().manual_seed(3))
    assert _rel(go, goc) < 1e-7 and _rel(gs, gsc) < 1e-7


def test_bayesopt_card_matches_cpu(dev):
    """Bayesian optimisation on the card: the acquisition value and
    gradient (UCB, EI) and the mean's gradient within 1e-7 of the CPU's at
    q = 0 (Phi^T by banded_lu) and q = 1 (by block CR); one propose_next
    stays in bounds; the dense cache's acq_local equals the operator path
    within 1e-8."""
    from repro_torch.core import bayesopt as bo, posterior_mean_grad

    rng = np.random.default_rng(15)
    n, D = 131, 3
    X, Y, Xq = _gp_data(rng, n, D)
    best = float(Y.max())
    for q in (0, 1):
        cfg = GPConfig(q=q, solver_iters=60, precond="none")
        g = fit(cfg, X, Y, np.full(D, 4.0), 0.5)
        c = fit(cfg, X, Y, np.full(D, 4.0), 0.5, device="cpu")
        _build.reset_launch_counts()
        for kind in ("ucb", "ei"):
            got = bo.acquisition_value_and_grad(g, Xq, 2.0, best, kind=kind)
            want = bo.acquisition_value_and_grad(c, Xq, 2.0, best, kind=kind,
                                                 device="cpu")
            assert all(_rel(a, b) < 1e-7 for a, b in zip(got, want))
        counts = _build.launch_counts()
        # 40 queries: two variance chunks (of 32 and 8) a call
        assert counts["mega_pcg"] == 4 and counts[
            "banded_lu" if q == 0 else "cr_apply"] > 0, counts
        assert _rel(posterior_mean_grad(g, Xq),
                    posterior_mean_grad(c, Xq, device="cpu")) < 1e-7
    cfg = bo.BOConfig(ascent_steps=5, n_starts=8, incremental=False,
                      use_engine=False)
    b = torch.tensor([[0.0, 4.0]] * D, dtype=torch.float64, device=dev)
    x = bo.propose_next(g, b, torch.Generator().manual_seed(0), cfg, best)
    assert x.shape == (D,) and bool(((x >= 0) & (x <= 4)).all())
    cache = bo.build_local_cache(g)
    vo, go = bo.acquisition_value_and_grad(g, Xq[:3], 2.0, best)
    for i in range(3):
        v, gr = bo.acq_local(g, cache, Xq[i], 2.0, best)
        assert _rel(v, vo[i]) < 1e-8 and _rel(gr, go[i]) < 1e-8


def _backward_err(band, x, rhs, w):
    """Normwise backward error |M x - r| / (|M| |x| + |r|), max norms."""
    res = banded_matvec_plain(band, x, w, w) - rhs
    return float(res.abs().max() / (band.abs().sum(-1).max() * x.abs().max()
                                    + rhs.abs().max()))


def _refit_on(gp, dev):
    """``gp``'s fit redone on ``dev`` from its own KP factors: the DimOps
    (block-CR factors), the mean solve and the variance band on ``dev``;
    only the factor assembly's SVDs are left out (two LAPACK builds' q = 3
    null vectors differ, ROADMAP Queue 3)."""
    import dataclasses

    from repro_torch.core.additive_gp import posterior_caches
    from repro_torch.core.backfitting import DimOps
    from repro_torch.core.banded import Banded

    def band(b):
        return Banded(b.data.to(dev), b.lo, b.hi)

    o = gp.ops
    ops = DimOps(band(o.A), band(o.Phi), band(o.SAPhi), o.sort_idx.to(dev),
                 o.rank_idx.to(dev), o.sigma2.to(dev),
                 pivot=gp.config.pivot, alg=gp.config.solve_alg)
    u_sy, bY, Gband, Hband = posterior_caches(gp.config, ops, gp.Y.to(dev))
    return dataclasses.replace(
        gp, X=gp.X.to(dev), Y=gp.Y.to(dev), omega=gp.omega.to(dev),
        sigma=gp.sigma.to(dev), xs=gp.xs.to(dev), ops=ops, B=band(gp.B),
        Psi=band(gp.Psi), bY=bY, u_sy=u_sy, Gband=Gband, Hband=Hband,
        health=None)


def test_q3_on_card_runs(dev):
    """q = 3 (Matern-7/2) on the card, unfused (``fused="off"``): block CR
    at w = 3, 4 and 5, rgf at w = 7. On a jittered grid with omega * spacing = 0.2, the card's fit
    redone from the CPU fit's KP factors gives mean, variance and
    log-likelihood within 1e-7 of the CPU's (the factors themselves come
    from batched SVDs whose q = 3 null vectors differ between the card's
    and the CPU's LAPACK, ROADMAP Queue 3); the gradients, through the
    generalized-KP B (w = 5), are gated by the block-CR kernels' backward
    error on that B against the plain version's. The spacing is twice the
    q = 2 test's: at 0.1, cond(H = A Phi^T) reaches ~3e10 at q = 3, and
    two exact float64 algorithms (RGF and a dense inverse, both on the CPU)
    give variances 2e-6 apart; at 0.2 cond(H) is ~1e8, as at q = 2."""
    rng = np.random.default_rng(12)
    n, D = 400, 3
    span = 0.2 * n / 4.0
    X = points(rng, n, D, span=span)
    Y = np.sin(X * 6.0 * np.pi / span).sum(1) + 0.1 * rng.standard_normal(n)
    Xq = rng.uniform(0, span, (40, D))
    cfg = GPConfig(q=3, solver_iters=60, precond="none", fused="off")
    omega = np.full(D, 4.0)
    _build.reset_launch_counts()
    g = fit(cfg, X, Y, omega, 0.5)
    mu, var = posterior_mean(g, Xq), posterior_var(g, Xq)
    counts = _build.launch_counts()
    assert g.config.fused == "off" and g.B.lo == 5 and g.Hband.lo == 7
    assert bool(torch.isfinite(torch.cat([mu, var])).all())
    assert all(counts[k] > 0 for k in ("rgf_blocks", "cr_factor", "cr_apply",
                                       "banded_matvec", "band_matmul"))
    assert counts["mega_pcg"] == counts["mega_pcg_w4"] == 0, counts
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    s = _refit_on(c, dev)
    assert _rel(posterior_mean(s, Xq), posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(posterior_var(s, Xq), posterior_var(c, Xq, device="cpu")) < 1e-7
    assert _rel(log_likelihood(s, torch.Generator().manual_seed(2)),
                log_likelihood(c, torch.Generator().manual_seed(2))) < 1e-7
    vs = torch.as_tensor(rng.standard_normal((D, n, 4)))
    rhs = banded_matvec_plain(c.Psi.data, vs, c.Psi.lo, c.Psi.hi)
    xk, _ = block_cr(c.B.data.to(dev), rhs.to(dev), 5)
    xp, _ = block_cr_plain(c.B.data, rhs, 5)
    eps = float(torch.finfo(torch.float64).eps)
    assert _backward_err(c.B.data, xk.cpu(), rhs, 5) <= 10 * max(
        _backward_err(c.B.data, xp, rhs, 5), eps)
    go, gs = mll_gradients(s, torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(go).all()) and bool(torch.isfinite(gs))


def test_w4_kernels(dev):
    """The backfitting kernels' half-width-4 instantiations (q = 3: A and
    SAPhi w = 4, Phi w = 3) against their plain versions, both pivot modes,
    B = 1 and 5: the PCG seed, one carried iteration and the whole solve;
    one Jacobi sweep (no k, k carried, warm) and the whole warm solve; one
    Gauss-Seidel sweep (with and without k) and the whole solve. Each
    launch counts under its "_w4" name and none under the narrow one. Then
    ``solve_mhat`` with fused "on" against "whole", bit for bit, for every
    solver. At n = 37 (omega * spacing = 0.43) cond(SAPhi) is ~1e4 (at
    n = 61 it is ~3e5, and the seed's three chained solves differ from the
    plain version's by 1.6e-10 there), so the kernel's other rounding is
    held to 1e-10, as ``_tol`` holds q = 2; the whole PCG, whose summation
    orders differ, to 1e-8 after 12 iterations (relative residual 3e-3;
    past that this small system's CG amplifies rounding: a 1e-14 change
    of v moves x by 4e-13 at 12 iterations and 6e-9 at 20, plain version
    on the CPU)."""
    rng = np.random.default_rng(14)
    n = 37
    ops_np = solve_operands(rng, n, 3, 3)
    assert (ops_np["w_a"], ops_np["w_p"], ops_np["w_s"]) == (4, 3, 4)
    for pivot in (False, True):
        for B in (1, 5):
            fs, v, x0 = padded_operands(ops_np, dev, B, rng)
            v, x0 = (fs.pad_state(torch.as_tensor(t)) for t in (v, x0))
            k = fs.pad_state(torch.as_tensor(
                0.1 * rng.standard_normal((3, n, B))))
            ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
            pops = (fs.a,) + ops
            kw = dict(w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)
            pkw = dict(kw, w_a=fs.w_a)
            _build.reset_launch_counts()
            for warm in (False, True):
                start = x0 if warm else torch.zeros_like(v)
                got = pcg_seed(*pops, v, start, warm=warm, **pkw)
                _close(got, pcg_seed_plain(*pops, v, start, warm=warm,
                                           **pkw), 1e-10)
                _close(fused_pcg_iter(*pops, *got, **pkw)[::2],
                       fused_pcg_iter_plain(*pops, *got, **pkw)[::2], 1e-10)
                _close(mega_pcg_solve(*pops, v, start, iters=12, warm=warm,
                                      **pkw)[0],
                       mega_pcg_plain(*pops, v, start, iters=12, warm=warm,
                                      **pkw)[0], 1e-8)
            for extra in ({}, {"k": k}, {"warm": True}):
                _close(fused_jacobi_iter(*ops, v, x0, alpha=0.4, **extra,
                                         **kw),
                       fused_jacobi_iter_plain(*ops, v, x0, alpha=0.4,
                                               **extra, **kw), 1e-10)
            _close(mega_jacobi_solve(*ops, v, x0, alpha=1 / 3, iters=12,
                                     warm=True, **kw),
                   mega_jacobi_plain(*ops, v, x0, alpha=1 / 3, iters=12,
                                     warm=True, **kw), 1e-10)
            for want in (False, True):
                _close(fused_gauss_seidel_iter(*ops, v, x0, want_resid=want,
                                               **kw),
                       fused_gauss_seidel_iter_plain(*ops, v, x0,
                                                     want_resid=want, **kw),
                       1e-10)
            _close(mega_gauss_seidel_solve(*ops, v, x0, iters=12, **kw),
                   mega_gauss_seidel_plain(*ops, v, x0, iters=12, **kw),
                   1e-10)
            counts = _build.launch_counts()
            assert counts["mega_pcg_w4"] == 2 and counts["mega_jacobi_w4"] \
                == counts["mega_gauss_seidel_w4"] == 1, counts
            assert counts["fused_pcg_iter_w4"] == 4 and counts[
                "fused_jacobi_iter_w4"] == 3 and counts[
                "fused_gauss_seidel_iter_w4"] == 2, counts
            assert not any(counts[n] for n in (
                "mega_pcg", "fused_pcg_iter", "mega_jacobi",
                "fused_jacobi_iter", "mega_gauss_seidel",
                "fused_gauss_seidel_iter")), counts
    dops = dim_ops(ops_np, dev)
    v = torch.as_tensor(rng.standard_normal((3, n, 4)), device=dev)
    for method in ("pcg", "jacobi", "gauss_seidel"):
        for x0 in (None, 0.5 * v):
            outs = [solve_mhat(dops, v, SolveConfig(method=method, iters=9,
                                                    fused=f, tol=t),
                               x0=x0, return_info=True)
                    for f, t in (("whole", 0.0), ("on", 0.0))]
            (xw, iw), (xo, io) = outs
            assert torch.equal(xw, xo) and torch.equal(iw.resid, io.resid)


# ---------------------------------------------------------------------------
# the relaxation solvers: one-sweep and whole-solve kernels
# ---------------------------------------------------------------------------


def _relax_case(dev, q, B, seed=12, n=131):
    rng = np.random.default_rng(seed)
    ops_np = solve_operands(rng, n, 3, q)
    fs, v, x0 = padded_operands(ops_np, dev, B, rng)
    v_p = fs.pad_state(torch.as_tensor(v))
    x0_p = fs.pad_state(torch.as_tensor(x0))
    k_p = fs.pad_state(torch.as_tensor(0.1 * rng.standard_normal(v.shape)))
    ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    return fs, ops, v_p, x0_p, k_p


def _tol(q):
    """Kernel vs plain bar of a relaxation solve: 1e-12 at q <= 1; at q = 2
    the SAPhi systems of these inputs (w = 3) are ill-conditioned enough
    that the plain block CR's own pivoted and unpivoted modes differ by more
    than 1e-12, so the kernel's different rounding (fused multiply-adds) is
    held to 1e-10 (``test_sweep_backward_error`` is the second witness)."""
    return 1e-12 if q <= 1 else 1e-10


def _close(got, want, tol=1e-12):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _rel(a, b) < tol


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("pivot", [False, True])
def test_sweep_kernels(dev, q, B, pivot):
    """One Jacobi sweep (no k, k carried, warm k) and one Gauss-Seidel
    sweep (with and without k) against their plain versions."""
    fs, ops, v, x0, k = _relax_case(dev, q, B)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)
    for extra in ({}, {"k": k}, {"warm": True}):
        _close(fused_jacobi_iter(*ops, v, x0, alpha=0.4, **extra, **kw),
               fused_jacobi_iter_plain(*ops, v, x0, alpha=0.4, **extra, **kw),
               _tol(q))
    for want in (False, True):
        _close(fused_gauss_seidel_iter(*ops, v, x0, want_resid=want, **kw),
               fused_gauss_seidel_iter_plain(*ops, v, x0, want_resid=want,
                                             **kw), _tol(q))


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("pivot", [False, True])
def test_sweep_backward_error(dev, q, pivot):
    """A witness to ``_tol`` that does not rest on conditioning: one
    undamped sweep's SAPhi solves have a backward error within 10x the
    plain version's."""
    fs, ops, v, x0, _ = _relax_case(dev, q, 5)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s)
    eps = torch.finfo(torch.float64).eps
    for seq, kern, plain in (
            (False, lambda: fused_jacobi_iter(*ops, v, x0, alpha=1.0,
                                              pivot=pivot, **kw),
             lambda: fused_jacobi_iter_plain(*ops, v, x0, alpha=1.0,
                                             pivot=pivot, **kw)),
            (True, lambda: fused_gauss_seidel_iter(*ops, v, x0, pivot=pivot,
                                                   **kw),
             lambda: fused_gauss_seidel_iter_plain(*ops, v, x0, pivot=pivot,
                                                   **kw))):
        be_k, be_p = (sweep_backward_error(*ops, v, x0, f(), sequential=seq,
                                           **kw) for f in (kern, plain))
        assert be_k <= 10 * max(be_p, eps), (be_k, be_p)


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("warm", [False, True])
def test_whole_relaxation_kernels(dev, q, B, warm):
    """The whole Jacobi and Gauss-Seidel solves against their
    plain versions, 12 sweeps."""
    fs, ops, v, x0, _ = _relax_case(dev, q, B)
    x0 = x0 if warm else torch.zeros_like(v)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, iters=12)
    _close(mega_jacobi_solve(*ops, v, x0, alpha=1 / 3, warm=warm, **kw),
           mega_jacobi_plain(*ops, v, x0, alpha=1 / 3, warm=warm, **kw),
           _tol(q))
    _close(mega_gauss_seidel_solve(*ops, v, x0, **kw),
           mega_gauss_seidel_plain(*ops, v, x0, **kw), _tol(q))


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("pivot", [False, True])
def test_gauss_seidel_from_held_factor(dev, q, pivot):
    """The Gauss-Seidel sweep (with and without k) and whole solve given
    SAPhi's factor, at every chunk width, equal the calls that make the
    factor themselves, bit for bit (the apply replays the elimination's
    right-hand-side expressions; a column's arithmetic does not depend on
    its item); one factor launch per call without ``factors``, none with."""
    fs, ops, v, x0, _ = _relax_case(dev, q, 16)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)
    fac = sweep_factor(fs.saphi, fs.w_s, pivot=pivot)
    _build.reset_launch_counts()
    ref_sweep = {want: fused_gauss_seidel_iter(*ops, v, x0, want_resid=want,
                                               **kw)
                 for want in (False, True)}
    ref_whole = mega_gauss_seidel_solve(*ops, v, x0, iters=6, **kw)
    assert _build.launch_counts()["cr_factor"] == 3
    _build.reset_launch_counts()
    for cols in (None, 1, 2, 4, 8):
        for want in (False, True):
            got = fused_gauss_seidel_iter(*ops, v, x0, want_resid=want,
                                          factors=fac, cols=cols, **kw)
            got = got if want else (got,)
            ref = ref_sweep[want] if want else (ref_sweep[want],)
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), cols
        got = mega_gauss_seidel_solve(*ops, v, x0, iters=6, factors=fac,
                                      cols=cols, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref_whole)), cols
    assert _build.launch_counts()["cr_factor"] == 0


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("B,cols", [(5, 2), (5, 4), (7, 3), (7, 4)])
@pytest.mark.parametrize("pivot", [False, True])
def test_gauss_seidel_short_last_chunk(dev, q, B, cols, pivot):
    """Chunk widths that do not divide B, so the last chunk of t1's
    column-chunked layout is narrower (sweep.cuh chunk_col, apply_cols'
    nc < cpc branch): the sweep (with and without k) and the whole solve
    against their plain versions, and bit for bit the one-column items'
    results. q = 0 runs the fused w_p = 0 phase, q = 1 the gathered one."""
    fs, ops, v, x0, _ = _relax_case(dev, q, B)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)
    fac = sweep_factor(fs.saphi, fs.w_s, pivot=pivot)
    for want in (False, True):
        got = fused_gauss_seidel_iter(*ops, v, x0, want_resid=want,
                                      factors=fac, cols=cols, **kw)
        _close(got, fused_gauss_seidel_iter_plain(*ops, v, x0,
                                                  want_resid=want, **kw),
               _tol(q))
        one = fused_gauss_seidel_iter(*ops, v, x0, want_resid=want,
                                      factors=fac, cols=1, **kw)
        got, one = ((got, one) if want else ((got,), (one,)))
        assert all(torch.equal(a, b) for a, b in zip(got, one))
    got = mega_gauss_seidel_solve(*ops, v, x0, iters=12, factors=fac,
                                  cols=cols, **kw)
    _close(got, mega_gauss_seidel_plain(*ops, v, x0, iters=12, **kw),
           _tol(q))
    one = mega_gauss_seidel_solve(*ops, v, x0, iters=12, factors=fac, cols=1,
                                  **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("pivot", [False, True])
def test_jacobi_from_held_factors(dev, q, pivot):
    """The Jacobi sweep (no k, k carried, warm) and whole solve (cold,
    warm) given ``FusedSweep.cr_factors``, at every chunk width, equal the
    calls that make the factors themselves, bit for bit (the apply replays
    the elimination's right-hand-side expressions; a column's arithmetic
    does not depend on its item); without ``factors`` a call makes SAPhi's
    and, warm at w_p >= 1, Phi's (one cr_factor launch each), with them
    none."""
    fs, ops, v, x0, k = _relax_case(dev, q, 16)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, alpha=0.4, pivot=pivot)
    calls = {
        "none": lambda **c: fused_jacobi_iter(*ops, v, x0, **kw, **c),
        "k": lambda **c: fused_jacobi_iter(*ops, v, x0, k, **kw, **c),
        "warm": lambda **c: fused_jacobi_iter(*ops, v, x0, warm=True, **kw,
                                              **c),
        "whole": lambda **c: mega_jacobi_solve(
            *ops, v, torch.zeros_like(v), iters=6, **kw, **c),
        "whole warm": lambda **c: mega_jacobi_solve(
            *ops, v, x0, iters=6, warm=True, **kw, **c),
    }
    _build.reset_launch_counts()
    ref = {name: call() for name, call in calls.items()}
    assert _build.launch_counts()["cr_factor"] == 5 + 2 * (fs.w_p > 0)
    fac = pcg_factors(fs.phi, fs.saphi, w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)
    _build.reset_launch_counts()
    for cols in (None, 1, 2, 4, 8):
        for name, call in calls.items():
            got = call(factors=fac, cols=cols)
            want = ref[name]
            got, want = ((got, want) if isinstance(got, tuple)
                         else ((got,), (want,)))
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                name, cols)
    assert _build.launch_counts()["cr_factor"] == 0


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("B,cols", [(5, 2), (5, 4), (7, 3), (7, 4)])
@pytest.mark.parametrize("pivot", [False, True])
def test_jacobi_short_last_chunk(dev, q, B, cols, pivot):
    """Chunk widths that do not divide B, so the last chunk of t1's
    column-chunked layout is narrower: the warm sweep and the warm whole
    solve against their plain versions, and bit for bit the one-column
    items' results. q = 0 runs the fused w_p = 0 phase, q = 1 the gathered
    one and Phi's factor."""
    fs, ops, v, x0, _ = _relax_case(dev, q, B)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, alpha=0.4, pivot=pivot, warm=True)
    fac = pcg_factors(fs.phi, fs.saphi, w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)
    for fn, plain, extra in (
            (fused_jacobi_iter, fused_jacobi_iter_plain, {}),
            (mega_jacobi_solve, mega_jacobi_plain, {"iters": 12})):
        got = fn(*ops, v, x0, factors=fac, cols=cols, **kw, **extra)
        _close(got, plain(*ops, v, x0, **kw, **extra), _tol(q))
        one = fn(*ops, v, x0, factors=fac, cols=1, **kw, **extra)
        assert all(torch.equal(a, b) for a, b in zip(got, one))


# (B, Gauss-Seidel's columns an item, PCG's and Jacobi's at D = 10) on a
# cooperative grid of one block a SM, 132 on the H100 SXM (PERF.md: the
# widths measured)
_H100_WIDTHS = [(1, 1, 1), (16, 1, 2), (32, 1, 4), (160, 2, 16),
                (256, 2, 32)]


def test_solve_chunk_widths(dev):
    """The sweep kernels' own chunk rule (sweep.cuh auto_cols: the narrowest
    power of two giving every (dimension, chunk) item a block) as their
    queries report it on the H100: the three kernels' grids are one block a
    SM (gs_kernel's and jacobi_kernel's registers, mega_pcg's pinned
    grid)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms != 132:
        pytest.skip(f"the widths are those of a 132-SM grid, not {sms}")
    for pivot in (False, True):
        assert gauss_seidel_grid(pivot) == sms
        assert jacobi_grid(pivot) == sms
        for B, gs, pcg in _H100_WIDTHS:
            assert gauss_seidel_cols(B, pivot) == gs, B
            assert pcg_solve_cols(10, B, pivot) == pcg, B
            assert jacobi_cols(10, B, pivot) == pcg, B


@pytest.mark.parametrize("method", ["jacobi", "gauss_seidel"])
@pytest.mark.parametrize("warm", [False, True])
def test_whole_equals_host_loop_bitwise(dev, method, warm):
    """fused="whole" (one launch) and fused="on" (one launch per sweep) give
    the same bits, the exit residual included. The solves take SAPhi's
    factor from the DimOps (made once, before the counts); at n = 131, q = 1
    Phi's (w = 1) covers 131 rows where the sweep pads to 132, so a warm
    Jacobi solve, which solves with Phi, makes Phi's once per solve (one
    cr_factor launch, not one a sweep)."""
    rng = np.random.default_rng(13)
    dops = dim_ops(solve_operands(rng, 131, 3, 1), dev)
    v = torch.as_tensor(rng.standard_normal((3, 131, 4)), device=dev)
    x0 = 0.5 * v if warm else None
    outs = {}
    for fused in ("whole", "on"):
        _build.reset_launch_counts()
        outs[fused] = solve_mhat(dops, v, SolveConfig(method=method, iters=9,
                                                      fused=fused),
                                 x0=x0, return_info=True)
        counts = _build.launch_counts()
        name = ("mega_" if fused == "whole" else "fused_") + (
            "jacobi" if method == "jacobi" else "gauss_seidel")
        name += "" if fused == "whole" else "_iter"
        assert counts[name] == (1 if fused == "whole" else 9), counts
        assert counts["cr_factor"] == (method == "jacobi" and warm), counts
    (xw, iw), (xh, ih) = outs["whole"], outs["on"]
    assert torch.equal(xw, xh) and torch.equal(iw.resid, ih.resid)


@pytest.mark.parametrize("method", ["jacobi", "gauss_seidel"])
def test_relaxation_column_split(dev, method):
    """More than MAX_B = 256 columns: the whole solve runs as two launches
    that share one SAPhi factor launch, and matches the plain version
    taking all columns at once."""
    fs, ops, _, _, _ = _relax_case(dev, 0, 1)
    rng = np.random.default_rng(14)
    v = torch.as_tensor(rng.standard_normal((3, fs.n, 300)), device=dev)
    _build.reset_launch_counts()
    if method == "jacobi":
        x, k = MegaSolve(fs).jacobi(v, None, alpha=1 / 3, iters=10)
        xr, kr = mega_jacobi_plain(*ops, fs.pad_state(v),
                                   torch.zeros_like(fs.pad_state(v)),
                                   w_p=fs.w_p, w_s=fs.w_s, alpha=1 / 3,
                                   iters=10)
    else:
        x, k = MegaSolve(fs).gauss_seidel(v, None, iters=10)
        xr, kr = mega_gauss_seidel_plain(*ops, fs.pad_state(v),
                                         torch.zeros_like(fs.pad_state(v)),
                                         w_p=fs.w_p, w_s=fs.w_s, iters=10)
    counts = _build.launch_counts()
    assert counts[f"mega_{method}"] == 2, counts
    assert sum(counts.values()) == 3 and counts["cr_factor"] == 1, counts
    assert _rel(x, fs.unpad(xr)) < 1e-12 and _rel(k, fs.unpad(kr)) < 1e-12


@pytest.mark.parametrize("solver", ["jacobi", "gauss_seidel"])
@pytest.mark.parametrize("fused", ["auto", "on", "off"])
def test_relaxation_gp_card_matches_cpu(dev, solver, fused):
    rng = np.random.default_rng(15)
    X, Y, Xq = _gp_data(rng, 500, 3)
    cfg = GPConfig(q=0, solver=solver, fused=fused, solver_iters=30,
                   precond="none")
    omega = np.full(3, 2.0)
    g = fit(cfg, X, Y, omega, 0.5)
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    assert g.config.fused == ("whole" if fused == "auto" else fused)
    assert _rel(posterior_mean(g, Xq), posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(posterior_var(g, Xq), posterior_var(c, Xq, device="cpu")) < 1e-7
    assert int(g.health.verdict) == int(c.health.verdict)


def test_mega_pcg_pivot_kernel(dev):
    """The pivoted whole PCG against its plain version, run to convergence:
    midway (25 iterations here) CG amplifies rounding so far that the plain
    version's pivoted and unpivoted modes differ by 2e-8 on the CPU."""
    rng = np.random.default_rng(16)
    fs, v, _ = padded_operands(solve_operands(rng, 131, 3, 1), dev, 4, rng)
    v_p = fs.pad_state(torch.as_tensor(v))
    args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p,
            torch.zeros_like(v_p))
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=60, pivot=True)
    x, _, it = mega_pcg_solve(*args, **kw)
    xr, _, itr = mega_pcg_plain(*args, **kw)
    assert _rel(x, xr) < 1e-9 and int(it) == int(itr) == 60


def test_banded_lu_pivot_kernel(dev):
    """The pivoted banded LU kernel against its plain version on the same
    CUDA tensors, one launch a call, on bands whose scaled rows (and zero
    leading diagonal, where lo, hi >= 1) force swaps: x within 1e-12 (the
    kernel rounds each product and difference as the plain version does),
    the log-determinant within 1e-12; the factor-only call gives the same
    log-determinant; ``ops`` and ``core.banded.solve`` reach the kernel.
    The shapes (lo, hi, n, B) run as a loop in this one test: B = 130 is
    more columns than the block's 128 threads, n = 5 < lo + 1 starts with
    rows past n."""
    from repro_torch.core.banded import Banded, solve

    rng = np.random.default_rng(70)
    for lo, hi, n, B in [(1, 1, 300, 1), (1, 1, 300, 32), (2, 2, 300, 5),
                         (2, 1, 300, 130), (1, 2, 257, 40), (0, 2, 300, 3),
                         (2, 0, 300, 3), (3, 3, 300, 16), (4, 4, 200, 8),
                         (7, 7, 200, 53), (8, 8, 200, 53), (8, 8, 5, 2)]:
        bd = band(rng, 3, n, lo, hi)
        bd *= np.where(np.arange(n) % 2 == 1, 50.0, 1.0)[None, :, None]
        if lo and hi:
            bd[:, 0, lo] = 0.0
        bd = torch.as_tensor(bd, device=dev)
        rhs = torch.as_tensor(rng.standard_normal((3, n, B)), device=dev)
        _build.reset_launch_counts()
        x, ld = banded_lu_pivot(bd, rhs, lo, hi)
        _, ldo = banded_lu_pivot(bd, None, lo, hi, solve=False)
        assert _build.launch_counts()["banded_lu_pivot"] == 2
        xr, ldr = banded_lu_pivot_plain(bd, rhs, lo, hi)
        assert _rel(x, xr) < 1e-12, (lo, hi, n, B)
        assert _rel(ld, ldr) < 1e-12 and torch.equal(ld, ldo), (lo, hi)
        if lo == 0:
            continue
        _build.reset_launch_counts()
        xo = ops.banded_solve(bd, rhs, lo, hi, pivot=True, alg="lu")
        ldd = ops.banded_logdet(bd, lo, hi, pivot=True, alg="lu")
        assert torch.equal(xo, x) and torch.equal(ldd, ld)
        if lo != hi:  # solve's defaults: pivot=True, alg "auto" -> "lu"
            assert torch.equal(solve(Banded(bd, lo, hi), rhs), x)
        assert _build.launch_counts()["banded_lu_pivot"] == (
            2 if lo == hi else 3)


# banded_lu at lo = hi = 0 (one launch) and the factored block CR of the
# whole-solve PCG kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 3, 4, 16, 32, 160])
@pytest.mark.parametrize("n", [37, 30000])
@pytest.mark.parametrize("G", [1, 10])
def test_banded_lu_diag_kernel(dev, B, n, G):
    """One launch a call; x within 1e-14 of the plain rhs / d (one IEEE
    division each, so in practice the same bits), the log-determinant
    within 1e-12 and with the same bits in a second call (fixed-order
    partial sums, no float atomics); the solve-only and log-det-only calls
    give the same halves. n = 37 leaves a ragged last tile; odd B takes the
    single-double path, even B the double2 path."""
    rng = np.random.default_rng(30 + B + G)
    bd = torch.as_tensor(band(rng, G, n, 0, 0), device=dev)
    rhs = torch.as_tensor(rng.standard_normal((G, n, B)), device=dev)
    _build.reset_launch_counts()
    x, ld = banded_lu(bd, rhs, 0, 0)
    assert _build.launch_counts()["banded_lu"] == 1
    xr, ldr = banded_lu_plain(bd, rhs, 0, 0)
    assert _rel(x, xr) < 1e-14 and _rel(ld, ldr) < 1e-12
    x2, ld2 = banded_lu(bd, rhs, 0, 0)
    assert torch.equal(x, x2) and torch.equal(ld, ld2)
    xs, none = banded_lu(bd, rhs, 0, 0, logdet=False)
    none2, ldo = banded_lu(bd, None, 0, 0, solve=False)
    assert none is None and none2 is None and torch.equal(xs, x)
    assert _rel(ldo, ldr) < 1e-12
    assert torch.equal(ldo, banded_lu(bd, None, 0, 0, solve=False)[1])


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("nb", [1, 8, 37])
@pytest.mark.parametrize("pivot", [False, True])
def test_cr_factor_kernel(dev, w, nb, pivot):
    """The block-CR factor kernel against its plain twin (the coefficients
    and final blocks of the elimination), one launch for the G bands."""
    rng = np.random.default_rng(40 + 5 * w + nb)
    bd = torch.as_tensor(band(rng, 3, nb * w, w, w), device=dev)
    _build.reset_launch_counts()
    fac = block_cr_factor(bd, w, pivot=pivot)
    assert _build.launch_counts()["cr_factor"] == 1
    want = block_cr_factor_plain(bd, w, pivot=pivot)
    assert fac.shape == want.shape and _rel(fac, want) < 1e-12


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("pivot", [False, True])
def test_cr_apply_kernel(dev, w, pivot):
    """The apply kernel against its plain twin on the same factor (G = 3,
    n = 301 padded to whole blocks, B = 5); the factor's log-determinant
    against the plain version's; every chunk width gives the same bits
    (each column's arithmetic does not depend on its item); a factor plus
    apply is one launch each."""
    rng = np.random.default_rng(60 + 3 * w + pivot)
    bd = pad_band(torch.as_tensor(band(rng, 3, 301, w, w), device=dev), w)
    rhs = torch.as_tensor(rng.standard_normal((3, bd.shape[1], 5)),
                          device=dev)
    _build.reset_launch_counts()
    fac, ld = block_cr_factor(bd, w, pivot=pivot, logdet=True)
    x = block_cr_apply(fac, rhs, w, pivot=pivot)
    counts = _build.launch_counts()
    assert counts["cr_factor"] == 1 and counts["cr_apply"] == 1, counts
    facp, ldp = block_cr_factor_plain(bd, w, pivot=pivot, logdet=True)
    assert _rel(block_cr_apply_plain(fac, rhs, w, pivot=pivot), x) < 1e-12
    assert _rel(x, block_cr_plain(bd, rhs, w, pivot=pivot)[0]) < 1e-12
    assert _rel(ld, ldp) < 1e-12
    assert 1 <= block_cr_apply_cols(3, 5) <= 5
    for cols in (1, 2, 4, 5):
        assert torch.equal(block_cr_apply(fac, rhs, w, pivot=pivot,
                                          cols=cols), x), cols


@pytest.mark.parametrize("q", [0, 1])
def test_mega_pcg_same_bits(dev, q):
    """Two launches give the same bits, and so does every chunk width of
    the factored solves (the columns are independent) and a factor made
    once and passed in; one factor launch per band when it is made in the
    call."""
    rng = np.random.default_rng(18 + q)
    fs, v, _ = padded_operands(solve_operands(rng, 131, 3, q), dev, 5, rng)
    v_p = fs.pad_state(torch.as_tensor(v))
    args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p,
            torch.zeros_like(v_p))
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=25, tol=1e-10)
    _build.reset_launch_counts()
    first = mega_pcg_solve(*args, **kw)
    assert _build.launch_counts()["cr_factor"] == (2 if fs.w_p else 1)
    for cols in (None, 1, 2, 4, 8):
        out = mega_pcg_solve(*args, factors=fs.cr_factors(), cols=cols, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, out)), cols


# the per-iteration PCG kernel, kp_gram, kmg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("pivot", [False, True])
def test_pcg_iter_kernel(dev, q, B, pivot):
    """The PCG seed (cold and warm) and one carried iteration against their
    plain versions on the same state; the updated r at the scale of the
    residual it updates (it cancels: |alpha A p| >> |r|)."""
    fs, _, v, x0, _ = _relax_case(dev, q, B)
    ops = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)
    for warm in (False, True):
        start = x0 if warm else torch.zeros_like(v)
        got = pcg_seed(*ops, v, start, warm=warm, **kw)
        _close(got, pcg_seed_plain(*ops, v, start, warm=warm, **kw), _tol(q))
    out = fused_pcg_iter(*ops, *got, **kw)
    want = fused_pcg_iter_plain(*ops, *got, **kw)
    scale = float(got[1].abs().max())
    _close((out[0], out[2], out[3]), (want[0], want[2], want[3]), _tol(q))
    assert float((out[1] - want[1]).abs().max()) / scale < _tol(q)


@pytest.mark.parametrize("warm,tol", [(False, 0.0), (False, 1e-9),
                                      (True, 1e-9)])
def test_pcg_on_equals_whole_bitwise(dev, warm, tol):
    """fused="on" (a seed launch, then one launch per iteration with the
    tol exit on the host) and fused="whole" (one launch) give the same
    bits: x, the exit residual and the iteration count."""
    rng = np.random.default_rng(17)
    dops = dim_ops(solve_operands(rng, 131, 3, 1), dev)
    v = torch.as_tensor(rng.standard_normal((3, 131, 4)), device=dev)
    x0 = 0.5 * v if warm else None
    outs = {}
    for fused in ("whole", "on"):
        _build.reset_launch_counts()
        outs[fused] = solve_mhat(dops, v, SolveConfig(iters=40, tol=tol,
                                                      fused=fused),
                                 x0=x0, return_info=True)
        outs[fused + " counts"] = _build.launch_counts()
    (xw, iw), (xh, ih) = outs["whole"], outs["on"]
    assert torch.equal(xw, xh) and torch.equal(iw.resid, ih.resid)
    assert int(iw.iters) == int(ih.iters) and (tol == 0 or int(iw.iters) < 40)
    assert outs["whole counts"]["mega_pcg"] == 1
    assert outs["on counts"]["fused_pcg_iter"] == int(ih.iters) + 1
    assert outs["on counts"]["mega_pcg"] == 0


@pytest.mark.parametrize("q", [0, 1, 2, 3])
def test_kp_gram_kernel(dev, q):
    """kp_gram against its plain twin in the kernel's order
    (kp_gram_table_plain), its plain version and the fit's Phi band
    (kp_factors) on a jittered grid, at n = 1, 2, 2q+3, 127-129, 255-257
    and 1000: fewer rows than the window, the window, and one row either
    side of the 128- and 256-row edges. Phi = A K cancels by design, so the
    bar is relative to the summed terms' scale, max_i sum_t |A[i, t]|
    (|k| <= 1): one ulp of exp reads far above 1e-12 of |Phi| at q = 2."""
    for n in (1, 2, 2 * q + 3, 127, 128, 129, 255, 256, 257, 1000):
        rng = np.random.default_rng(18 + n)
        xs = torch.as_tensor(np.sort(points(rng, n, 1)[:, 0]), device=dev)
        A, Phi = kp_factors(q, torch.tensor(4.0, dtype=torch.float64,
                                            device=dev), xs)
        a = A.data.contiguous()
        _build.reset_launch_counts()
        got = kp_gram(q, 4.0, xs, a)
        assert _build.launch_counts()["kp_gram"] == 1, n
        assert got.shape == (n, 2 * q + 1)
        terms = float(a.abs().sum(-1).max())
        for want in (kp_gram_table_plain(q, 4.0, xs, a),
                     kp_gram_plain(q, 4.0, xs, a), Phi.data):
            assert float((got - want).abs().max()) / terms < 1e-12, n


def _faults(dev, which):
    """(call, operand name, {fault: (operand, message)}) of a wrapper whose
    second operand is on the CPU, float32, of a wrong shape or not
    contiguous: each raises in the wrapper's checks, before any launch."""
    rng = np.random.default_rng(23)
    n, q = 300, 1
    xs = torch.as_tensor(np.sort(points(rng, n, 1)[:, 0]), device=dev)
    good = {
        "kp_gram": torch.as_tensor(rng.standard_normal((n, 2 * q + 3)),
                                   device=dev),
        "banded_matvec": torch.as_tensor(rng.standard_normal((2, n, 4)),
                                         device=dev),
        "band_matmul": torch.as_tensor(rng.standard_normal((2, n, 3)),
                                       device=dev)}[which]
    bad = {"cpu": (good.cpu(), "on cpu, expected cuda"),
           "float32": (good.float(), "dtype torch.float32, expected "
                                     "torch.float64"),
           "shape": (good[..., :-1, :].contiguous(), "shape"),
           "layout": (good.transpose(-1, -2).contiguous().transpose(-1, -2),
                      "not contiguous")}
    band = torch.as_tensor(rng.standard_normal((2, n, 3)), device=dev)
    calls = {
        "kp_gram": lambda t: kp_gram(q, 4.0, xs, t),
        "banded_matvec": lambda t: banded_matvec(band, t, 1, 1),
        "band_matmul": lambda t: band_matmul(band, t, 1, 1, 1, 1)}
    name = {"kp_gram": "a_band", "banded_matvec": "x",
            "band_matmul": "b_band"}[which]
    return calls[which], name, bad


@pytest.mark.parametrize("which", ["kp_gram", "banded_matvec",
                                   "band_matmul"])
def test_wrapper_errors(dev, which):
    """The wrappers' checks (``_build.expect``) raise the same ValueError as
    before for a CPU tensor, a float32 tensor, a wrong shape or a
    non-contiguous operand, and launch nothing."""
    call, name, bad = _faults(dev, which)
    _build.reset_launch_counts()
    for fault, (t, msg) in bad.items():
        with pytest.raises(ValueError, match=f"^{name}: .*{msg}"):
            call(t)
    assert sum(_build.launch_counts().values()) == 0


def test_kp_gram_wrapper_errors(dev):
    """kp_gram's own refusals: q above the kernel's MAX_Q, and
    backend="cuda" on CPU tensors."""
    rng = np.random.default_rng(24)
    xs = torch.as_tensor(np.sort(points(rng, 50, 1)[:, 0]))
    with pytest.raises(ValueError, match="0 <= q <= 3"):
        kp_gram(4, 4.0, xs.to(dev), torch.zeros((50, 11), device=dev,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA"):
        kp_gram(0, 4.0, xs, torch.zeros((50, 3), dtype=torch.float64),
                backend="cuda")


def _kmg_gp(dev, n=900):
    rng = np.random.default_rng(19)
    X, Y, Xq = _gp_data(rng, n, 3)
    cfg = GPConfig(q=0, solver_iters=40, precond="kmg")
    return cfg, X, Y, Xq


def test_kmg_vcycle_deterministic(dev):
    """The V-cycle on the card: the same bits on a second run (restriction
    gathers in a fixed order, no atomics), within 1e-10 of the CPU's on the
    same factors, through the block_cr, banded_lu and banded_matvec
    kernels."""
    cfg, X, Y, _ = _kmg_gp(dev)
    g = fit(cfg, X, Y, np.full(3, 2.0), 0.5)
    c = fit(cfg, X, Y, np.full(3, 2.0), 0.5, device="cpu")
    r = torch.as_tensor(np.random.default_rng(20).standard_normal(
        (3, X.shape[0], 4)))
    _build.reset_launch_counts()
    pre = kmg_preconditioner(g.ops, g.hier)
    z1, z2 = pre(r.to(dev)), pre(r.to(dev))
    counts = _build.launch_counts()
    assert torch.equal(z1, z2)
    assert all(counts[k] > 0 for k in ("cr_apply", "banded_lu",
                                       "banded_matvec")), counts
    assert _rel(z1, kmg_preconditioner(c.ops, c.hier)(r)) < 1e-10


def test_kmg_gp_card_matches_cpu(dev):
    cfg, X, Y, Xq = _kmg_gp(dev)
    _build.reset_launch_counts()
    g = fit(cfg, X, Y, np.full(3, 2.0), 0.5)
    mu, var = posterior_mean(g, Xq), posterior_var(g, Xq)
    counts = _build.launch_counts()
    c = fit(cfg, X, Y, np.full(3, 2.0), 0.5, device="cpu")
    assert g.config.fused == "off" and g.hier is not None
    assert _rel(mu, posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(var, posterior_var(c, Xq, device="cpu")) < 1e-7
    assert counts["mega_pcg"] == 0 and counts["cr_apply"] > 0, counts


def test_pcg_on_gp_card_matches_cpu(dev):
    rng = np.random.default_rng(21)
    X, Y, Xq = _gp_data(rng, 500, 3)
    cfg = GPConfig(q=0, fused="on", solver_iters=30, precond="none")
    g = fit(cfg, X, Y, np.full(3, 2.0), 0.5)
    c = fit(cfg, X, Y, np.full(3, 2.0), 0.5, device="cpu")
    assert g.config.fused == "on"
    assert _rel(posterior_mean(g, Xq), posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(posterior_var(g, Xq), posterior_var(c, Xq, device="cpu")) < 1e-7


def test_wide_block_cr_kernels(dev):
    """The wide instantiations (w = 6, 7, 8: the streaming Woodbury patch
    solves at q = 2, 3) against block_cr_plain, pivoted and not, launched
    under their own names; w = 5 still takes the narrow kernels."""
    rng = np.random.default_rng(23)
    for w in (5, 6, 7, 8):
        for n in (8, 301):
            for pivot in (False, True):
                bd = torch.as_tensor(band(rng, 3, n, w, w), device=dev)
                rhs = torch.as_tensor(rng.standard_normal((3, n, 5)),
                                      device=dev)
                _build.reset_launch_counts()
                x, ld = block_cr(bd, rhs, w, pivot=pivot)
                c = _build.launch_counts()
                xr, ldr = block_cr_plain(bd, rhs, w, pivot=pivot)
                assert _rel(x, xr) < 1e-12 and _rel(ld, ldr) < 1e-12
                wide = (c["cr_factor_wide"], c["cr_apply_wide"])
                narrow = (c["cr_factor"], c["cr_apply"])
                assert (wide, narrow) == (((1, 1), (0, 0)) if w > 5
                                          else ((0, 0), (1, 1))), c


def test_padded_stream_card_matches_cpu(dev):
    """One insert and one evict of a capacity-padded GP on the card against
    the CPU from the same carried state (the CPU fit's arrays rebuilt on
    the card), at q = 0 and q = 2 (whose insert patch solve runs the w = 6
    block CR)."""
    from repro_torch import streaming as st
    from repro_torch.core import gp_from_arrays

    rng = np.random.default_rng(24)
    n, D, cap = 300, 3, 512
    # grid spacing 0.5 / omega: there the q = 2 windowed band agrees with
    # the full recompute to ~1e-13 (at 0.1 / omega the Woodbury window
    # solves are ill-conditioned and the reference's own windowed band
    # parts from its full recompute by ~3e-6)
    span = 0.5 * (n + 1) / 4.0
    X = points(rng, n + 1, D, span=span)
    Y = np.sin(6.0 * np.pi * X / span).sum(1) + 0.1 * rng.standard_normal(
        n + 1)
    Xq = rng.uniform(0, span, (20, D))
    for q in (0, 2):
        cfg = GPConfig(q=q, solver_iters=60, precond="none")
        c = fit(cfg, X[:n], Y[:n], np.full(D, 4.0), 0.5, device="cpu",
                capacity=cap)
        bands = dict(A=c.ops.A, Phi=c.ops.Phi, SAPhi=c.ops.SAPhi, B=c.B,
                     Psi=c.Psi, Gband=c.Gband, Hband=c.Hband)
        arrays = {k: getattr(c, k).numpy() for k in
                  ("X", "Y", "omega", "sigma", "xs", "bY", "u_sy")}
        arrays.update(sort_idx=c.ops.sort_idx.numpy(),
                      rank_idx=c.ops.rank_idx.numpy(),
                      n_active=c.n_active.numpy())
        for k, b in bands.items():
            arrays[k], arrays[f"{k}_lo"], arrays[f"{k}_hi"] = (
                b.data.numpy(), b.lo, b.hi)
        g = gp_from_arrays(arrays, c.config, dev)
        _build.reset_launch_counts()
        g = st.evict(st.insert(g, X[n], Y[n], count=n), count=n + 1)
        counts = _build.launch_counts()
        c = st.evict(st.insert(c, X[n], Y[n], count=n), count=n + 1)
        gaps = (_rel(posterior_mean(g, Xq), posterior_mean(c, Xq,
                                                           device="cpu")),
                _rel(posterior_var(g, Xq), posterior_var(c, Xq,
                                                         device="cpu")),
                _rel(g.Gband.data[:, :n], c.Gband.data[:, :n]))
        assert max(gaps) < 1e-7, (q, gaps)
        if q == 2:
            assert counts["cr_factor_wide"] and counts["cr_apply_wide"]


def test_fleet_pcg_kernel(dev):
    """The PCG kernel's tenant axis (``csrc/mega_pcg.cu`` over T systems),
    as loops in one test: T = 1 and 3 tenants, q = 0, 1 (the MAXW 3
    instantiation) and q = 3 (MAXW 4), B = 1 and 4, cold and warm. The
    whole solve (tol 0 and a tol exit, each tenant exiting on its own
    columns) and the seed plus one carried iteration against the plain
    versions (tenant by tenant): x within 1e-7 and the recursive residual r
    within 1e-6 of |v| (the PCG iterations amplify the two summation orders
    by the systems' conditioning, as in ``chip_smoke.py``'s mega_pcg rows),
    the seed and one iteration within 1e-9. With the tol exit a tenant's
    count may differ from the plain version's by one (the iteration whose
    rz lands on the threshold), and its x is then held to the plain solve
    run to the kernel's own count. Every lane against its own one-system
    launch within 1e-12 and the tol exit's count exactly. T > 1 launches
    count as ``mega_pcg_fleet`` (and "_w4"), T = 1 as ``mega_pcg``. Every
    failing comparison is reported at once."""
    rng = np.random.default_rng(23)
    bad = []

    def check(case, what, val, bar):
        if not val <= bar:
            bad.append((case, what, val, bar))

    for T in (1, 3):
        for q in (0, 1, 3):
            n = 37 if q == 3 else 131
            iters = 12 if q == 3 else 25
            for B in (1, 4):
                fs, v, x0, opss = fleet_operands(rng, T, n, 3, q, dev, B)
                v_p = fs.pad_state(torch.as_tensor(v).to(dev))
                x0_p = fs.pad_state(torch.as_tensor(x0).to(dev))
                scale = float(v_p.abs().max())
                for warm in (False, True):
                    case = (T, q, B, warm)
                    x0w = x0_p if warm else torch.zeros_like(v_p)
                    args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx,
                            fs.sigma2, v_p, x0w)
                    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s,
                              iters=iters, warm=warm)
                    _build.reset_launch_counts()
                    x, r, it = mega_pcg_solve(*args, **kw)
                    name = ("mega_pcg" + ("_fleet" if T > 1 else "")
                            + ("_w4" if q == 3 else ""))
                    check(case, "launches " + name,
                          abs(_build.launch_counts()[name] - 1), 0)
                    xr, rr, itr = mega_pcg_plain(*args, **kw)
                    check(case, "iterations", int(
                        (it.cpu() != iters).sum() + (itr.cpu() != iters).sum()),
                        0)
                    check(case, "x vs plain", _rel(x, xr), 1e-7)
                    check(case, "r vs plain at |v|",
                          float((r - rr).abs().max()) / scale, 1e-6)
                    # a tol exit: each tenant stops on its own columns, as
                    # its own launch does (the iteration a rz crosses the
                    # threshold can move by one against the plain version's
                    # summation order when it lands on the threshold)
                    xt, _, itt = mega_pcg_solve(*args, tol=1e-6, **kw)
                    xr, _, itr = mega_pcg_plain(*args, tol=1e-6, **kw)
                    check(case, "tol-exit iterations vs plain",
                          int((itt.cpu() - itr.cpu()).abs().max()), 1)
                    for t in range(T):
                        want = xr[t]
                        if int(itt[t]) != int(itr[t]):
                            want = mega_pcg_plain(*args, **dict(
                                kw, iters=int(itt[t])))[0][t]
                        check(case, f"tol-exit lane {t} x vs plain",
                              _rel(xt[t], want), 1e-7)
                    for t in range(T):
                        fs1, _, _ = padded_operands(opss[t], dev, B, rng)
                        one = (fs1.a, fs1.phi, fs1.saphi, fs1.sort_idx,
                               fs1.rank_idx, fs1.sigma2, v_p[t], x0w[t])
                        x1, r1, _ = mega_pcg_solve(*one, **kw)
                        check(case, f"lane {t} vs single",
                              max(_rel(x[t], x1), _rel(r[t], r1)), 1e-12)
                        x1, _, it1 = mega_pcg_solve(*one, tol=1e-6, **kw)
                        check(case, f"tol-exit lane {t} vs single",
                              _rel(xt[t], x1) + abs(int(itt[t]) - int(it1)),
                              1e-12)
                    # the seed and one carried iteration
                    fk = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s)
                    st = pcg_seed(*args, warm=warm, **fk)
                    sr = pcg_seed_plain(*args, warm=warm, **fk)
                    check(case, "seed", max(_rel(a_, b_)
                                            for a_, b_ in zip(st, sr)), 1e-9)
                    st1 = fused_pcg_iter(*args[:6], *st, **fk)
                    sr1 = fused_pcg_iter_plain(*args[:6], *st, **fk)
                    check(case, "one iteration", max(
                        _rel(a_, b_) for a_, b_ in zip(st1, sr1)), 1e-9)
    assert not bad, bad


def test_fleet_relaxation_kernels(dev):
    """The relaxation kernels' tenant axis (``csrc/jacobi.cu``,
    ``csrc/gauss_seidel.cu`` over T systems), as loops in one test: T = 1
    and 3 tenants, q = 0, 1 (the MAXW 3 instantiation) and q = 3 (MAXW 4),
    B = 1 and 5. One sweep (Jacobi with k carried and warm, Gauss-Seidel
    with k) and the whole solve (12 sweeps, cold and warm) against the
    plain versions (tenant by tenant) at ``_tol(q)``; every lane equal bit
    for bit to its own one-system launch; T > 1 launches counted as
    ``*_fleet`` (and "_w4"), T = 1 as the single names. Every failing
    comparison is reported at once."""
    rng = np.random.default_rng(29)
    bad = []

    def check(case, what, ok):
        if not ok:
            bad.append((case, what))

    for T in (1, 3):
        for q in (0, 1, 3):
            n = 37 if q == 3 else 131
            for B in (1, 5):
                fs, v, x0, opss = fleet_operands(rng, T, n, 3, q, dev, B)
                v_p = fs.pad_state(torch.as_tensor(v).to(dev))
                x0_p = fs.pad_state(torch.as_tensor(x0).to(dev))
                k_p = 0.1 * x0_p
                ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
                kw = dict(w_p=fs.w_p, w_s=fs.w_s)
                tol = 1e-10 if q >= 2 else 1e-12
                singles = [padded_operands(opss[t], dev, B, rng)[0]
                           for t in range(T)]
                one = [(f.phi, f.saphi, f.sort_idx, f.rank_idx, f.sigma2)
                       for f in singles]
                calls = {
                    "fused_jacobi_iter": (
                        lambda o, s: fused_jacobi_iter(
                            *o, v_p[s], x0_p[s], k_p[s], alpha=0.4, **kw),
                        lambda o, s: fused_jacobi_iter_plain(
                            *o, v_p[s], x0_p[s], k_p[s], alpha=0.4, **kw)),
                    "fused_jacobi_iter warm": (
                        lambda o, s: fused_jacobi_iter(
                            *o, v_p[s], x0_p[s], alpha=0.4, warm=True, **kw),
                        lambda o, s: fused_jacobi_iter_plain(
                            *o, v_p[s], x0_p[s], alpha=0.4, warm=True, **kw)),
                    "fused_gauss_seidel_iter": (
                        lambda o, s: fused_gauss_seidel_iter(
                            *o, v_p[s], x0_p[s], want_resid=True, **kw),
                        lambda o, s: fused_gauss_seidel_iter_plain(
                            *o, v_p[s], x0_p[s], want_resid=True, **kw)),
                    "mega_jacobi": (
                        lambda o, s: mega_jacobi_solve(
                            *o, v_p[s], x0_p[s], alpha=1 / 3, warm=True,
                            iters=12, **kw),
                        lambda o, s: mega_jacobi_plain(
                            *o, v_p[s], x0_p[s], alpha=1 / 3, warm=True,
                            iters=12, **kw)),
                    "mega_jacobi cold": (
                        lambda o, s: mega_jacobi_solve(
                            *o, v_p[s], torch.zeros_like(v_p[s]),
                            alpha=1 / 3, iters=12, **kw),
                        lambda o, s: mega_jacobi_plain(
                            *o, v_p[s], torch.zeros_like(v_p[s]),
                            alpha=1 / 3, iters=12, **kw)),
                    "mega_gauss_seidel": (
                        lambda o, s: mega_gauss_seidel_solve(
                            *o, v_p[s], x0_p[s], iters=12, **kw),
                        lambda o, s: mega_gauss_seidel_plain(
                            *o, v_p[s], x0_p[s], iters=12, **kw)),
                }
                every = slice(None)
                for name, (kern, plain) in calls.items():
                    case = (T, q, B, name)
                    _build.reset_launch_counts()
                    got = kern(ops, every)
                    counted = (name.split()[0] + ("_fleet" if T > 1 else "")
                               + ("_w4" if q == 3 else ""))
                    check(case, "launches " + counted,
                          _build.launch_counts()[counted] == 1)
                    got = got if isinstance(got, tuple) else (got,)
                    want = plain(ops, every)
                    want = want if isinstance(want, tuple) else (want,)
                    check(case, "vs plain", max(
                        _rel(a, b) for a, b in zip(got, want)) < tol)
                    for t in range(T):
                        lane = kern(one[t], t)
                        lane = lane if isinstance(lane, tuple) else (lane,)
                        check(case, f"lane {t} bitwise", all(
                            torch.equal(a[t], b) for a, b in zip(got, lane)))
    assert not bad, bad



def test_health_ladder_card_matches_cpu(dev, tmp_path):
    """The health ladder on the card against the same repairs on the CPU
    (pcg "whole", n = 500, capacity 512), every fault a case of the loop:
    the same detection verdict, the same trail rung for rung (every rung
    re-solves on the card; none moves the GP to the CPU), the repaired mean
    and variance within 1e-7 of the CPU's. A checkpoint of the card GP
    restores to the card, bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.health import (iteration_cap, ladder, nan_active_row,
                                    near_singular_band, probe_gp, repair)

    rng = np.random.default_rng(31)
    X, Y, Xq = _gp_data(rng, 500, 3)
    cfg = GPConfig(q=0, solver_iters=40, precond="none")
    g = fit(cfg, X, Y, np.full(3, 2.0), 0.5, capacity=512)
    c = fit(cfg, X, Y, np.full(3, 2.0), 0.5, device="cpu", capacity=512)
    assert g.config.fused == c.config.fused == "whole"
    faults = {"iteration_cap": lambda gp: iteration_cap(gp, iters=1),
              "nan_active_row": lambda gp: nan_active_row(gp, row=3),
              "near_singular_band": lambda gp: iteration_cap(
                  near_singular_band(gp, row=1), iters=40)}
    for name, inject in faults.items():
        bg, bc = inject(g), inject(c)
        # a near-singular row's verdict is rounding-determined (any non-OK)
        assert probe_gp(bg) != 0 and probe_gp(bc) != 0, name
        assert name == "near_singular_band" or probe_gp(bg) == probe_gp(bc)
        (fg, eg), (fc, ec) = repair(bg), repair(bc)
        assert [e.rung for e in eg] == [e.rung for e in ec], name
        assert probe_gp(fg) == probe_gp(fc) == 0, name
        assert fg.device.type == "cuda" and fg.num_points() == fc.num_points()
        assert _rel(posterior_mean(fg, Xq), posterior_mean(
            fc, Xq, device="cpu")) < 1e-7, name
        assert _rel(posterior_var(fg, Xq), posterior_var(
            fc, Xq, device="cpu")) < 1e-7, name
    assert not ladder._applies("backend_jax", g)
    ck = Checkpointer(str(tmp_path))
    ck.save(0, g, blocking=True)
    r, _ = ck.restore(g)
    assert r.u_sy.device.type == "cuda"
    assert torch.equal(posterior_var(r, Xq), posterior_var(g, Xq))
