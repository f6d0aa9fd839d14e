"""The port's capacity-padded GP against its unpadded self and the JAX
package, on the CPU.

* Padded vs unpadded inside the port (``fit(capacity=)``): the fit's
  caches (A, Phi, B, u_sy, bY, Gband, xs) and the posterior mean bit for
  bit, the variance within 1e-12, the likelihood within 1e-12 relative and
  the gradients within 1e-11 (both from the row-keyed probe draw, so the
  padded GP sees the unpadded GP's probes on the active prefix): the
  reference's own bars (``tests/test_capacity.py``). The acquisition, the
  dense local cache and ``propose_next`` keep the unpadded results too.
* Poisoned tails (NaN floats, huge ints in every padding slot) leave every
  active result's bits unchanged, an insert and an evict included.
* The port's padded fit against the JAX package's padded fit in one tiny
  Pallas-interpret case (the "jax" backend's padded fit is held in
  ``tests/test_torch_streaming.py``, beside the mutations that start from
  it): mean and variance 1e-8.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPConfig as JaxGPConfig
from repro.core import fit as jax_fit
from repro.core import posterior_mean as jax_mean
from repro.core import posterior_var as jax_var
from repro_torch.core import (GPConfig, fit, log_likelihood, mll_gradients,
                              posterior_mean, posterior_var)
from repro_torch.core import bayesopt as bo
from repro_torch.core.backfitting import DimOps, SolveConfig, solve_mhat
from repro_torch.core.banded import Banded
from repro_torch.streaming import evict, insert
from torch_port_inputs import OMEGA, points
from torch_port_jax_ref import _rel, fresh_jax_caches  # noqa: F401

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

N, CAP, D, SIGMA = 16, 24, 2, 0.4


def _data(n, seed):
    rng = np.random.default_rng(seed)
    X = points(rng, n + 2, D)
    Y = np.sin(2.0 * X).sum(1) + 0.1 * rng.standard_normal(n + 2)
    return X[:n], Y[:n], X[n:], Y[n:], rng.uniform(0.0, 4.0, (7, D))


def _pair(cfg, seed=1):
    X, Y, Xn, Yn, Xq = _data(N, seed)
    om = np.full(D, OMEGA)
    return (fit(cfg, X, Y, om, SIGMA, device="cpu"),
            fit(cfg, X, Y, om, SIGMA, device="cpu", capacity=CAP), Xn, Yn,
            Xq)


_CASES = {
    "q0_pcg": GPConfig(q=0, solver_iters=30, precond="none"),
    "q1_pcg": GPConfig(q=1, solver_iters=30, precond="none"),
    "q0_jacobi_off": GPConfig(q=0, solver="jacobi", fused="off",
                              precond="none"),
    "q0_gauss_seidel": GPConfig(q=0, solver="gauss_seidel",
                                solver_iters=20, precond="none"),
    "q0_kmg": GPConfig(q=0, precond="kmg", solver_iters=30),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_padded_fit_parity(name):
    gp, gpp, _, _, Xq = _pair(_CASES[name])
    assert gpp.n == CAP and gpp.num_points() == N
    for got, want in [(gpp.ops.A.data[:, :N], gp.ops.A.data),
                      (gpp.ops.Phi.data[:, :N], gp.ops.Phi.data),
                      (gpp.B.data[:, :N], gp.B.data),
                      (gpp.u_sy[:, :N], gp.u_sy), (gpp.bY[:, :N], gp.bY),
                      (gpp.Gband.data[:, :N], gp.Gband.data),
                      (gpp.xs[:, :N], gp.xs)]:
        assert torch.equal(got, want)
    assert torch.equal(posterior_mean(gp, Xq, device="cpu"),
                       posterior_mean(gpp, Xq, device="cpu"))
    assert float((posterior_var(gp, Xq, device="cpu")
                  - posterior_var(gpp, Xq, device="cpu")).abs().max()) <= 1e-12
    g = lambda s: torch.Generator().manual_seed(s)
    assert _rel(float(log_likelihood(gpp, g(7))),
                float(log_likelihood(gp, g(7)))) <= 1e-12
    (o0, s0), (o1, s1) = mll_gradients(gp, g(8)), mll_gradients(gpp, g(8))
    assert float((o0 - o1).abs().max()) <= 1e-11
    assert abs(float(s0 - s1)) <= 1e-11 + 1e-10 * abs(float(s0))


def _poison(gp):
    """NaN every float tail slot and a huge value in every int tail slot."""
    k = gp.num_points()

    def prow(x, axis):
        x = x.clone()
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(k, None)
        x[tuple(idx)] = float("nan") if x.is_floating_point() else 2 ** 30
        return x

    def pband(b):
        return Banded(prow(b.data, 1), b.lo, b.hi, b.n_active)

    ops = gp.ops
    ops_p = DimOps(A=pband(ops.A), Phi=pband(ops.Phi), SAPhi=pband(ops.SAPhi),
                   sort_idx=prow(ops.sort_idx, 1),
                   rank_idx=prow(ops.rank_idx, 1), sigma2=ops.sigma2,
                   pivot=ops.pivot, alg=ops.alg, n_active=ops.n_active)
    return dataclasses.replace(
        gp, X=prow(gp.X, 0), Y=prow(gp.Y, 0), xs=prow(gp.xs, 1), ops=ops_p,
        B=pband(gp.B), Psi=pband(gp.Psi), bY=prow(gp.bY, 1),
        u_sy=prow(gp.u_sy, 1), Gband=pband(gp.Gband), Hband=pband(gp.Hband))


def test_tail_poison_never_influences_active_results():
    _, gpp, Xn, Yn, Xq = _pair(GPConfig(q=0, solver_iters=40,
                                        precond="none"), seed=3)
    bad = _poison(gpp)
    g = lambda s: torch.Generator().manual_seed(s)
    for f in (lambda h: posterior_mean(h, Xq, device="cpu"),
              lambda h: posterior_var(h, Xq, device="cpu"),
              lambda h: log_likelihood(h, g(1)),
              lambda h: torch.cat(mll_gradients(h, g(2))[:1]
                                  + (mll_gradients(h, g(2))[1][None],))):
        clean, got = f(gpp), f(bad)
        assert torch.isfinite(got).all() and torch.equal(got, clean)
    # one insert and one evict from the poisoned state keep the bits
    a = evict(insert(gpp, Xn[0], Yn[0], count=N), count=N + 1)
    b = evict(insert(bad, Xn[0], Yn[0], count=N), count=N + 1)
    k = N
    for x, y in [(a.u_sy[:, :k], b.u_sy[:, :k]), (a.bY[:, :k], b.bY[:, :k]),
                 (a.Gband.data[:, :k], b.Gband.data[:, :k]),
                 (a.ops.A.data[:, :k], b.ops.A.data[:, :k])]:
        assert torch.isfinite(y).all() and torch.equal(x, y)
    assert torch.equal(posterior_mean(a, Xq, device="cpu"),
                       posterior_mean(b, Xq, device="cpu"))


def test_solve_info_reports_n_active_and_active_prefix_tol():
    gp, gpp, _, _, _ = _pair(GPConfig(q=0, solver_iters=60, precond="none"))
    rng = np.random.default_rng(5)
    v = torch.as_tensor(rng.standard_normal((D, N, 2)))
    vp = torch.cat([v, torch.full((D, CAP - N, 2), 7.0)], dim=1)  # tail junk
    cfg = SolveConfig(iters=60, tol=1e-8, fused="off")
    x, info = solve_mhat(gp.ops, v, cfg, return_info=True)
    xp, infop = solve_mhat(gpp.ops, vp, cfg, return_info=True)
    assert int(infop.n_active) == N and int(info.n_active) == N
    # the tol exit reads the active prefix only: the same iterations
    assert int(infop.iters) == int(info.iters) < 60
    assert torch.equal(xp[:, :N], x) and not xp[:, N:].any()


def test_acquisition_local_cache_and_propose_padded_parity():
    gp, gpp, _, _, Xq = _pair(GPConfig(q=0, solver_iters=60,
                                       precond="none"))
    for kind in ("ucb", "ei"):
        a = bo.acquisition_stats(gp, Xq, 2.0, 0.5, kind=kind, device="cpu")
        b = bo.acquisition_stats(gpp, Xq, 2.0, 0.5, kind=kind, device="cpu")
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= 1e-12
    c, cp = bo.build_local_cache(gp), bo.build_local_cache(gpp)
    assert float((cp.M_tilde[:, :N, :, :N] - c.M_tilde).abs().max()) <= 1e-12
    assert not cp.M_tilde[:, N:].any() and not cp.M_tilde[:, :, :, N:].any()
    Mt = cp.M_tilde  # symmetric (Mhat is SPD), to the solves' convergence
    assert float((Mt - Mt.permute(2, 3, 0, 1)).abs().max()) <= 1e-10
    cfg = bo.BOConfig(incremental=False, use_engine=False, ascent_steps=2,
                      n_starts=4)
    bounds = np.array([[0.0, 4.0]] * D)
    x = bo.propose_next(gp, bounds, torch.Generator().manual_seed(4), cfg,
                        0.5, device="cpu")
    xp = bo.propose_next(gpp, bounds, torch.Generator().manual_seed(4), cfg,
                         0.5, device="cpu")
    assert float((x - xp).abs().max()) <= 1e-10


def test_padded_fit_matches_jax_pallas_interpret():
    """One tiny case against the JAX package's Pallas kernels in interpret
    mode (q = 0, n = 8 in capacity 12, 10 iterations)."""
    X, Y, _, _, Xq = _data(8, 11)
    om = np.full(D, OMEGA)
    jgp = jax_fit(JaxGPConfig(q=0, solver_iters=10, backend="pallas",
                              precond="none"), jnp.asarray(X),
                  jnp.asarray(Y), jnp.asarray(om), 1.0, capacity=12)
    gp = fit(GPConfig(q=0, solver_iters=10, precond="none"), X, Y, om, 1.0,
             device="cpu", capacity=12)
    assert _rel(posterior_mean(gp, Xq[:4], device="cpu").numpy(),
                np.asarray(jax_mean(jgp, jnp.asarray(Xq[:4])))) < 1e-8
    assert _rel(posterior_var(gp, Xq[:4], device="cpu").numpy(),
                np.asarray(jax_var(jgp, jnp.asarray(Xq[:4])))) < 1e-8
