"""The port's stochastic estimators and dense oracle against the JAX package,
on the CPU.

* ``power_method`` and ``logdet_taylor`` with the same injected probe
  blocks (numpy Rademacher draws) on the same dense SPD operator: 1e-10
  relative (the same arithmetic in another framework's summation order).
* ``exact.py``'s Gram, posterior, marginal likelihood and its autodiff
  gradients: 1e-10 relative.
* The draws: ``rademacher_rows`` gives +-1 blocks that a seed fixes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exact as jexact
from repro.core import stochastic as jst
from repro_torch.core import exact, stochastic
from torch_port_jax_ref import fresh_jax_caches  # noqa: F401 (autouse)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _spd(rng, D, n):
    """A dense SPD operator on (D, n) vectors with a spread spectrum."""
    N = D * n
    Qm, _ = np.linalg.qr(rng.standard_normal((N, N)))
    M = (Qm * np.linspace(0.5, 20.0, N)) @ Qm.T
    return M


def _mv_pair(M, D, n):
    Mt, Mj = torch.as_tensor(M), jnp.asarray(M)

    def mv_t(u):
        return (Mt @ u.reshape(D * n, -1)).reshape(u.shape)

    def mv_j(u):
        return (Mj @ u.reshape(D * n, -1)).reshape(u.shape)

    return mv_t, mv_j


def _signs(rng, shape):
    return rng.integers(0, 2, shape).astype(np.float64) * 2.0 - 1.0


@pytest.mark.parametrize("D,n", [(1, 40), (3, 17)])
def test_power_method_matches_jax(D, n):
    rng = np.random.default_rng(110 + D)
    mv_t, mv_j = _mv_pair(_spd(rng, D, n), D, n)
    v0 = _signs(rng, (D, n, 4))
    lam = stochastic.power_method(mv_t, (D, n), None, iters=20,
                                  v0=torch.as_tensor(v0))
    lam_j = jst.power_method(mv_j, (D, n), jax.random.PRNGKey(0), iters=20,
                             dtype=jnp.float64, v0=jnp.asarray(v0))
    assert _rel(lam, lam_j) < 1e-10


@pytest.mark.parametrize("order,probes", [(10, 4), (30, 16)])
def test_logdet_taylor_matches_jax(order, probes):
    D, n = 3, 17
    rng = np.random.default_rng(120 + order)
    M = _spd(rng, D, n)
    mv_t, mv_j = _mv_pair(M, D, n)
    pv, pm = _signs(rng, (D, n, probes)), _signs(rng, (D, n, 4))
    ld = stochastic.logdet_taylor(mv_t, D * n, (D, n), None, order=order,
                                  probes=probes, probe_v=torch.as_tensor(pv),
                                  power_v0=torch.as_tensor(pm))
    ld_j = jst.logdet_taylor(mv_j, D * n, (D, n), jax.random.PRNGKey(0),
                             order=order, probes=probes, dtype=jnp.float64,
                             probe_v=jnp.asarray(pv), power_v0=jnp.asarray(pm))
    assert _rel(ld, ld_j) < 1e-10


def test_logdet_taylor_estimates_the_logdet():
    """Unbiased up to truncation: many probes land near the true value."""
    D, n = 2, 20
    rng = np.random.default_rng(130)
    M = _spd(rng, D, n)
    mv_t, _ = _mv_pair(M, D, n)
    ld = stochastic.logdet_taylor(mv_t, D * n, (D, n),
                                  torch.Generator().manual_seed(0),
                                  order=200, probes=512)
    true = np.linalg.slogdet(M)[1]
    assert abs(float(ld) - true) < 0.02 * abs(true)


def test_rademacher_rows_and_hutchinson():
    g = lambda s: torch.Generator().manual_seed(s)
    a = stochastic.rademacher_rows(g(3), 50, (2, 4))
    assert a.shape == (50, 2, 4) and a.dtype == torch.float64
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(a, stochastic.rademacher_rows(g(3), 50, (2, 4)))
    assert not torch.equal(a, stochastic.rademacher_rows(g(4), 50, (2, 4)))
    M = torch.as_tensor(_spd(np.random.default_rng(140), 1, 30))
    quad = lambda V: torch.einsum("nq,nm,mq->q", V, M, V)
    for gaussian in (False, True):
        tr = stochastic.hutchinson(quad, (30,), g(5), probes=4000,
                                   gaussian=gaussian)
        assert abs(float(tr) - float(torch.trace(M))) < 0.05 * float(
            torch.trace(M))


@pytest.mark.parametrize("q", [0, 1])
def test_exact_oracle_matches_jax(q):
    rng = np.random.default_rng(150 + q)
    n, D = 30, 3
    X = rng.random((n, D)) * 5
    Y = np.sin(X).sum(1) + 0.1 * rng.standard_normal(n)
    Xq = rng.random((7, D)) * 5
    omega, sigma = 0.7 + rng.random(D), 0.3
    jX, jY, jXq, jom = map(jnp.asarray, (X, Y, Xq, omega))
    assert _rel(exact.additive_gram(q, torch.as_tensor(omega),
                                    torch.as_tensor(X), torch.as_tensor(Xq)),
                jexact.additive_gram(q, jom, jX, jXq)) < 1e-10
    mu, var = exact.posterior_mean_var(q, omega, sigma, X, Y, Xq)
    mu_j, var_j = jexact.posterior_mean_var(q, jom, sigma, jX, jY, jXq)
    assert _rel(mu, mu_j) < 1e-10 and _rel(var, var_j) < 1e-10
    ll = exact.log_marginal_likelihood(q, omega, sigma, X, Y)
    ll_j = jexact.log_marginal_likelihood(q, jom, sigma, jX, jY)
    assert _rel(ll, ll_j) < 1e-10
    g_om, g_sg = exact.mll_grads(q, omega, sigma, X, Y)
    g_om_j, g_sg_j = jexact.mll_grads(q, jom, jnp.asarray(sigma), jX, jY)
    assert _rel(g_om, g_om_j) < 1e-10 and _rel(g_sg, g_sg_j) < 1e-10
