"""The port's hyperparameter-learning path (log_likelihood -> mll_gradients ->
fit_hyperparams) against the JAX package, on the CPU.

Both sides fit the same seeded data (D = 3, jittered-grid points, 80 PCG
iterations so every solve converges to rounding) and get the same probes:
the JAX package's own draws (``jax.random.split`` + ``_probe_block`` /
``rademacher_rows``) are handed to the port's private ``_log_likelihood`` /
``_mll_gradients``, and ``fit_hyperparams`` gets its per-step draws by
replacing the port's one draw function. The reference runs on its plain
"jax" backend (its Pallas kernels in interpret mode add minutes of compile
for the whole path; ``test_torch_matvec_cr.py`` holds the kernels against
them), with one q = 0 case on "pallas" in interpret mode.

Bars: log-likelihood 1e-8 relative; gradients 1e-7 of the largest
gradient component; fitted omega and sigma after 2 Adam steps 1e-6
relative. Against the port's own dense oracle (``core/exact.py``) the
stochastic estimates meet the JAX package's statistical bars
(``tests/test_additive_gp.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPConfig as JaxGPConfig
from repro.core import fit as jax_fit
from repro.core import fit_hyperparams as jax_fit_hyperparams
from repro.core import log_likelihood as jax_log_likelihood
from repro.core import mll_gradients as jax_mll_gradients
from repro.core.additive_gp import _probe_block as jax_probe_block
from repro.core.additive_gp import _r_apply as jax_r_apply
from repro.core.stochastic import rademacher_rows as jax_rademacher_rows
from repro_torch.core import GPConfig, exact, fit, fit_hyperparams
from repro_torch.core import stochastic
from repro_torch.core.additive_gp import (_log_likelihood, _mll_gradients,
                                          _r_apply, log_likelihood,
                                          mll_gradients)
from torch_port_inputs import OMEGA, points
from torch_port_jax_ref import fresh_jax_caches  # noqa: F401 (autouse)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

N, D, SIGMA, ITERS = 37, 3, 0.5, 80


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _data(q):
    rng = np.random.default_rng(200 + q)
    X = points(rng, N, D)
    Y = np.sin(2.0 * X).sum(1) + 0.1 * rng.standard_normal(N)
    return X, Y


@pytest.fixture(scope="module")
def fitted():
    cache = {}

    def get(q, method="taylor_pc", backend="jax"):
        key = (q, method, backend)
        if key not in cache:
            X, Y = _data(q)
            omega = np.full(D, OMEGA)
            jcfg = JaxGPConfig(q=q, solver_iters=ITERS, precond="none",
                               backend=backend, logdet_method=method)
            jgp = jax_fit(jcfg, jnp.asarray(X), jnp.asarray(Y),
                          jnp.asarray(omega), SIGMA)
            cfg = GPConfig(q=q, solver_iters=ITERS, precond="none",
                           logdet_method=method)
            gp = fit(cfg, X, Y, omega, SIGMA, device="cpu")
            cache[key] = (jgp, gp)
        return cache[key]

    return get


LL_CASES = [(0, "taylor_pc", "jax"), (0, "taylor", "jax"),
            (1, "taylor_pc", "jax"), (1, "taylor", "jax"),
            (0, "taylor_pc", "pallas")]


@pytest.mark.parametrize("case", LL_CASES)
def test_log_likelihood_matches_jax(fitted, case):
    jgp, gp = fitted(*case)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    pm_v0 = np.array(jax_probe_block(jgp, k1, 4))
    probe_v = np.array(jax_probe_block(jgp, k2, jgp.config.logdet_probes))
    ll_j = float(jax_log_likelihood(jgp, key))
    ll, verdict = _log_likelihood(gp, torch.as_tensor(pm_v0),
                                  torch.as_tensor(probe_v),
                                  return_verdict=True)
    assert _rel(ll, ll_j) < 1e-8
    assert int(verdict) == 0


@pytest.mark.parametrize("case", [(0, "taylor_pc", "jax"),
                                  (1, "taylor_pc", "jax"),
                                  (0, "taylor_pc", "pallas")])
def test_mll_gradients_match_jax(fitted, case):
    jgp, gp = fitted(*case)
    key = jax.random.PRNGKey(8)
    V = np.array(jax_rademacher_rows(key, N, (jgp.config.trace_probes,),
                                     dtype=jnp.float64))
    g_om_j, g_sg_j = jax_mll_gradients(jgp, key)
    g_om, g_sg, info = _mll_gradients(gp, torch.as_tensor(V),
                                      return_info=True)
    want = np.concatenate([np.asarray(g_om_j), [float(g_sg_j)]])
    got = np.concatenate([g_om.numpy(), [float(g_sg)]])
    assert np.max(np.abs(got - want)) < 1e-7 * np.max(np.abs(want))
    assert int(info.verdict) == 0


@pytest.mark.parametrize("q", [0, 1])
def test_r_apply_matches_jax_and_dense(fitted, q):
    """R v = (K + s^2 I)^{-1} v through the backfitting solve."""
    jgp, gp = fitted(q)
    v = np.random.default_rng(210 + q).standard_normal((N, 3))
    r = _r_apply(gp, torch.as_tensor(v), gp.config.solve_cfg())
    r_j = jax_r_apply(jgp, jnp.asarray(v), jgp.config.solve_cfg())
    assert _rel(r, r_j) < 1e-8
    X, _ = _data(q)
    K = exact.additive_gram(q, torch.full((D,), OMEGA, dtype=torch.float64),
                            torch.as_tensor(X))
    cov = K + SIGMA ** 2 * torch.eye(N, dtype=K.dtype)
    dense = torch.linalg.solve(cov, torch.as_tensor(v))
    assert _rel(r, dense) < 1e-8


def test_public_entry_points_draw_from_the_generator(fitted):
    _, gp = fitted(0)
    a = log_likelihood(gp, torch.Generator().manual_seed(1))
    b = log_likelihood(gp, torch.Generator().manual_seed(1))
    c = log_likelihood(gp, torch.Generator().manual_seed(2))
    assert float(a) == float(b) and float(a) != float(c)
    g1 = mll_gradients(gp, torch.Generator().manual_seed(3))
    g2 = mll_gradients(gp, torch.Generator().manual_seed(3))
    assert torch.equal(g1[0], g2[0]) and float(g1[1]) == float(g2[1])


@pytest.mark.parametrize("q", [0, 1])
def test_fit_hyperparams_matches_jax(monkeypatch, q):
    X, Y = _data(q)
    omega0, steps = np.full(D, OMEGA), 2
    cfg = dict(q=q, solver_iters=ITERS, precond="none")
    key = jax.random.PRNGKey(9)
    _, (om_j, sg_j), norms_j = jax_fit_hyperparams(
        JaxGPConfig(backend="jax", **cfg), jnp.asarray(X), jnp.asarray(Y),
        jnp.asarray(omega0), SIGMA, key, steps=steps)
    # the reference's per-step draws, fed to the port's one draw function
    draws, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        draws.append(np.array(jax_rademacher_rows(
            sub, N, (GPConfig().trace_probes,), dtype=jnp.float64)))
    fed = iter(draws)
    monkeypatch.setattr(stochastic, "rademacher_rows",
                        lambda *a, **kw: torch.as_tensor(next(fed)))
    _, (om, sg), norms = fit_hyperparams(GPConfig(**cfg), X, Y, omega0, SIGMA,
                                         torch.Generator(), steps=steps,
                                         device="cpu")
    assert next(fed, None) is None
    assert _rel(om, om_j) < 1e-6 and _rel(sg, sg_j) < 1e-6
    assert _rel(norms, norms_j) < 1e-6


# --- the port against its own dense oracle (statistical bars) -------------


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((n, D)) * 5
    Y = np.sin(X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, Y, 0.7 + rng.random(D), 0.3


def test_log_likelihood_matches_dense():
    X, Y, omega, sigma = _problem(36)
    cfg = GPConfig(q=0, solver_iters=80, logdet_order=150, logdet_probes=32,
                   precond="none")
    gp = fit(cfg, X, Y, omega, sigma, device="cpu")
    ll = float(log_likelihood(gp, torch.Generator().manual_seed(0)))
    ll_ref = float(exact.log_marginal_likelihood(0, omega, sigma, X, Y))
    assert abs(ll - ll_ref) < 0.05 * abs(ll_ref) + 2.0


def test_mll_gradients_match_dense():
    X, Y, omega, sigma = _problem(50)
    cfg = GPConfig(q=0, solver_iters=80, trace_probes=512, precond="none")
    gp = fit(cfg, X, Y, omega, sigma, device="cpu")
    g_om, g_sg = mll_gradients(gp, torch.Generator().manual_seed(1))
    g_om_ref, g_sg_ref = exact.mll_grads(0, omega, sigma, X, Y)
    scale = float(g_om_ref.abs().max()) + 1.0
    assert float((g_om - g_om_ref).abs().max()) < 0.15 * scale
    assert abs(float(g_sg - g_sg_ref)) < 0.15 * (abs(float(g_sg_ref)) + 1.0)
