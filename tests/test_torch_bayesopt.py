"""The port's Bayesian optimisation (paper Sec. 6) against the JAX package,
on the CPU.

Both sides share the fitted GP: the JAX fit's arrays are carried into the
port with ``gp_from_arrays``, so the acquisition compares the same factors
and caches (at q = 0 and q = 1, on jittered points, n = 64, D = 3). The
JAX side runs its plain reference backend ("jax"): it has the same meaning
as the Pallas kernels in interpret mode and compiles in a fraction of the
time. The port's Mhat solves (the variance term) run its own plain
whole-solve PCG, converged in 80 iterations as the JAX one, so the two
variances agree to rounding.

Bars: ``matern_dx`` and ``phi_grad_at`` 1e-12 (closed forms);
``posterior_mean_grad`` 1e-10 (one gather against the shared bY); the
acquisition value and gradient 1e-8 (they include an Mhat solve in each
framework); one ascent step 1e-14; ``propose_next`` from the same starts,
the dense cache and three rounds of the refit loop 1e-8 (the loop from the
JAX draws, fed through ``bayesopt.uniform_rows``); the port's gradients
against central differences of its own mean and variance 1e-4, the JAX
package's own bar (``tests/test_bayesopt.py``).
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
from repro.core import bayesopt as jbo
from repro.core.additive_gp import posterior_mean_grad as jax_mean_grad
from repro.core.banded import Banded as JaxBanded
from repro.core.kernel_packets import phi_grad_at as jax_phi_grad_at
from repro.core.matern import matern_dx as jax_matern_dx
from repro_torch.core import (GPConfig, gp_from_arrays, posterior_mean,
                              posterior_mean_grad, posterior_var)
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import bayesopt as bo
from repro_torch.core.banded import Banded
from repro_torch.core.kernel_packets import phi_grad_at
from repro_torch.core.matern import matern_dx
from repro_torch.streaming import GPServeEngine
from torch_port_inputs import points
from torch_port_jax_ref import _jax_arrays, fresh_jax_caches  # noqa: F401

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

N, D, SIGMA, ITERS, OMEGA = 64, 3, 0.5, 80, 2.0
BETA = 2.0


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def fitted():
    """q -> (JAX GP, the port's GP on the same arrays, data, queries)."""
    cache = {}

    def get(q):
        if q not in cache:
            rng = np.random.default_rng(20 + q)
            X = points(rng, N, D)
            Y = np.sin(2.0 * X).sum(1) + 0.1 * rng.standard_normal(N)
            Xq = rng.uniform(0.1, 3.9, (6, D))
            kw = dict(q=q, solver="pcg", solver_iters=ITERS, precond="none")
            jgp = jax_fit(JaxGPConfig(backend="jax", **kw), jnp.asarray(X),
                          jnp.asarray(Y), jnp.asarray(np.full(D, OMEGA)),
                          SIGMA)
            gp = gp_from_arrays(_jax_arrays(jgp), GPConfig(**kw), "cpu")
            cache[q] = (jgp, gp, X, Y, Xq)
        return cache[q]

    return get


@pytest.mark.parametrize("q", [0, 1, 2, 3])
def test_matern_dx_matches_jax(q):
    rng = np.random.default_rng(q)
    x = rng.uniform(-2, 2, 50)
    y = np.concatenate([rng.uniform(-2, 2, 40), x[40:]])  # ten x == y
    om = 1.7
    ours = matern_dx(q, torch.tensor(om, dtype=torch.float64),
                     torch.as_tensor(x),
                     torch.as_tensor(y)).numpy()
    want = np.asarray(jax_matern_dx(q, om, jnp.asarray(x), jnp.asarray(y)))
    assert np.all(ours[40:] == 0.0) and np.all(want[40:] == 0.0)
    assert np.max(np.abs(ours - want)) <= 1e-12 * max(np.abs(want).max(), 1)


@pytest.mark.parametrize("q", [0, 1])
def test_phi_grad_at_matches_jax(fitted, q):
    jgp, gp, _, _, Xq = fitted(q)
    Xq = np.concatenate([Xq, [[0.0] * D, [4.0] * D]])  # the clipped ends
    rows, vals, valid = phi_grad_at(q, gp.omega, gp.xs,
                                    Banded(gp.ops.A.data, q + 1, q + 1),
                                    torch.as_tensor(Xq.T).contiguous())
    for d in range(D):
        jr, jv, jval = jax_phi_grad_at(
            q, jgp.omega[d], jgp.xs[d],
            JaxBanded(jgp.ops.A.data[d], q + 1, q + 1), jnp.asarray(Xq[:, d]))
        assert np.array_equal(rows[d].numpy(), np.asarray(jr))
        assert np.array_equal(valid[d].numpy(), np.asarray(jval))
        assert np.max(np.abs(vals[d].numpy() - np.asarray(jv))) <= 1e-12 * \
            np.abs(np.asarray(jv)).max()


@pytest.mark.parametrize("q", [0, 1])
def test_posterior_mean_grad_matches_jax(fitted, q):
    jgp, gp, _, _, Xq = fitted(q)
    ours = posterior_mean_grad(gp, Xq, device="cpu")
    assert ours.shape == (len(Xq), D)
    assert _rel(ours.numpy(), jax_mean_grad(jgp, jnp.asarray(Xq))) <= 1e-10


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("kind", ["ucb", "ei"])
def test_acquisition_matches_jax(fitted, q, kind):
    jgp, gp, _, Y, Xq = fitted(q)
    best = float(Y.max())
    val, grad = bo.acquisition_value_and_grad(gp, Xq, BETA, best, kind=kind,
                                              device="cpu")
    jval, jgrad = jbo.acquisition_value_and_grad(jgp, jnp.asarray(Xq), BETA,
                                                 best, kind=kind)
    assert _rel(val.numpy(), jval) <= 1e-8
    assert _rel(grad.numpy(), jgrad) <= 1e-8
    stats = bo.acquisition_stats(gp, Xq, BETA, best, kind=kind, device="cpu")
    jstats = jbo.acquisition_stats(jgp, jnp.asarray(Xq), BETA, best,
                                   kind=kind)
    for a, b in zip(stats, jstats):
        assert _rel(a.numpy(), b) <= 1e-8
    assert torch.equal(stats[0], val) and torch.equal(stats[1], grad)


def test_ascent_step_matches_jax():
    rng = np.random.default_rng(5)
    X = rng.uniform(0, 4, (8, D))
    g = rng.standard_normal((8, D))
    g[3] = 0.0  # a zero gradient: the 1e-12 floor on its norm
    lo, hi = np.zeros(D), np.full(D, 4.0)
    step = 0.05 * (hi - lo) * 7  # some points leave the box and are clipped
    t = torch.as_tensor
    ours = bo.ascent_step(t(X), t(g), t(lo), t(hi), t(step)).numpy()
    want = np.asarray(jbo.ascent_step(*(jnp.asarray(a) for a in
                                        (X, g, lo, hi, step))))
    assert np.max(np.abs(ours - want)) <= 1e-14
    assert ours.min() >= 0.0 and ours.max() <= 4.0


def _feed(monkeypatch, draws):
    """Make ``bayesopt.uniform_rows`` return ``draws`` in order."""
    it = iter(draws)

    def fed(generator, shape, dtype=torch.float64, device=None):
        u = torch.as_tensor(np.asarray(next(it)), dtype=dtype)
        assert tuple(u.shape) == tuple(shape)
        return u.to(device=device)

    monkeypatch.setattr(bo, "uniform_rows", fed)


@pytest.mark.parametrize("q,kind", [(0, "ucb"), (1, "ei")])
def test_propose_next_matches_jax_loop(fitted, monkeypatch, q, kind):
    """The same starts through the port's ascent and through the JAX
    package's acquisition_value_and_grad + ascent_step loop."""
    jgp, gp, _, Y, _ = fitted(q)
    cfg = bo.BOConfig(kind=kind, ascent_steps=6, n_starts=8,
                      incremental=False, use_engine=False)
    bounds = np.array([[0.0, 4.0]] * D)
    starts = np.random.default_rng(6).uniform(size=(cfg.n_starts, D))
    best = float(Y.max())
    _feed(monkeypatch, [starts])
    x = bo.propose_next(gp, bounds, torch.Generator(), cfg, best,
                        device="cpu")
    lo, hi = jnp.asarray(bounds[:, 0]), jnp.asarray(bounds[:, 1])
    X = lo + jnp.asarray(starts) * (hi - lo)
    for _ in range(cfg.ascent_steps):
        _, g = jbo.acquisition_value_and_grad(jgp, X, BETA, best, kind=kind)
        X = jbo.ascent_step(X, g, lo, hi, cfg.lr * (hi - lo))
    val, _ = jbo.acquisition_value_and_grad(jgp, X, BETA, best, kind=kind)
    want = np.asarray(X[jnp.argmax(val)])
    assert x.shape == (D,) and _rel(x.numpy(), want) <= 1e-8
    assert bool(((x >= 0.0) & (x <= 4.0)).all())


def test_local_cache_matches_operator_path_and_jax(fitted):
    jgp, gp, _, Y, Xq = fitted(1)
    cache = bo.build_local_cache(gp)
    M = cache.M_tilde
    assert M.shape == (D, N, D, N)
    assert float((M - M.permute(2, 3, 0, 1)).abs().max()) <= 1e-8 * float(
        M.abs().max())
    jcache = jbo.build_local_cache(jgp)
    assert _rel(M.numpy(), jcache.M_tilde) <= 1e-8
    best = float(Y.max())
    for kind in ("ucb", "ei"):
        vo, go = bo.acquisition_value_and_grad(gp, Xq[:3], BETA, best,
                                               kind=kind, device="cpu")
        for i, xq in enumerate(Xq[:3]):
            v, g = bo.acq_local(gp, cache, xq, BETA, best, kind=kind,
                                device="cpu")
            jv, jg = jbo.acq_local(jgp, jcache, jnp.asarray(xq), BETA, best,
                                   kind=kind)
            assert _rel(v.numpy(), vo[i].numpy()) <= 1e-8
            assert _rel(g.numpy(), go[i].numpy()) <= 1e-8
            assert _rel(v.numpy(), jv) <= 1e-8 and _rel(g.numpy(), jg) <= 1e-8


def _objective(x):
    """Additive, maximal at 0 (2.0); takes one point as numpy or JAX."""
    x = np.asarray(x)
    return float(np.sum(np.cos(x) * np.exp(-0.2 * x ** 2)))


def test_bayes_opt_loop_matches_jax(monkeypatch):
    """Three rounds of the refit loop (no hyperparameter refit) from the
    JAX package's own draws: the same points and values."""
    n_init, budget = 12, 3
    bounds = np.array([[-2.0, 2.0]] * 2)
    kw = dict(q=0, solver="pcg", solver_iters=40, precond="none")
    cfg = jbo.BOConfig(ascent_steps=3, n_starts=6, refit_every=0,
                       incremental=False, use_engine=False)
    key = jax.random.PRNGKey(3)
    _, jX, jY, jhist = jbo.bayes_opt_loop(
        _objective, jnp.asarray(bounds), budget,
        JaxGPConfig(backend="jax", **kw), cfg, key, n_init=n_init,
        sigma0=0.1)
    # the JAX loop's draws, in its order: the initial design, then one
    # start block a round
    key, sub = jax.random.split(key)
    draws = [jax.random.uniform(sub, (n_init, 2), dtype=jnp.float64)]
    for _ in range(budget):
        key, k1, _ = jax.random.split(key, 3)
        draws.append(jax.random.uniform(k1, (cfg.n_starts, 2),
                                        dtype=jnp.float64))
    _feed(monkeypatch, draws)
    pcfg = bo.BOConfig(**{f.name: getattr(cfg, f.name)
                          for f in jbo.BOConfig.__dataclass_fields__.values()})
    gp, X, Y, hist = bo.bayes_opt_loop(
        _objective, bounds, budget, GPConfig(**kw), pcfg, torch.Generator(),
        n_init=n_init, sigma0=0.1, device="cpu")
    assert X.shape == (n_init + budget, 2) and gp.n == n_init + budget
    assert _rel(X.numpy(), jX) <= 1e-8 and _rel(Y.numpy(), jY) <= 1e-8
    assert _rel(hist["best"], jhist["best"]) <= 1e-8
    assert hist["best"][-1] >= hist["best"][0]


def test_streaming_branch_raises(tmp_path):
    """The streaming branch (the reference's default) runs since it was
    ported, in each of its three forms, and the serving engine takes a
    checkpointer, as the reference's does: a healthy fence saves the
    posterior every ``checkpoint_every`` versions."""
    bounds = np.array([[-2.0, 2.0]])
    for cfg in (bo.BOConfig(), bo.BOConfig(incremental=False),
                bo.BOConfig(use_engine=False)):
        gp, X, _, hist = bo.bayes_opt_loop(
            _objective, bounds, 1, GPConfig(precond="none", solver_iters=8),
            dataclasses.replace(cfg, ascent_steps=2, n_starts=4),
            torch.Generator(), n_init=8, device="cpu")
        assert X.shape == (9, 1) and np.isfinite(hist["y"]).all()
    ck = Checkpointer(str(tmp_path))
    eng = GPServeEngine(gp, bounds, checkpointer=ck, checkpoint_every=1)
    eng.insert(np.array([0.5]), _objective(np.array([0.5])))
    eng.run_until_done()
    ck.wait()
    assert eng.health_stats()["repairs"] == 0 and ck.latest_step() == 1
    assert torch.equal(ck.restore(eng.gp)[0].u_sy, eng.gp.u_sy)


@pytest.fixture(scope="module")
def central_differences(fitted):
    """q -> (Xq (4, D), the port's mean and variance at Xq +- eps e_j,
    each (2, D, 4), eps): one posterior_mean and one posterior_var call
    over all the shifted points."""
    cache = {}
    eps = 1e-5

    def get(q):
        if q not in cache:
            _, gp, _, _, Xq = fitted(q)
            Xq = torch.as_tensor(Xq[:4])
            e = eps * torch.eye(D, dtype=torch.float64)
            pts = torch.stack([torch.stack([Xq + s * e[j] for j in range(D)])
                               for s in (1.0, -1.0)]).reshape(-1, D)
            mu = posterior_mean(gp, pts, device="cpu").reshape(2, D, 4)
            var = posterior_var(gp, pts, device="cpu").reshape(2, D, 4)
            cache[q] = (Xq, mu, var, eps)
        return cache[q]

    return get


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("kind", ["ucb", "ei"])
def test_gradients_match_finite_differences(fitted, central_differences, q,
                                            kind):
    """The port's own mean and acquisition gradients against central
    differences of its posterior_mean / posterior_var."""
    _, gp, _, Y, _ = fitted(q)
    Xq, mu, var, eps = central_differences(q)
    best = float(Y.max())
    _, grad, _, _ = bo.acquisition_stats(gp, Xq, BETA, best, kind=kind,
                                         device="cpu")
    dmu = posterior_mean_grad(gp, Xq, device="cpu")
    s = torch.sqrt(var)
    if kind == "ucb":
        acq = mu + BETA * s
    else:
        z = (mu - best) / s
        pdf = torch.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
        cdf = 0.5 * (1 + torch.special.erf(z / np.sqrt(2.0)))
        acq = (mu - best) * cdf + s * pdf
    fd_a = ((acq[0] - acq[1]) / (2 * eps)).T  # (4, D)
    fd_m = ((mu[0] - mu[1]) / (2 * eps)).T
    assert float((grad - fd_a).abs().max()) < 1e-4
    assert float((dmu - fd_m).abs().max()) < 1e-4
