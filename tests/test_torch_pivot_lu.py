"""The port's pivoted LU route against the JAX package, on the CPU.

* The plain twin ``banded_lu_pivot_plain`` against the reference's gbsv-style
  scan (``repro.core.banded._solve_scan(..., pivot=True)``,
  ``_logdet_scan``) on bands whose scaled rows and zero leading diagonal
  force swaps (1e-12 relative; the unpivoted LU is not finite there, and
  the pivoted solve matches a dense ``numpy.linalg.solve`` to 1e-10), and
  ``ops``' capacity padding on this route.
* ``GPConfig(pivot=True, solve_alg="lu")`` through ``fit``,
  ``posterior_mean`` / ``posterior_var``, and for pcg the likelihood and
  gradients (the JAX package's own probes), against the JAX package's
  "jax" backend, where every solve of that config is the same scan: pcg,
  Jacobi, Gauss-Seidel and kmg at q = 0 and pcg at q = 1, on jittered
  grids at omega = 4. Bars: ``torch_port_jax_ref``'s (factors 1e-10,
  caches 1e-8, queries 1e-7) and ``test_torch_mll.py``'s (likelihood
  1e-8, gradients 1e-7 of the largest component).
* The streaming patch solve of a ``solve_alg="lu"`` GP takes the pivoted
  LU route, as the reference's does: one insert and one evict, the
  windowed band against the reference's ``gband_insert`` /
  ``gband_evict`` (pallas backend, ``alg="lu"``) on the same inputs
  (1e-10).
* A T = 2 fleet of that config: each lane bit for bit its standalone GP.
* ``core.matern``'s ``gram``, ``cross``, ``nu_from_q``, ``q_from_nu``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banded as jbanded
from repro.core import gband_update as jgu
from repro.core import matern as jmatern
from repro_torch import streaming as st
from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
from repro_torch.core import banded, fleet as fl
from repro_torch.core import gband_update, matern
from repro_torch.core.additive_gp import _log_likelihood, _mll_gradients
from repro_torch.kernels import ops
from repro_torch.kernels.banded_lu import (banded_lu, banded_lu_pivot,
                                           banded_lu_pivot_plain)
from torch_port_inputs import OMEGA, band, points
from torch_port_jax_ref import (_rel, check_fit,  # noqa: F401
                                check_queries, fit_cache, fresh_jax_caches,
                                shared_ref)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

BANDS = [(1, 1), (2, 1), (1, 2), (2, 0), (0, 2), (3, 3), (8, 8)]
G, NB = 3, 40


def _pivot_band(lo, hi, seed):
    """A well-conditioned (G, NB, lo+hi+1) band on which partial pivoting
    swaps: a diagonally dominant band with its rows scaled by 1 and 50 in
    turn (the scaled rows' off-diagonals outgrow the unscaled rows'
    diagonals below them), and, where lo and hi >= 1, a zero leading
    diagonal entry, which breaks the unpivoted LU."""
    rng = np.random.default_rng(seed)
    bd = band(rng, G, NB, lo, hi)
    bd *= np.where(np.arange(NB) % 2 == 1, 50.0, 1.0)[None, :, None]
    if lo and hi:
        bd[:, 0, lo] = 0.0
    return bd


def _scan_refs():
    """The reference's pivoted scan solves (a vector and a 5-column
    right-hand side) and log-determinants of every band in BANDS."""
    out = {}
    for i, (lo, hi) in enumerate(BANDS):
        bd = _pivot_band(lo, hi, 40 + i)
        rng = np.random.default_rng(60 + i)
        vec, mat = rng.standard_normal((G, NB)), rng.standard_normal(
            (G, NB, 5))
        b = jbanded.Banded(jnp.asarray(bd), lo, hi)
        out[lo, hi] = dict(
            band=bd, vec=vec, mat=mat,
            x_vec=np.asarray(jbanded._solve_scan(b, jnp.asarray(vec),
                                                 pivot=True)),
            x_mat=np.asarray(jbanded._solve_scan(b, jnp.asarray(mat),
                                                 pivot=True)),
            ld=np.asarray(jbanded._logdet_scan(b)))
    return out


@pytest.fixture(scope="module")
def scans(shared_ref):
    return shared_ref(("test_torch_pivot_lu", "scans"), _scan_refs)


@pytest.mark.parametrize("lo,hi", BANDS)
def test_plain_twin_matches_reference_scan(scans, lo, hi):
    r = scans[lo, hi]
    bd, mat = torch.as_tensor(r["band"]), torch.as_tensor(r["mat"])
    x, ld, swaps = banded_lu_pivot_plain(bd, mat, lo, hi, swaps=True)
    assert _rel(x, r["x_mat"]) <= 1e-12
    assert _rel(ld, r["ld"]) <= 1e-12
    # a vector right-hand side through the dispatched solve; an asymmetric
    # band takes the LU route at solve's defaults (pivot=True, alg "auto")
    b, vec = banded.Banded(bd, lo, hi), torch.as_tensor(r["vec"])
    xv = banded.solve(b, vec, alg="lu")
    assert _rel(xv, r["x_vec"]) <= 1e-12
    if lo != hi:
        assert torch.equal(banded.solve(b, vec), xv)
    assert _rel(ops.banded_logdet(bd, lo, hi, pivot=True, alg="lu"),
                r["ld"]) <= 1e-12
    dense = np.stack([banded.to_dense(banded.Banded(bd[g], lo, hi)).numpy()
                      for g in range(G)])
    assert _rel(x, np.linalg.solve(dense, r["mat"])) <= 1e-10
    if lo == 0:  # nothing to pivot: the unpivoted LU
        assert not swaps.any()
        assert _rel(x, banded_lu(bd, mat, lo, hi)[0]) <= 1e-14
        return
    assert swaps.sum() >= NB // 3
    if hi:
        assert not torch.isfinite(banded_lu(bd, mat, lo, hi)[0]).all()


def test_padded_solve_is_the_unpadded_one():
    """``n_active``: the canonicalized band and masked right-hand side give
    the unpadded solution on the prefix and zeros on the tail; the
    log-determinant gains exactly log|I| = 0."""
    lo, hi, k = 2, 1, 29
    bd = torch.as_tensor(_pivot_band(lo, hi, 5))
    rhs = torch.as_tensor(np.random.default_rng(6).standard_normal((G, NB,
                                                                    3)))
    garbage = bd.clone()
    garbage[:, k:] = 7.0  # padding rows and their right-hand side
    rg = rhs.clone()
    rg[:, k:] = -3.0
    na = torch.tensor(k, dtype=torch.int32)
    x = ops.banded_solve(garbage, rg, lo, hi, pivot=True, alg="lu",
                         n_active=na)
    bk = bd[:, :k].clone()
    bk[:, k - hi:, lo + 1:] = torch.where(
        torch.arange(k - hi, k)[:, None] + torch.arange(1, hi + 1)[None, :]
        < k, bk[:, k - hi:, lo + 1:], 0.0)
    xk, ldk = banded_lu_pivot_plain(bk, rhs[:, :k], lo, hi)
    assert torch.equal(x[:, :k], xk) and not x[:, k:].any()
    assert _rel(ops.banded_logdet(garbage, lo, hi, pivot=True, alg="lu",
                                  n_active=na), ldk) <= 1e-14


@pytest.fixture(scope="module")
def fitted(shared_ref):
    return fit_cache(shared_ref)


# (n, q, ties, solver, backend, precond, pivot, solve_alg, iters, learning)
GP_CASES = {
    "pcg": (60, 0, False, "pcg", "jax", "none", True, "lu", 80, True),
    "jacobi": (60, 0, False, "jacobi", "jax", "none", True, "lu", 80, False),
    "gauss_seidel": (60, 0, False, "gauss_seidel", "jax", "none", True, "lu",
                     80, False),
    "kmg": (256, 0, False, "pcg", "jax", "kmg", True, "lu", 40, False),
    "q1": (60, 1, False, "pcg", "jax", "none", True, "lu", 80, True),
}


@pytest.mark.parametrize("name", list(GP_CASES))
def test_pivoted_lu_fit_matches_jax(fitted, name):
    case = GP_CASES[name]
    cfg, gp, _, _ = fitted(*case)
    assert (gp.config.pivot, gp.config.solve_alg, gp.config.fused) == (
        True, "lu", "off")
    assert gp.config.precond == case[5]
    check_fit(fitted, case)


@pytest.mark.parametrize("name", list(GP_CASES))
def test_pivoted_lu_queries_match_jax(fitted, name):
    check_queries(fitted, GP_CASES[name], 8 if name == "kmg" else 40)


@pytest.mark.parametrize("name", ["pcg", "q1"])
def test_pivoted_lu_likelihood_and_gradients_match_jax(fitted, name):
    _, gp, _, ref = fitted(*GP_CASES[name])
    pm_v0, probe_v, V = (torch.as_tensor(p) for p in ref["probes"])
    ll, verdict = _log_likelihood(gp, pm_v0, probe_v, return_verdict=True)
    assert _rel(ll, ref["ll"]) < 1e-8 and int(verdict) == 0
    g_om, g_sg, info = _mll_gradients(gp, V, return_info=True)
    got = np.concatenate([g_om.numpy(), [float(g_sg)]])
    want = ref["grads"]
    assert np.max(np.abs(got - want)) < 1e-7 * np.max(np.abs(want))
    assert int(info.verdict) == 0


N_S, CAP_S, D_S, SIGMA_S = 24, 32, 2, 0.4
STREAM_CFG = GPConfig(q=0, solver_iters=60, precond="none", solve_alg="lu")


def _stream_data():
    rng = np.random.default_rng(31)
    X = points(rng, N_S + 1, D_S)
    Y = np.sin(2.0 * X).sum(1) + 0.1 * rng.standard_normal(N_S + 1)
    return X, Y


def _jax_band(b):
    return jbanded.Banded(jnp.asarray(b.data.numpy()), b.lo, b.hi,
                          jnp.asarray(b.n_active.numpy()))


@pytest.mark.parametrize("kind", ["insert", "evict"])
def test_patch_solve_takes_the_lu_route(monkeypatch, kind):
    """A ``solve_alg="lu"`` GP's Woodbury patch solve runs ``solve(...,
    pivot=True, alg="lu")`` (the parent hard-coded "cr"), and the windowed
    band equals the reference's ``gband_insert`` / ``gband_evict`` with
    ``alg="lu"`` on the pallas backend (its scan) from the same inputs."""
    X, Y = _stream_data()
    gp = fit(STREAM_CFG, X[:N_S], Y[:N_S], np.full(D_S, OMEGA), SIGMA_S,
             device="cpu", capacity=CAP_S)
    assert gp.config.gband == "windowed" and gp.Hband is not None
    solves, calls = [], []
    plain_solve = gband_update.solve

    def spy_solve(*a, **kw):
        solves.append((kw.get("pivot"), kw.get("alg")))
        return plain_solve(*a, **kw)

    monkeypatch.setattr(gband_update, "solve", spy_solve)
    name = "gband_" + kind
    plain_fn = getattr(st.updates, name)

    def spy_fn(*a, **kw):
        out = plain_fn(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(st.updates, name, spy_fn)
    if kind == "insert":
        st.insert(gp, X[N_S], Y[N_S], iters=60, count=N_S)
    else:
        st.evict(gp, iters=60, count=N_S)
    assert solves == [(True, "lu")]
    (args, kw, (G_, H_, _)), = calls
    assert kw["alg"] == "lu"
    Hold, A, Phi, Gold = (_jax_band(b) for b in args[:4])
    p, k_new, q = args[4:7]
    Gj, Hj, _ = getattr(jgu, name)(
        Hold, A, Phi, Gold, jnp.asarray(p.numpy()),
        jnp.asarray(k_new.numpy()), q, backend="pallas", alg="lu")
    k = int(k_new)
    assert _rel(G_.data[:, :k].numpy(), np.asarray(Gj.data)[:, :k]) <= 1e-10
    assert _rel(H_.data[:, :k].numpy(), np.asarray(Hj.data)[:, :k]) <= 1e-10


def test_fleet_lanes_equal_standalone_gps():
    """A T = 2 fleet of the pivoted-LU config: each lane's fit, mean and
    variance bit for bit its standalone GP's."""
    T, n, cap, D = 2, 20, 24, 2
    rng = np.random.default_rng(17)
    X = np.stack([points(rng, n, D) for _ in range(T)])
    Y = np.cos(2 * X).sum(-1) + 0.05 * rng.standard_normal((T, n))
    Xq = rng.uniform(0.0, 4.0, (T, 5, D))
    cfg = GPConfig(q=1, solver_iters=30, precond="none", pivot=True,
                   solve_alg="lu")
    f = fl.fleet_fit(cfg, X, Y, np.full((T, D), OMEGA), 0.3, cap,
                     device="cpu")
    mu = fl.fleet_posterior_mean(f, Xq, device="cpu")
    var = fl.fleet_posterior_var(f, Xq, device="cpu")
    for t in range(T):
        g = fit(cfg, X[t], Y[t], np.full(D, OMEGA), 0.3, device="cpu",
                capacity=cap)
        bad = []

        def cmp(a, b):
            if not torch.equal(a, b):
                bad.append(tuple(a.shape))
            return a

        fl.tree_map(cmp, f.tenant(t), g)
        assert not bad, (t, bad)
        assert torch.equal(mu[t], posterior_mean(g, Xq[t], device="cpu"))
        assert torch.equal(var[t], posterior_var(g, Xq[t], device="cpu"))


def test_matern_dense_helpers_match_jax():
    rng = np.random.default_rng(3)
    xs, xq = rng.uniform(0.0, 4.0, 30), rng.uniform(0.0, 4.0, 7)
    for q in matern.SUPPORTED_Q:
        assert matern.nu_from_q(q) == jmatern.nu_from_q(q)
        assert matern.q_from_nu(q + 0.5) == jmatern.q_from_nu(q + 0.5) == q
        g = matern.gram(q, 1.7, torch.as_tensor(xs))
        c = matern.cross(q, 1.7, torch.as_tensor(xs), torch.as_tensor(xq))
        assert _rel(g, jmatern.gram(q, 1.7, jnp.asarray(xs))) <= 1e-14
        assert _rel(c, jmatern.cross(q, 1.7, jnp.asarray(xs),
                                     jnp.asarray(xq))) <= 1e-14
    for bad in (1.0, 4.5):
        with pytest.raises(ValueError):
            matern.q_from_nu(bad)


def test_kernel_wrapper_runs_its_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is its plain version (bit for bit), and
    ``solve=False`` returns the log-determinant alone."""
    bd = torch.as_tensor(_pivot_band(2, 2, 9))
    rhs = torch.as_tensor(np.random.default_rng(9).standard_normal((G, NB,
                                                                    2)))
    x, ld = banded_lu_pivot(bd, rhs, 2, 2)
    xp, ldp = banded_lu_pivot_plain(bd, rhs, 2, 2)
    assert torch.equal(x, xp) and torch.equal(ld, ldp)
    none, ld2 = banded_lu_pivot(bd, None, 2, 2, solve=False)
    assert none is None and torch.equal(ld2, ldp)
    with pytest.raises(ValueError, match="nothing"):
        banded_lu_pivot(bd, rhs, 2, 2, solve=False, logdet=False)
