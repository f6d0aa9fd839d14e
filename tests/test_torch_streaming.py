"""The port's streaming updates (paper Sec. 6) and serving engine against
the JAX package and against fresh fits, on the CPU.

* One JAX fit (its "jax" backend, n = 24 jittered points in capacity 32,
  D = 2, q = 0): the port's own padded fit of the same data agrees with it
  (bands 1e-10 relative, caches, mean and variance 1e-8); then the JAX fit
  is carried into the port (``gp_from_arrays``), and the same
  three inserts and two evicts run through both packages from that state:
  the factors agree within 1e-11 (the window rows come from the same SVD
  problems), the sorted coordinates and permutations exactly, the warm
  solves' caches and the posterior mean and variance within 1e-8, the
  windowed variance band within 1e-10 relative.
* The port's own inserts against its fresh fit of the grown data (the
  reference's bar, 1e-6 on mean and variance with the warm solve at the
  fit's iterations), at the domain's edges and on tied coordinates.
* ``refresh_local_cache`` in "copy" and "window" modes; the engine's fence,
  versioning, over-evict, window drain and capacity doubling; the
  incremental ``bayes_opt_loop`` against the refit loop.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPConfig as JaxGPConfig
from repro.core import fit as jax_fit
from repro.core import posterior_mean as jax_mean
from repro.core import posterior_var as jax_var
from repro import streaming as jst
from repro_torch import streaming as st
from repro_torch.core import (GPConfig, fit, gp_from_arrays, posterior_mean,
                              posterior_var)
from repro_torch.core import bayesopt as bo
from torch_port_inputs import OMEGA, points
from torch_port_jax_ref import (_jax_arrays, _rel,  # noqa: F401
                                fresh_jax_caches, shared_ref)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

N, CAP, D, SIGMA, ITERS = 24, 32, 2, 0.4, 60
CFG = GPConfig(q=0, solver_iters=ITERS, precond="none")


def _data(n, seed, extra=4):
    rng = np.random.default_rng(seed)
    X = points(rng, n + extra, D)
    Y = np.sin(2.0 * X).sum(1) + 0.1 * rng.standard_normal(n + extra)
    return X, Y, rng.uniform(0.0, 4.0, (9, D))


def _arrays(gp):
    """A GP's factors, order and caches as numpy, the bands canonical."""
    out = {k: np.asarray(getattr(gp, k)) for k in ("xs", "u_sy", "bY")}
    out["sort_idx"] = np.asarray(gp.ops.sort_idx)
    out["rank_idx"] = np.asarray(gp.ops.rank_idx)
    for k, b in dict(A=gp.ops.A, Phi=gp.ops.Phi, B=gp.B, Psi=gp.Psi,
                     Gband=gp.Gband).items():
        out[k] = np.asarray(b.canonical().data)
    return out


@pytest.fixture(scope="module")
def carried(shared_ref):
    """The same mutations through both packages from one carried state:
    {stage: (port arrays, JAX arrays, port mean/var, JAX mean/var, k)};
    computed once per run (``shared_ref``)."""
    return shared_ref(("test_torch_streaming", "carried"), _carried)


def _carried():
    X, Y, Xq = _data(N, 21)
    om = np.full(D, OMEGA)
    jgp = jax_fit(JaxGPConfig(q=0, solver_iters=ITERS, backend="jax",
                              precond="none"), jnp.asarray(X[:N]),
                  jnp.asarray(Y[:N]), jnp.asarray(om), SIGMA, capacity=CAP)
    gp = fit(CFG, X[:N], Y[:N], om, SIGMA, device="cpu", capacity=CAP)
    out = {}

    def record(stage, k):
        out[stage] = (
            _arrays(gp), _arrays(jgp),
            (posterior_mean(gp, Xq, device="cpu").numpy(),
             posterior_var(gp, Xq, device="cpu").numpy()),
            (np.asarray(jax_mean(jgp, jnp.asarray(Xq))),
             np.asarray(jax_var(jgp, jnp.asarray(Xq)))), k)

    record("fit", N)
    gp = gp_from_arrays(dict(_jax_arrays(jgp),
                             n_active=np.asarray(jgp.n_active)), CFG, "cpu")
    assert gp.num_points() == N and gp.n == CAP
    k = N
    for i in range(3):
        jgp = jst.insert(jgp, jnp.asarray(X[N + i]), Y[N + i], iters=ITERS,
                         count=k)
        gp = st.insert(gp, X[N + i], Y[N + i], iters=ITERS, count=k)
        k += 1
    record("insert", k)
    for _ in range(2):
        jgp = jst.evict(jgp, iters=ITERS, count=k)
        gp = st.evict(gp, iters=ITERS, count=k)
        k -= 1
    record("evict", k)
    return out


@pytest.mark.parametrize("stage", ["fit", "insert", "evict"])
def test_mutations_match_jax_from_one_carried_state(carried, stage):
    """"fit": the port's own padded fit against the JAX package's (bands
    1e-10, the fit's own SVDs); "insert", "evict": after the mutations
    from the carried JAX state (factors 1e-11, band 1e-10)."""
    ours, ref, (mu, var), (jmu, jvar), k = carried[stage]
    for key in ("sort_idx", "rank_idx"):
        assert np.array_equal(ours[key][:, :k], ref[key][:, :k]), key
    assert np.array_equal(ours["xs"][:, :k], ref["xs"][:, :k])
    tol = 1e-10 if stage == "fit" else 1e-11
    for key in ("A", "Phi", "B", "Psi"):
        assert _rel(ours[key][:, :k], ref[key][:, :k]) <= tol, key
    assert _rel(ours["Gband"][:, :k], ref["Gband"][:, :k]) <= 1e-10
    for key in ("u_sy", "bY"):
        assert _rel(ours[key], ref[key]) <= 1e-8, key
    assert _rel(mu, jmu) <= 1e-8 and _rel(var, jvar) <= 1e-8


def test_inserts_match_fresh_fit_at_edges_then_ties_stay_sorted():
    X, Y, Xq = _data(N, 22, extra=0)
    om = np.full(D, OMEGA)
    gp = fit(CFG, X, Y, om, SIGMA, device="cpu", capacity=CAP)
    lo, hi = X.min(0), X.max(0)
    Xg, Yg = X, Y
    for i, x in enumerate([lo - 0.05, hi + 0.05]):  # the domain's edges
        gp = st.insert(gp, x, 0.1 * i, iters=ITERS, count=N + i)
        Xg = np.concatenate([Xg, x[None]])
        Yg = np.concatenate([Yg, [0.1 * i]])
    k = N + 2
    ref = fit(CFG, Xg, Yg, om, SIGMA, device="cpu")
    for a, b in [(gp.ops.A, ref.ops.A), (gp.ops.Phi, ref.ops.Phi),
                 (gp.B, ref.B), (gp.Psi, ref.Psi)]:
        assert float((a.data[:, :k] - b.data).abs().max()) <= 1e-11
    assert float((posterior_mean(gp, Xq, device="cpu")
                  - posterior_mean(ref, Xq, device="cpu")).abs().max()) <= 1e-6
    assert float((posterior_var(gp, Xq, device="cpu")
                  - posterior_var(ref, Xq, device="cpu")).abs().max()) <= 1e-6
    # the same coordinate inserted twice more: separated by the tie bump,
    # strictly sorted, finite
    for i in range(2):
        gp = st.insert(gp, X[3], 0.5, iters=ITERS, count=k + i)
    xs = gp.xs[:, :k + 2]
    assert torch.isfinite(xs).all() and bool((xs[:, 1:] > xs[:, :-1]).all())
    assert torch.isfinite(posterior_mean(gp, Xq, device="cpu")).all()


@pytest.mark.parametrize("mode", ["copy", "window"])
def test_refresh_local_cache(mode):
    X, Y, _ = _data(16, 23, extra=1)
    om = np.full(D, OMEGA)
    gp = fit(CFG, X[:16], Y[:16], om, SIGMA, device="cpu")
    cache = bo.build_local_cache(gp)
    grown = st.insert(gp, X[16], Y[16], iters=ITERS)
    assert grown.num_points() == grown.n == 17  # full: re-homed one larger
    new = st.refresh_local_cache(grown, cache, mode=mode)
    exact = bo.build_local_cache(grown).M_tilde
    M = new.M_tilde
    assert M.shape == exact.shape
    p = grown.ops.rank_idx[:, 16]
    if mode == "copy":
        # the new row and column copy the sorted neighbour's entries
        for d in range(D):
            pd = int(p[d])
            nb = pd + 1 if pd < 16 else pd - 1
            assert torch.equal(M[d, pd], M[d, nb])
        return
    R = 2 * grown.config.q + 4
    for e in range(D):
        cols = slice(max(int(p[e]) - R, 0), int(p[e]) + R + 1)
        assert float((M[:, :, e, cols] - exact[:, :, e, cols]).abs().max()
                     ) <= 1e-8 * float(exact.abs().max())


@pytest.fixture(scope="module")
def engine_gp():
    X, Y, _ = _data(12, 24, extra=8)
    gp = fit(GPConfig(q=0, solver_iters=40, precond="none"), X[:12], Y[:12],
             np.full(D, OMEGA), SIGMA, device="cpu")
    return gp, X, Y, np.array([[0.0, 4.0]] * D)


def test_engine_serves_queries_with_fence_and_versions(engine_gp):
    gp, X, Y, bounds = engine_gp
    eng = st.GPServeEngine(gp, bounds, batch_slots=2, insert_iters=40)
    assert eng.capacity == 16 and eng.num_points == 12
    q0 = [eng.submit(X[i], kind) for i, kind in
          enumerate(["mean", "var", "acq"])]
    first = eng.step()  # admits (and retires) two; the third waits
    eng.insert(X[12], Y[12])  # staged: fences admission
    q1 = eng.submit(X[0], "mean")
    done = eng.run_until_done()
    assert all(q.done for q in q0 + [q1])
    assert len(first) == 2 and len(done) == 2
    assert [q.result["version"] for q in q0] == [0, 0, 1]
    assert q1.result["version"] == 1 and eng.num_points == 13
    want = posterior_mean(eng.gp, X[:1], device="cpu")
    assert q1.result["mean"] == float(want[0])
    a = eng.submit(X[1], "ascend", steps=3)
    eng.run_until_done()
    assert a.done and np.all(a.result["x"] >= 0) and np.all(
        a.result["x"] <= 4)


def test_engine_over_evict_window_drain_and_doubling(engine_gp):
    gp, X, Y, bounds = engine_gp
    eng = st.GPServeEngine(gp, bounds, batch_slots=2, insert_iters=10)
    for _ in range(11):
        eng.evict()
    with pytest.raises(ValueError, match="below one"):
        eng.evict()  # fails at stage time; the fence stays healthy
    q = eng.submit(X[0], "mean")
    eng.run_until_done()
    assert q.done and eng.num_points == 1 and eng.version == 11
    # a replacement fitted at a larger capacity re-homes the engine
    big = fit(gp.config, X[:12], Y[:12], np.full(D, OMEGA), SIGMA,
              device="cpu", capacity=64)
    eng.set_posterior(big)
    q = eng.submit(X[0], "mean")
    eng.run_until_done()
    assert eng.capacity == 64 and eng.num_points == 12
    assert q.result["mean"] == float(posterior_mean(big, X[:1],
                                                    device="cpu")[0])
    # window mode drains an engine built above its window down to it
    w = st.GPServeEngine(gp, bounds, batch_slots=2, insert_iters=10,
                         window=6)
    w.insert(X[12], Y[12])
    w.step()
    assert w.num_points == 6 and w.capacity == 12  # no growth
    assert float(w.gp.X[5, 0]) == float(X[12, 0])  # the newest is last
    # inserts past the tier re-home into a doubled allocation
    g = st.GPServeEngine(gp, bounds, batch_slots=2, insert_iters=10,
                         capacity=13)
    for i in range(3):
        g.insert(X[12 + i], Y[12 + i])
    g.step()
    assert g.num_points == 15 and g.capacity == 32 and g.version == 3


def test_bayes_opt_incremental_matches_refit():
    """Two rounds of the streaming loop (warm inserts converged at the fit's
    iterations) propose what the refit loop proposes."""
    def f(x):
        return float(np.sum(np.cos(2.0 * x)))

    bounds = np.array([[0.0, 2.0]] * D)
    kw = dict(ascent_steps=3, n_starts=2, refit_every=0, insert_iters=30)
    runs = []
    for inc, eng in ((True, True), (True, False), (False, False)):
        runs.append(bo.bayes_opt_loop(
            f, bounds, 2, GPConfig(q=0, solver_iters=30, precond="none"),
            bo.BOConfig(incremental=inc, use_engine=eng, **kw),
            torch.Generator().manual_seed(3), n_init=8, device="cpu"))
    for _, X, Y, hist in runs[:2]:
        assert _rel(X.numpy(), runs[2][1].numpy()) <= 1e-6
        assert _rel(hist["best"], runs[2][3]["best"]) <= 1e-6
    assert runs[0][0].num_points() == 10
