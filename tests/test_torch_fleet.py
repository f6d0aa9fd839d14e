"""The port's multi-tenant fleet (``repro_torch.core.fleet``, the fleet
mutations of ``repro_torch.streaming.updates``) on the CPU.

* Against the JAX package, at the reference's sizes (``tests/test_fleet.py``:
  q = 1, pcg, n = 10 in capacity 16, D = 2, T = 4, its "jax" backend): each
  port tenant of ``fleet_fit`` against the JAX package's standalone GP and
  its ``fleet_fit`` lane (caches, variance band, mean, variance within
  1e-10); then the JAX fleet is carried into the port
  (``fleet_from_arrays``) and ``fleet_posterior_mean`` / ``_var`` /
  ``fleet_acquisition_stats`` and a masked ``fleet_insert`` then
  ``fleet_evict`` run through both packages from that state (1e-10). The
  reference's own bitwise fleet parity fails on this tree, so the bar is a
  tolerance.
* Inside torch, bit for bit: a T = 1 fleet equals lane 0 and the single
  GP; every lane is the same at T = 1, 2, 4, 8 (fit, queries, insert,
  evict); a masked round leaves its excluded lanes as they were.
* The errors: a full selected lane on insert, a one-point selected lane on
  evict; kmg, fused "off" and the relaxation solvers fit and stack (the
  fleet's other solvers are held in ``test_torch_fleet_solvers.py``).
* The plain tenant-axis PCG (``mega_pcg_plain``, ``pcg_seed_plain`` +
  ``fused_pcg_iter_plain`` on a (T, D, npad, B) stack) against the JAX
  package's Pallas kernels under ``jax.vmap`` in interpret mode.
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
from repro.core import fleet as jfl
from repro.kernels.fused_sweep import fused_pcg_iter_pallas
from repro.kernels.mega_solve import mega_pcg_solve_pallas
from repro import streaming as jst
from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
from repro_torch.core import fleet as fl
from repro_torch.core.bayesopt import acquisition_stats
from repro_torch.core.convert import fleet_from_arrays
from repro_torch.kernels.fused_sweep import (fused_pcg_iter_plain,
                                             pcg_seed_plain)
from repro_torch.kernels.mega_solve import mega_pcg_plain
from repro_torch.streaming import (evict, fleet_evict, fleet_insert,
                                   fleet_resync, insert, resync_gband)
from torch_port_inputs import OMEGA, fleet_operands, points
from torch_port_jax_ref import (_jax_arrays, _rel,  # noqa: F401
                                fresh_jax_caches, shared_ref)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

T, N, CAP, D, M, ITERS = 4, 10, 16, 2, 4, 40
SIGMA = 0.25
CFG = GPConfig(q=1, solver="pcg", solver_iters=ITERS)
JCFG = JaxGPConfig(q=1, solver="pcg", solver_iters=ITERS, backend="jax")
DO_INS = np.array([True, False, True, True])
DO_EV = np.array([False, True, True, False])


def _data(T_, seed=0):
    """The reference's fleet sizes and targets (``tests/test_fleet.py``
    _fit_gps) on the port tests' jittered grids at omega = OMEGA, where the
    two packages' KP window SVDs agree to rounding (ROADMAP Queue 3, KP
    null-space conditioning): the reference's uniform draws at omega = 1
    leave A 1e-12 apart, and the variance band 1e-9."""
    rng = np.random.default_rng(seed)
    X = np.stack([points(rng, N, D) for _ in range(T_)])
    Y = np.cos(2 * X).sum(-1) + 0.05 * rng.standard_normal((T_, N))
    return X, Y


def _queries(T_):
    rng = np.random.default_rng(2)
    return (rng.uniform(0.0, 4.0, (T_, M, D)),
            rng.uniform(0.0, 4.0, (T_, D)), rng.standard_normal(T_))


def _canon(gp, key):
    """A GP's field as numpy: a band's canonical data, or the tensor."""
    if key in ("A", "Phi"):
        v = getattr(gp.ops, key)
    else:
        v = getattr(gp, key)
    v = v.canonical().data if hasattr(v, "canonical") else v
    return np.asarray(v)


KEYS = ("u_sy", "bY", "Gband", "A", "Phi")


@pytest.fixture(scope="module")
def jax_side(shared_ref):
    """The JAX package's fleet (fit, queries, the masked insert then evict)
    and standalone fits, as numpy, computed once per run
    (``shared_ref``)."""
    return shared_ref(("test_torch_fleet", "jax_side"), _jax_side)


def _jax_side():
    X, Y = _data(T)
    Xq, xn, yn = _queries(T)
    om, sg = np.full((T, D), OMEGA), np.full(T, SIGMA)
    jf = jfl.fleet_fit(JCFG, X, Y, om, sg, capacity=CAP)
    out = dict(fit_arrays=dict(_jax_arrays(jf.gp),
                               n_active=np.asarray(jf.gp.n_active)))
    out["fit"] = {k: _canon(jf.gp, k) for k in KEYS}
    out["mean"] = np.asarray(jfl.fleet_posterior_mean(jf, jnp.asarray(Xq)))
    out["var"] = np.asarray(jfl.fleet_posterior_var(jf, jnp.asarray(Xq)))
    out["acq"] = [np.asarray(a) for a in jfl.fleet_acquisition_stats(
        jf, jnp.asarray(Xq), 2.0, 0.3, kind="ei")]
    ji = jst.fleet_insert(jf, xn, yn, DO_INS, iters=ITERS,
                          counts=np.full(T, N))
    out["insert"] = {k: _canon(ji.gp, k) for k in KEYS}
    je = jst.fleet_evict(ji, DO_EV, iters=ITERS, counts=N + DO_INS)
    out["evict"] = {k: _canon(je.gp, k) for k in KEYS}
    out["single"] = []
    for t in range(T):
        g = jax_fit(JCFG, jnp.asarray(X[t]), jnp.asarray(Y[t]),
                    jnp.full(D, OMEGA), SIGMA, capacity=CAP)
        out["single"].append(
            ({k: _canon(g, k) for k in KEYS},
             np.asarray(jax_mean(g, jnp.asarray(Xq[t]))),
             np.asarray(jax_var(g, jnp.asarray(Xq[t])))))
    return out


@pytest.fixture(scope="module")
def port_fleet():
    X, Y = _data(T)
    return fl.fleet_fit(CFG, X, Y, np.full((T, D), OMEGA), SIGMA, CAP,
                        device="cpu")


def _close(got, want, k, tol=1e-10):
    """Agreement on the active prefix (the port keeps a canonical tail)."""
    got, want = np.asarray(got), np.asarray(want)
    sl = (..., slice(0, k), slice(None)) if got.ndim == want.ndim and \
        got.ndim >= 3 else (..., slice(0, k))
    return _rel(got[sl], want[sl]) <= tol


def test_fleet_fit_matches_jax_standalone_and_fleet(jax_side, port_fleet):
    Xq, _, _ = _queries(T)
    mu = fl.fleet_posterior_mean(port_fleet, Xq, device="cpu").numpy()
    var = fl.fleet_posterior_var(port_fleet, Xq, device="cpu").numpy()
    for t in range(T):
        g = port_fleet.tenant(t)
        single, smu, svar = jax_side["single"][t]
        for k in KEYS:
            assert _close(_canon(g, k), single[k], N), (t, k)
            assert _close(_canon(g, k), jax_side["fit"][k][t], N), (t, k)
        assert _rel(mu[t], smu) <= 1e-10 and _rel(var[t], svar) <= 1e-10
    assert _rel(mu, jax_side["mean"]) <= 1e-10
    assert _rel(var, jax_side["var"]) <= 1e-10


def test_carried_fleet_queries_and_mutations_match_jax(jax_side):
    """From the JAX fleet's own factors: queries, then a masked insert and
    a masked evict through both packages."""
    pf = fleet_from_arrays(jax_side["fit_arrays"], CFG, "cpu")
    Xq, xn, yn = _queries(T)
    assert _rel(fl.fleet_posterior_mean(pf, Xq, device="cpu").numpy(),
                jax_side["mean"]) <= 1e-10
    assert _rel(fl.fleet_posterior_var(pf, Xq, device="cpu").numpy(),
                jax_side["var"]) <= 1e-10
    acq = fl.fleet_acquisition_stats(pf, Xq, 2.0, 0.3, kind="ei",
                                     device="cpu")
    for a, b in zip(acq, jax_side["acq"]):
        assert _rel(a.numpy(), b) <= 1e-10
    pi = fleet_insert(pf, xn, yn, DO_INS, iters=ITERS, counts=np.full(T, N))
    pe = fleet_evict(pi, DO_EV, iters=ITERS, counts=N + DO_INS)
    for stage, f in (("insert", pi), ("evict", pe)):
        counts = f.counts()
        for t in range(T):
            for k in KEYS:
                assert _close(_canon(f.gp, k)[t], jax_side[stage][k][t],
                              int(counts[t])), (stage, t, k)


def _lanes_equal(a, b):
    """The fields where two GPs differ (bit for bit)."""
    bad = []

    def cmp(x, y):
        if not torch.equal(x, y):
            bad.append(tuple(x.shape))
        return x

    fl.tree_map(cmp, a, b)
    return bad


def test_one_tenant_fleet_and_lane_width_invariance(port_fleet):
    """Lane t of a fleet of the first T tenants is the same bits at T = 1,
    2, 4, 8 (fit, mean, variance, acquisition, insert, evict); at T = 1 it
    is the single GP's."""
    X, Y = _data(8)
    Xq, xn, yn = _queries(8)
    ref = None
    single = fit(CFG, X[0], Y[0], np.full(D, OMEGA), SIGMA, device="cpu",
                 capacity=CAP)
    assert not _lanes_equal(fl.tenant_gp(fl.replicate_gp(single, 3), 2),
                            single)
    single_i = insert(single, xn[0], yn[0], iters=ITERS, count=N)
    single_e = evict(single_i, iters=ITERS, count=N + 1)
    for T_ in (1, 2, 4, 8):
        f = fl.fleet_fit(CFG, X[:T_], Y[:T_], np.full((T_, D), OMEGA), SIGMA, CAP,
                         device="cpu")
        fi = fleet_insert(f, xn[:T_], yn[:T_], iters=ITERS,
                          counts=np.full(T_, N))
        fe = fleet_evict(fi, iters=ITERS, counts=np.full(T_, N + 1))
        q = (fl.fleet_posterior_mean(f, Xq[:T_], device="cpu"),
             fl.fleet_posterior_var(f, Xq[:T_], device="cpu"),
             *fl.fleet_acquisition_stats(f, Xq[:T_], 2.0, 0.3,
                                         device="cpu"))
        lanes = [(f.tenant(t), fi.tenant(t), fe.tenant(t),
                  [v[t] for v in q]) for t in range(T_)]
        if ref is None:
            ref = lanes
            assert not _lanes_equal(lanes[0][0], single)
            assert not _lanes_equal(lanes[0][1], single_i)
            assert not _lanes_equal(lanes[0][2], single_e)
            assert torch.equal(q[0][0], posterior_mean(single, Xq[0],
                                                       device="cpu"))
            assert torch.equal(q[1][0], posterior_var(single, Xq[0],
                                                      device="cpu"))
            st = acquisition_stats(single, Xq[0], 2.0, 0.3, device="cpu")
            assert all(torch.equal(a[0], b) for a, b in zip(q[2:], st))
            ref = lanes
            continue
        for t in range(min(T_, len(ref))):
            for a, b in zip(lanes[t][:3], ref[t][:3]):
                assert not _lanes_equal(a, b), (T_, t)
            assert all(torch.equal(a, b) for a, b in
                       zip(lanes[t][3], ref[t][3])), (T_, t)
        ref = lanes


def test_masked_rounds_keep_excluded_lanes(port_fleet):
    _, xn, yn = _queries(T)
    fi = fleet_insert(port_fleet, xn, yn, DO_INS, iters=ITERS,
                      counts=np.full(T, N))
    fe = fleet_evict(fi, DO_EV, iters=ITERS)
    fr = fleet_resync(fe, [True, False, False, True])
    for t in range(T):
        g0 = port_fleet.tenant(t)
        want_i = (insert(g0, xn[t], yn[t], iters=ITERS, count=N)
                  if DO_INS[t] else g0)
        assert not _lanes_equal(fi.tenant(t), want_i), t
        if not DO_INS[t]:
            assert not _lanes_equal(fi.tenant(t), g0)
        want_e = (evict(want_i, iters=ITERS, count=N + int(DO_INS[t]))
                  if DO_EV[t] else want_i)
        assert not _lanes_equal(fe.tenant(t), want_e), t
        want_r = resync_gband(want_e) if t in (0, 3) else want_e
        assert not _lanes_equal(fr.tenant(t), want_r), t
    assert list(fe.counts()) == list(N + DO_INS - DO_EV)


def test_fleet_errors(port_fleet):
    _, xn, yn = _queries(T)
    counts = np.full(T, N)
    counts[2] = CAP
    with pytest.raises(ValueError, match="full tenant lanes \\[2\\]"):
        fleet_insert(port_fleet, xn, yn, counts=counts)
    # an unselected full lane is fine (and comes back unchanged)
    out = fleet_insert(port_fleet, xn, yn, [True, True, False, True],
                       iters=ITERS, counts=counts)
    assert not _lanes_equal(out.tenant(2), port_fleet.tenant(2))
    counts[:] = N
    counts[1] = 1
    with pytest.raises(ValueError, match="single observation"):
        fleet_evict(port_fleet, counts=counts)
    # kmg, fused "off" and the relaxation solvers, which raised before
    # the fleet took them, now fit and stack, each lane its standalone GP
    X, Y = _data(2)
    for cfg in (GPConfig(q=0, precond="kmg"), GPConfig(q=1, fused="off"),
                GPConfig(q=1, solver="jacobi"),
                GPConfig(q=1, solver="gauss_seidel")):
        f = fl.fleet_fit(cfg, X, Y, np.full(D, OMEGA), SIGMA, CAP,
                         device="cpu")
        gs = [fit(cfg, X[t], Y[t], np.full(D, OMEGA), SIGMA, device="cpu")
              for t in range(2)]
        stacked = fl.stack_gps(gs, capacity=CAP)
        for t in range(2):
            want = fit(cfg, X[t], Y[t], np.full(D, OMEGA), SIGMA,
                       device="cpu", capacity=CAP)
            assert not _lanes_equal(f.tenant(t), want), (cfg, t)
            assert not _lanes_equal(stacked.tenant(t), want), (cfg, t)


def test_tenant_axis_plain_pcg_matches_vmapped_pallas():
    """The plain versions over a (T, D, npad, B) stack against the JAX
    package's whole-solve and one-iteration Pallas kernels under
    ``jax.vmap`` (the batching rule prepends the tenant axis to the grid),
    interpret mode, at one small shape each."""
    rng = np.random.default_rng(31)
    fs, v, x0, _ = fleet_operands(rng, 2, 24, 2, 1, "cpu", 2)
    ops = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    v_p = fs.pad_state(torch.as_tensor(v))
    x0_p = fs.pad_state(torch.as_tensor(x0))
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s)
    jops = tuple(jnp.asarray(t.numpy()) for t in ops[:5]) + (
        jnp.asarray(fs.sigma2.numpy().reshape(2, 1, 1)),)
    x, r, it = mega_pcg_plain(*ops, v_p, x0_p, iters=8, warm=True, **kw)
    jx, jr, jit = jax.vmap(lambda *a: mega_pcg_solve_pallas(
        *a, iters=8, warm=True, interpret=True, **kw))(
        *jops, jnp.asarray(v_p.numpy()), jnp.asarray(x0_p.numpy()))
    assert list(it.numpy()) == list(np.asarray(jit)) == [8, 8]
    assert _rel(x.numpy(), jx) < 1e-12
    scale = float(v_p.abs().max())
    assert float(np.max(np.abs(r.numpy() - np.asarray(jr)))) / scale < 1e-12
    state = pcg_seed_plain(*ops, v_p, x0_p, warm=True, **kw)
    ours = fused_pcg_iter_plain(*ops, *state, **kw)
    ref = jax.vmap(lambda *a: fused_pcg_iter_pallas(*a, interpret=True,
                                                    **kw))(
        *jops, *(jnp.asarray(t.numpy()) for t in state))
    scales = [None, float(state[1].abs().max()), None, None]
    for a, b, sc in zip(ours, ref, scales):
        err = _rel(a.numpy(), b) if sc is None else float(
            np.max(np.abs(a.numpy() - np.asarray(b)))) / sc
        assert err < 1e-12
