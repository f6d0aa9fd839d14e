"""The fleet's other solvers on the CPU: the relaxation solvers in every
fused mode, the unfused host loops ("off") and the kmg preconditioner over
a tenant axis (``repro_torch.core.fleet``, ``precond.coarse``,
``precond.vcycle``, the tenant axis of ``csrc/jacobi.cu`` and
``csrc/gauss_seidel.cu`` through their plain versions).

* Against the JAX package (T = 3, D = 3 on the port tests' jittered grids,
  omega = OMEGA): ``fleet_fit`` -> ``fleet_posterior_mean`` /
  ``fleet_posterior_var`` lane by lane against the JAX package's
  ``fleet_fit`` and queries within 1e-10, for Jacobi and Gauss-Seidel in
  "whole", "on" and "off", pcg "off", an explicit ``precond="kmg"`` and the
  default ``GPConfig()`` (kmg at q = 0 once ``KMG_AUTO_MIN_N`` is lowered
  to the test's size, in both packages), one q = 1 and one q = 3 "whole"
  case. The JAX fleet runs every one of these configs, so none is held to
  standalone fits instead. Then a fleet of mixed counts in one capacity
  (the JAX package's ``stack_gps``, carried into the port) through the
  queries and a masked ``fleet_insert`` then ``fleet_evict`` in both
  packages, per new path, each stage a case of its own.
* The plain tenant-axis relaxation kernels (one sweep and the whole solve,
  Jacobi and Gauss-Seidel) against the JAX package's Pallas kernels #7,
  #8, #10 and #11 under ``jax.vmap`` in interpret mode.
* Inside torch, bit for bit: a T = 1 fleet equals the single GP, every
  lane its standalone GP; a restriction map padded to a wider K leaves the
  V-cycle's bits; tenants that leave a tol-exit pcg at different
  iterations each get their standalone count and x.

Each case is a parametrised test, so the cases spread over the workers;
the JAX side of each is computed once per run (``shared_ref``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jax_kops
from repro.core import GPConfig as JaxGPConfig
from repro.core import fit as jax_fit
from repro.core import fleet as jfl
from repro import streaming as jst
from repro.kernels.fused_sweep import (fused_gauss_seidel_iter_pallas,
                                       fused_jacobi_iter_pallas)
from repro.kernels.mega_solve import (mega_gauss_seidel_solve_pallas,
                                      mega_jacobi_solve_pallas)
import repro_torch.kernels.ops as kops
from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
from repro_torch.core.additive_gp import mean_caches
from repro_torch.core import fleet as fl
from repro_torch.core.backfitting import solve_mhat
from repro_torch.core.convert import fleet_from_arrays
from repro_torch.kernels.fused_sweep import (fused_gauss_seidel_iter_plain,
                                             fused_jacobi_iter_plain)
from repro_torch.kernels.mega_solve import (mega_gauss_seidel_plain,
                                            mega_jacobi_plain)
from repro_torch.masking import mask_rows
from repro_torch.precond.coarse import pad_restriction
from repro_torch.precond.vcycle import kmg_preconditioner, restrict
from repro_torch.streaming import fleet_evict, fleet_insert
from torch_port_inputs import OMEGA, fleet_operands, points
from torch_port_jax_ref import SIGMA as REF_SIGMA
from torch_port_jax_ref import _data as ref_data
from torch_port_jax_ref import (_jax_arrays, _rel,  # noqa: F401
                                fresh_jax_caches, shared_ref)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

T, D, N, CAP, M = 3, 3, 200, 256, 5
SIGMAS = np.array([0.2, 0.25, 0.35])
# the relaxation solvers run a fixed count; pcg and kmg run to rounding
# (at 80 iterations a warm insert's solve leaves 3e-10 between the two
# packages here, at 200 1e-14), so the two frameworks' summation orders do
# not grow through unconverged CG steps
RELAX_ITERS, PCG_ITERS = 30, 200
# the tests inside torch hold bits, which any iteration count shows: their
# pcg and kmg solves stop at the GPs' default count
BITWISE_PCG_ITERS = 50


def _data(T_, n, seed=0):
    rng = np.random.default_rng(seed)
    X = np.stack([points(rng, n, D) for _ in range(T_)])
    Y = np.cos(2 * X).sum(-1) + 0.05 * rng.standard_normal((T_, n))
    Xq = rng.uniform(0.0, 4.0, (T_, M, D))
    return X, Y, Xq


def _cfgs(solver, fused, q=0, precond="none"):
    """The port's and the JAX package's configs of one case (the JAX fused
    kernels run on its pallas backend, the unfused loops on "jax")."""
    iters = PCG_ITERS if solver == "pcg" else RELAX_ITERS
    kw = dict(q=q, solver=solver, solver_iters=iters, fused=fused,
              precond=precond)
    backend = "pallas" if fused in ("whole", "on") else "jax"
    return GPConfig(**kw), JaxGPConfig(backend=backend, **kw)


def _jax_lanes(jf, Xq):
    """What the lane checks read of a JAX fleet, as numpy: its queries at
    Xq, its caches, and its arrays (to carry its state into the port)."""
    return dict(mean=np.asarray(jfl.fleet_posterior_mean(jf, jnp.asarray(Xq))),
                var=np.asarray(jfl.fleet_posterior_var(jf, jnp.asarray(Xq))),
                u_sy=np.asarray(jf.gp.u_sy), bY=np.asarray(jf.gp.bY),
                arrays=dict(_jax_arrays(jf.gp),
                            n_active=np.asarray(jf.gp.n_active)),
                config=jf.gp.config)


def _lane_gaps(pf, ref, Xq, n_act):
    """Each port lane's caches and queries against the JAX fleet's lane
    (``ref``: :func:`_jax_lanes`): the worst relative gap of each (mean,
    var, u_sy, bY)."""
    gaps = {
        "mean": _rel(fl.fleet_posterior_mean(pf, Xq, device="cpu").numpy(),
                     ref["mean"]),
        "var": _rel(fl.fleet_posterior_var(pf, Xq, device="cpu").numpy(),
                    ref["var"])}
    for key in ("u_sy", "bY"):
        gaps[key] = max(
            _rel(getattr(pf.gp, key)[t][..., :int(n_act[t])].numpy(),
                 ref[key][t][..., :int(n_act[t])])
            for t in range(pf.T))
    return gaps


def _lanes_close(pf, ref, Xq, n_act):
    return max(_lane_gaps(pf, ref, Xq, n_act).values())


def _carried(ref, cfg):
    """The JAX fleet's own state (its factors) carried into the port."""
    return fleet_from_arrays(ref["arrays"], cfg, "cpu")


def _jax_fleet_fit(jcfg, n=N, cap=CAP):
    """The JAX package's ``fleet_fit`` of the module's data, as numpy."""
    X, Y, Xq = _data(T, n)
    jf = jfl.fleet_fit(jcfg, X, Y, np.full((T, D), OMEGA), SIGMAS,
                       capacity=cap)
    return _jax_lanes(jf, Xq)


def _fleet_fit_case(shared, solver, fused, q, precond, carried_var=False):
    """One case's port ``fleet_fit`` against the JAX package's, lane by
    lane within 1e-10. ``carried_var``: the variance from the JAX fleet's
    own factors carried into the port (the q = 1 case below)."""
    X, Y, Xq = _data(T, N)
    cfg, jcfg = _cfgs(solver, fused, q, precond)
    pf = fl.fleet_fit(cfg, X, Y, np.full((T, D), OMEGA), SIGMAS, CAP,
                      device="cpu")
    ref = shared(("test_torch_fleet_solvers", "fleet_fit", jcfg),
                 lambda: _jax_fleet_fit(jcfg))
    gaps = _lane_gaps(pf, ref, Xq, np.full(T, N))
    if carried_var:
        gaps["var"] = _lane_gaps(_carried(ref, cfg), ref, Xq,
                                 np.full(T, N))["var"]
    bad = {k: g for k, g in gaps.items() if not g <= 1e-10}
    assert not bad, bad


@pytest.mark.parametrize("fused", ["whole", "on", "off"])
def test_jacobi_fleets_match_jax(shared_ref, fused):
    _fleet_fit_case(shared_ref, "jacobi", fused, 0, "none")


@pytest.mark.parametrize("fused", ["whole", "on", "off"])
def test_gauss_seidel_fleets_match_jax(shared_ref, fused):
    _fleet_fit_case(shared_ref, "gauss_seidel", fused, 0, "none")


@pytest.mark.parametrize("case", ["pcg-off", "kmg", "default"])
def test_unfused_and_kmg_fleets_match_jax(shared_ref, case):
    """pcg "off", an explicit kmg, and the default path: ``GPConfig()``
    resolves to kmg (unfused) at this n once both packages'
    ``KMG_AUTO_MIN_N`` is lowered to it, as it does at n >= 4096. Against
    the JAX package the default path runs ``PCG_ITERS`` iterations: at its
    default 50 the solve stops at a relative residual of ~1e-8 here, where
    one standalone GP of each package already differs by ~3e-7 (the
    unconverged CG grows the summation orders' gap; ~1e-12 at 80).
    ``GPConfig()`` itself is held bit for bit against the port's
    standalone fits. The JAX package's default fleet resolves to the
    explicit kmg case's config, and shares its fit."""
    if case != "default":
        _fleet_fit_case(shared_ref, "pcg", *(("off", 0, "none")
                                             if case == "pcg-off"
                                             else ("auto", 0, "kmg")))
        return
    X, Y, Xq = _data(T, N)
    om = np.full((T, D), OMEGA)
    old = (kops.KMG_AUTO_MIN_N, jax_kops.KMG_AUTO_MIN_N)
    kops.KMG_AUTO_MIN_N = jax_kops.KMG_AUTO_MIN_N = N
    try:
        pf = fl.fleet_fit(GPConfig(solver_iters=PCG_ITERS), X, Y, om, SIGMAS,
                          CAP, device="cpu")
        # the JAX default config, its precond resolved as its fleet_fit
        # resolves it, is the explicit kmg case's config: the same fleet
        jcfg = _cfgs("pcg", "auto", 0, "kmg")[1]
        assert dataclasses.replace(
            JaxGPConfig(backend="jax", solver_iters=PCG_ITERS),
            precond=jax_kops.resolve_precond("auto", q=0, n=N)) == jcfg
        ref = shared_ref(("test_torch_fleet_solvers", "fleet_fit", jcfg),
                         lambda: _jax_fleet_fit(jcfg))
        fd = fl.fleet_fit(GPConfig(), X, Y, om, SIGMAS, CAP, device="cpu")
        same = [torch.equal(fd.tenant(t).u_sy, fit(
            GPConfig(), X[t], Y[t], om[t], SIGMAS[t], device="cpu",
            capacity=CAP).u_sy) for t in range(T)]
    finally:
        kops.KMG_AUTO_MIN_N, jax_kops.KMG_AUTO_MIN_N = old
    for f in (pf, fd):
        assert (f.config.precond, f.config.fused) == ("kmg", "off")
    assert ref["config"].precond == "kmg"
    assert _lanes_close(pf, ref, Xq, np.full(T, N)) <= 1e-10
    assert all(same), same


@pytest.mark.parametrize("q", [1, 3])
def test_q1_and_q3_fleets_match_jax(shared_ref, q):
    """q = 1 (Jacobi "whole") at the module's size; q = 3 (Gauss-Seidel
    "whole", the half-width-4 kernels) on ``test_torch_gp_q3.py``'s data
    (n = 37, sigma 0.5). At q = 1 the two packages' KP factors (batched
    SVDs) differ by ~1e-11 here, and the variance's cancellation
    (prior - term2 + term3) takes that to ~2e-10 for one GP of each package
    alike, at any iteration count (the JAX fleet's lanes equal its single
    GPs bit for bit): so at q = 1 the variance is compared from the JAX
    fleet's own factors, carried into the port; the caches, bY and mean
    from the port's own fit. At q = 3 the two packages' KP null spaces
    differ (ROADMAP Queue 3), so the q = 3 fleet starts from the JAX fleet's
    factors, as ``test_torch_gp_q3.py`` does for one GP: the port redoes
    the fleet's mean solve (the plain tenant-axis Gauss-Seidel) and its
    variance solves, at 8 queries a tenant: at 5 the reference's own
    Gauss-Seidel "whole" variance diverges here (4.5e46 at 30 sweeps;
    1, 2, 4, 8, 16, 32 and 40 queries agree with its unfused loop,
    ``scripts/ref_gs_q3_queries.py``, ROADMAP Queue 3), which the port's
    does not."""
    if q == 1:
        _fleet_fit_case(shared_ref, "jacobi", "whole", 1, "none",
                        carried_var=True)
        return
    cfg, jcfg = _cfgs("gauss_seidel", "whole", 3)
    data = [ref_data(37, 140 + t) for t in range(T)]
    X, Y = np.stack([d[0] for d in data]), np.stack([d[1] for d in data])
    Xq = np.stack([d[2][:8] for d in data])
    jf = jfl.fleet_fit(jcfg, X, Y, np.full((T, D), OMEGA), REF_SIGMA,
                       capacity=48)
    ref = _jax_lanes(jf, Xq)
    pf = _carried(ref, cfg)
    u_sy, bY = mean_caches(pf.config, pf.gp.ops, pf.gp.Y)
    pf = fl.GPFleet(gp=dataclasses.replace(pf.gp, u_sy=u_sy, bY=bY))
    assert pf.gp.ops.SAPhi.lo == 4
    gaps = _lane_gaps(pf, ref, Xq, np.full(T, 37))
    assert max(gaps.values()) <= 1e-10, gaps


MIXED = [("jacobi", "whole", "none"), ("gauss_seidel", "on", "none"),
         ("pcg", "off", "none"), ("pcg", "auto", "kmg")]


def _mixed_inputs():
    counts = np.array([N, N - 30, N - 60])
    X, Y, Xq = _data(T, N, seed=4)
    rng = np.random.default_rng(5)
    xn, yn = rng.uniform(0.0, 4.0, (T, D)), rng.standard_normal(T)
    do_i, do_e = np.array([True, False, True]), np.array([False, True, True])
    return counts, X, Y, Xq, xn, yn, do_i, do_e


MIXED_STAGES = ("queries", "insert", "evict")


def _jax_mixed_fleet(shared, jcfg, stage):
    """The JAX package's ``stack_gps`` of the standalone fits at the mixed
    counts, each fit computed once per run. Each stage asks for the lanes
    starting at its own index, so the three fits (each an XLA compilation
    at its own size) are made on three workers at once."""
    counts, X, Y, *_ = _mixed_inputs()

    def one_fit(t):
        c = counts[t]
        return jax_fit(jcfg, jnp.asarray(X[t, :c]), jnp.asarray(Y[t, :c]),
                       jnp.full(D, OMEGA), float(SIGMAS[t]), capacity=CAP)

    first = MIXED_STAGES.index(stage)
    gps = {}
    for t in np.roll(np.arange(T), -first):
        gps[t] = shared(("test_torch_fleet_solvers", "mixed fit", jcfg,
                         int(t)), lambda: one_fit(t))
    return jfl.stack_gps([gps[t] for t in range(T)])


def _jax_mixed(shared, jcfg, stage):
    """The JAX side of one stage of a mixed-count case, as
    :func:`_jax_lanes`: the stacked fits' queries, the masked insert's
    result, or the masked evict's after that insert (the insert computed
    once per run for both)."""
    counts, _, _, Xq, xn, yn, do_i, do_e = _mixed_inputs()
    jf = _jax_mixed_fleet(shared, jcfg, stage)
    if stage == "queries":
        return _jax_lanes(jf, Xq)
    iters = jcfg.solver_iters
    ji = shared(("test_torch_fleet_solvers", "mixed insert", jcfg),
                lambda: jst.fleet_insert(jf, xn, yn, do_i, iters=iters,
                                         counts=counts))
    if stage == "insert":
        return _jax_lanes(ji, Xq)
    return _jax_lanes(jst.fleet_evict(ji, do_e, iters=iters,
                                      counts=counts + do_i), Xq)


@pytest.mark.parametrize("stage", MIXED_STAGES)
@pytest.mark.parametrize("solver,fused,precond", MIXED)
def test_mixed_count_fleet_mutations_match_jax(shared_ref, solver, fused,
                                               precond, stage):
    """A fleet of mixed counts in one capacity (the JAX package's
    ``stack_gps`` of standalone fits, carried into the port), per new path
    and per stage: the queries, then a masked insert, then a masked evict
    after that insert, through both packages from that one state, each
    lane within 1e-10."""
    counts, X, Y, Xq, xn, yn, do_i, do_e = _mixed_inputs()
    cfg, jcfg = _cfgs(solver, fused, 0, precond)
    jf = _jax_mixed_fleet(shared_ref, jcfg, stage)
    pf = _carried(dict(arrays=dict(_jax_arrays(jf.gp),
                                   n_active=np.asarray(jf.gp.n_active))), cfg)
    ref = _jax_mixed(shared_ref, jcfg, stage)
    if stage == "queries":
        gap = _lanes_close(pf, ref, Xq, counts)
    else:
        iters = cfg.solver_iters
        pf = fleet_insert(pf, xn, yn, do_i, iters=iters, counts=counts)
        n_act = counts + do_i
        if stage == "evict":
            pf = fleet_evict(pf, do_e, iters=iters, counts=n_act)
            n_act = n_act - do_e
        gap = _lanes_close(pf, ref, Xq, n_act)
        assert list(pf.counts()) == list(n_act)
    assert gap <= 1e-10, (stage, gap)


@pytest.mark.parametrize("q", [0, 1])
def test_tenant_axis_plain_relaxation_matches_vmapped_pallas(q):
    """The plain Jacobi and Gauss-Seidel sweep and whole solve over a
    (T, D, npad, B) stack against the JAX package's Pallas kernels
    (``fused_jacobi_iter_pallas`` #7, ``fused_gauss_seidel_iter_pallas``
    #8, ``mega_jacobi_solve_pallas`` #10, ``mega_gauss_seidel_solve_pallas``
    #11) under ``jax.vmap``, interpret mode, q = 0 and 1."""
    rng = np.random.default_rng(37 + q)
    fs, v, x0, _ = fleet_operands(rng, 2, 24, 2, q, "cpu", 2)
    ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    v_p = fs.pad_state(torch.as_tensor(v))
    x0_p = fs.pad_state(torch.as_tensor(x0))
    k_p = 0.1 * x0_p
    kw = dict(w_p=fs.w_p, w_s=fs.w_s)
    jops = tuple(jnp.asarray(t.numpy()) for t in ops[:4]) + (
        jnp.asarray(fs.sigma2.numpy().reshape(2, 1, 1)),)
    jv, jx0, jk = (jnp.asarray(t.numpy()) for t in (v_p, x0_p, k_p))

    def vm(fn, *states, **extra):
        return jax.vmap(lambda *a: fn(*a, interpret=True, **kw,
                                      **extra))(*jops, *states)

    pairs = {
        "jacobi sweep": (
            fused_jacobi_iter_plain(*ops, v_p, x0_p, k_p, alpha=0.4, **kw),
            vm(fused_jacobi_iter_pallas, jv, jx0, jk, alpha=0.4,
               want_resid=True)),
        "gauss_seidel sweep": (
            fused_gauss_seidel_iter_plain(*ops, v_p, x0_p, want_resid=True,
                                          **kw),
            vm(fused_gauss_seidel_iter_pallas, jv, jx0, want_resid=True)),
        "jacobi whole warm": (
            mega_jacobi_plain(*ops, v_p, x0_p, alpha=0.5, iters=6,
                              warm=True, **kw),
            vm(mega_jacobi_solve_pallas, jv, jx0, alpha=0.5, iters=6,
               warm=True)),
        "gauss_seidel whole": (
            mega_gauss_seidel_plain(*ops, v_p, x0_p, iters=6, **kw),
            vm(mega_gauss_seidel_solve_pallas, jv, jx0, iters=6)),
    }
    bad = []
    for name, (ours, ref) in pairs.items():
        gap = max(_rel(a.numpy(), np.asarray(b)) for a, b in zip(ours, ref))
        if not gap < 1e-12:
            bad.append((name, gap))
    assert not bad, bad


# ---------------------------------------------------------------------------
# inside torch, bit for bit
# ---------------------------------------------------------------------------

BITWISE_CASES = (("jacobi", "whole", "none"), ("jacobi", "on", "none"),
                 ("jacobi", "off", "none"), ("gauss_seidel", "whole", "none"),
                 ("gauss_seidel", "on", "none"),
                 ("gauss_seidel", "off", "none"), ("pcg", "off", "none"),
                 ("pcg", "auto", "kmg"))


@pytest.mark.parametrize("solver,fused,precond", BITWISE_CASES)
def test_lanes_equal_standalone_gps_bitwise(solver, fused, precond):
    """Every lane of ``fleet_fit`` (mixed sigmas) equals its standalone
    padded fit, and a T = 1 fleet the single GP: caches, mean, variance."""
    X, Y, Xq = _data(T, N, seed=6)
    om = np.full(D, OMEGA)
    cfg = _cfgs(solver, fused, 0, precond)[0]
    if solver == "pcg":
        cfg = dataclasses.replace(cfg, solver_iters=BITWISE_PCG_ITERS)
    f = fl.fleet_fit(cfg, X, Y, om, SIGMAS, CAP, device="cpu")
    f1 = fl.fleet_fit(cfg, X[:1], Y[:1], om, SIGMAS[:1], CAP, device="cpu")
    mu = fl.fleet_posterior_mean(f, Xq, device="cpu")
    var = fl.fleet_posterior_var(f, Xq, device="cpu")
    mu1 = fl.fleet_posterior_mean(f1, Xq[:1], device="cpu")
    bad = []
    for t in range(T):
        g = fit(cfg, X[t], Y[t], om, SIGMAS[t], device="cpu", capacity=CAP)
        pairs = ((f.tenant(t).u_sy, g.u_sy), (f.tenant(t).bY, g.bY),
                 (mu[t], posterior_mean(g, Xq[t], device="cpu")),
                 (var[t], posterior_var(g, Xq[t], device="cpu")))
        if t == 0:
            pairs += ((f1.tenant(0).u_sy, g.u_sy), (mu1[0], pairs[2][1]))
        if not all(torch.equal(a, b) for a, b in pairs):
            bad.append(t)
    assert not bad, bad


def test_padded_restriction_keeps_vcycle_bits():
    """The fleet's hierarchy shares one restriction width K over its lanes.
    A lane whose own map is narrower, padded to the fleet's K, restricts
    and preconditions with its own map's bits; the fleet's V-cycle equals
    each lane's standalone V-cycle."""
    counts = np.array([N, N - 40, N - 90])
    X, Y, _ = _data(T, N, seed=8)
    cfg = GPConfig(q=0, precond="kmg", solver_iters=BITWISE_PCG_ITERS)
    gps = [fit(cfg, X[t, :c], Y[t, :c], np.full(D, OMEGA), SIGMAS[t],
               device="cpu", capacity=CAP) for t, c in enumerate(counts)]
    fleet = fl.stack_gps(gps)
    K = fleet.gp.hier[0].r_idx.shape[-1]
    own = [g.hier[0].r_idx.shape[-1] for g in gps]
    assert min(own) < K == max(own)
    r = mask_rows(torch.as_tensor(np.random.default_rng(9).standard_normal(
        (T, D, CAP, 2))), torch.as_tensor(counts), axis=2)
    z = kmg_preconditioner(fleet.gp.ops, fleet.gp.hier)(r)
    for t, g in enumerate(gps):
        lvl = g.hier[0]
        wide = pad_restriction(lvl, K + 3)
        assert torch.equal(restrict(lvl, g.ops, r[t]),
                           restrict(wide, g.ops, r[t]))
        pre = kmg_preconditioner(g.ops, g.hier)(r[t])
        assert torch.equal(kmg_preconditioner(
            g.ops, (wide,) + g.hier[1:])(r[t]), pre)
        assert torch.equal(z[t], pre)
        assert torch.equal(kmg_preconditioner(
            fleet.tenant(t).ops, fleet.tenant(t).hier)(r[t]), pre)


@pytest.mark.parametrize("precond", ["none", "kmg"])
def test_tol_exit_lanes_keep_their_own_counts(precond):
    """A tol-exit pcg over a fleet ("off" and kmg): the tenants (different
    sigmas) leave the loop at different iterations, and each lane's x,
    residual and count equal its standalone solve's, bit for bit."""
    X, Y, _ = _data(T, N, seed=10)
    v = torch.as_tensor(np.random.default_rng(11).standard_normal(
        (T, D, CAP, 3)))
    sig = np.array([0.05, 0.3, 1.0])
    cfg = GPConfig(q=0, precond=precond, fused="off", solver_iters=60)
    f = fl.fleet_fit(cfg, X, Y, np.full(D, OMEGA), sig, CAP, device="cpu")
    scfg = dataclasses.replace(f.config.solve_cfg(), iters=200, tol=1e-9)
    x, info = solve_mhat(f.gp.ops, v, scfg, hier=f.gp.hier,
                         return_info=True)
    its = [int(i) for i in info.iters]
    assert len(set(its)) >= 2 and max(its) < 200, its
    bad = []
    for t in range(T):
        g = f.tenant(t)
        xt, it = solve_mhat(g.ops, v[t], scfg, hier=g.hier, return_info=True)
        if not (torch.equal(x[t], xt) and int(it.iters) == its[t]
                and torch.equal(info.resid[t], it.resid)):
            bad.append((t, its[t], int(it.iters)))
    assert not bad, bad
