"""The port's kernel-multigrid preconditioner against the JAX package, on
the CPU.

One seeded jittered-grid problem (n = 256, D = 3, q = 0: one coarse level at
stride 8, nc = 32) fitted by the JAX package with ``precond="kmg"`` on its
"jax" backend; the port rebuilds the GP from those arrays
(``gp_from_arrays``), which rebuilds the hierarchy from the same fine
factors. Then:

* the hierarchy: ``j0`` equal and ``W`` within 1e-12 of the reference's
  ``_interp_maps`` on the same coordinates; coarse A, Phi and SAPhi within
  1e-10 (direct band assembly); ``EG`` within 1e-8 (an eigen-decomposition
  of a Gram assembled through two coarse operators);
* the V-cycle: prolong and restrict adjoint to 1e-13, ``pre`` symmetric to
  1e-12, the same bits on a second run, and within 1e-10 of the
  reference's ``kmg_preconditioner``;
* ``solve_mhat(precond="kmg", tol=1e-8)``: the reference's iteration count
  within 1, the solution within 1e-8;
* ``fit`` -> ``posterior_mean`` -> ``posterior_var`` with kmg against the
  JAX kmg fit, at the bars of ``torch_port_jax_ref``, also from the JAX
  fit's own factors (``gp_from_arrays`` rebuilds the hierarchy);
* the precond rules and the reference's error cases.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backfitting import SolveConfig as JaxSolveConfig
from repro.core.backfitting import solve_mhat as jax_solve_mhat
from repro.precond.coarse import _interp_maps as jax_interp_maps
from repro.precond.vcycle import kmg_preconditioner as jax_kmg
from repro_torch.core import GPConfig, gp_from_arrays
from repro_torch.core.additive_gp import resolve_config
from repro_torch.core.backfitting import SolveConfig, solve_mhat
from repro_torch.kernels import ops as kops
from repro_torch.precond import (build_hierarchy, kmg_preconditioner, prolong,
                                 restrict)
from repro_torch.precond.coarse import _interp_maps
from torch_port_jax_ref import (check_fit, check_queries,  # noqa: F401
                                check_queries_on_jax_factors, fit_cache,
                                fresh_jax_caches)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

CASE = (256, 0, False, "pcg", "jax", "kmg")  # n, q, ties, solver, backend


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def fitted():
    return fit_cache()


@pytest.fixture(scope="module")
def pair(fitted):
    """(JAX GP, the port's GP on the JAX GP's arrays)."""
    cfg, _, _, ref = fitted(*CASE)
    return ref["gp"], gp_from_arrays(ref["arrays"], cfg, "cpu")


def _rhs(gp, B=2, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((gp.D, gp.n, B))


def test_hierarchy_shape(pair):
    jgp, gp = pair
    assert gp.config.precond == "kmg" and gp.config.fused == "off"
    assert [lv.stride for lv in gp.hier] == [lv.stride for lv in jgp.hier]
    assert [lv.nc for lv in gp.hier] == [32]


def test_interp_maps_match(pair):
    _, gp = pair
    lv = gp.hier[0]
    xs_c = torch.gather(gp.X[torch.arange(lv.nc) * lv.stride].T, 1,
                        lv.ops.sort_idx)
    j0, W = _interp_maps(gp.xs, xs_c, lv.npts)
    j0j, Wj = jax_interp_maps(jnp.asarray(gp.xs.numpy()),
                              jnp.asarray(xs_c.numpy()), None, lv.npts)
    assert np.array_equal(j0.numpy(), np.asarray(j0j))
    assert _rel(W.numpy(), Wj) < 1e-12
    assert np.array_equal(lv.j0.numpy(), np.asarray(j0j))


def test_coarse_factors_match(pair):
    jgp, gp = pair
    lv, lj = gp.hier[0], jgp.hier[0]
    for name in ("A", "Phi", "SAPhi"):
        ours, ref = getattr(lv.ops, name), getattr(lj.ops, name)
        assert (ours.lo, ours.hi) == (ref.lo, ref.hi)
        assert _rel(ours.data.numpy(), ref.data) < 1e-10, name
    assert np.array_equal(lv.ops.sort_idx.numpy(), np.asarray(lj.ops.sort_idx))
    assert _rel(lv.W.numpy(), lj.W) < 1e-12
    assert _rel(lv.EG.numpy(), lj.EG) < 1e-8


def test_transfers_are_adjoint(pair):
    _, gp = pair
    lv = gp.hier[0]
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal((gp.D, lv.nc, 2)))
    r = torch.as_tensor(rng.standard_normal((gp.D, gp.n, 2)))
    lhs = (prolong(lv, gp.ops, u) * r).sum()
    rhs = (u * restrict(lv, gp.ops, r)).sum()
    assert abs(float(lhs - rhs)) <= 1e-13 * float(lhs.abs())


def test_vcycle_symmetric_deterministic_and_matches_jax(pair):
    jgp, gp = pair
    pre = kmg_preconditioner(gp.ops, gp.hier)
    rng = np.random.default_rng(4)
    a, b = (torch.as_tensor(rng.standard_normal((gp.D, gp.n, 2)))
            for _ in range(2))
    pa, pb = pre(a), pre(b)
    lhs, rhs = (pa * b).sum(), (a * pb).sum()
    assert abs(float(lhs - rhs)) <= 1e-12 * float(lhs.abs())
    assert torch.equal(pre(a), pa)
    pj = jax_kmg(jgp.ops, jgp.hier, backend="jax")(jnp.asarray(a.numpy()))
    assert _rel(pa.numpy(), pj) < 1e-10


@pytest.mark.parametrize("warm", [False, True])
def test_kmg_solve_matches_jax(pair, warm):
    jgp, gp = pair
    v = _rhs(gp)
    x0 = 0.3 * v if warm else None
    cfg = dict(method="pcg", iters=200, tol=1e-8, precond="kmg")
    xj, ij = jax_solve_mhat(jgp.ops, jnp.asarray(v),
                            JaxSolveConfig(backend="jax", **cfg),
                            x0=None if x0 is None else jnp.asarray(x0),
                            hier=jgp.hier, return_info=True)
    x, info = solve_mhat(gp.ops, torch.as_tensor(v), SolveConfig(**cfg),
                         x0=None if x0 is None else torch.as_tensor(x0),
                         hier=gp.hier, return_info=True)
    assert abs(int(info.iters) - int(ij.iters)) <= 1
    assert int(info.iters) < 200
    assert _rel(x.numpy(), xj) < 1e-8


def test_kmg_fit_matches_jax(fitted):
    check_fit(fitted, CASE)


def test_kmg_queries_match_jax(fitted):
    check_queries(fitted, CASE, 40)
    check_queries_on_jax_factors(fitted, CASE)


def test_resolve_precond_rules():
    big = kops.KMG_AUTO_MIN_N
    assert kops.resolve_precond("none", q=0, n=big) == "none"
    assert kops.resolve_precond("kmg", q=2, n=8) == "kmg"  # explicit wins
    assert kops.resolve_precond("auto", q=0, n=big) == "kmg"
    assert kops.resolve_precond("auto", q=0, n=big - 1) == "none"
    assert kops.resolve_precond("auto", q=1, n=4 * big) == "none"
    assert kops.resolve_precond(None, q=0, n=big) == "kmg"
    with pytest.raises(ValueError):
        kops.resolve_precond("vcycle", q=0, n=big)
    # the default config at the paper's sizes: kmg, unfused
    cfg = resolve_config(GPConfig(), big, "cpu")
    assert (cfg.precond, cfg.fused) == ("kmg", "off")
    assert resolve_config(GPConfig(), big - 1, "cpu").precond == "none"


def test_kmg_error_cases(pair):
    _, gp = pair
    v = torch.as_tensor(_rhs(gp))
    kmg = SolveConfig(method="pcg", iters=10, precond="kmg")
    with pytest.raises(ValueError, match="hierarchy"):
        solve_mhat(gp.ops, v, kmg)  # hier not threaded
    for fused in ("on", "whole"):
        with pytest.raises(ValueError, match="fused"):
            solve_mhat(gp.ops, v, dataclasses.replace(kmg, fused=fused),
                       hier=gp.hier)
    with pytest.raises(ValueError, match="pcg"):
        solve_mhat(gp.ops, v, dataclasses.replace(kmg, method="jacobi"),
                   hier=gp.hier)
    with pytest.raises(ValueError, match="fused"):
        resolve_config(GPConfig(precond="kmg", fused="on"), 64, "cpu")


def test_auto_with_hierarchy_degrades_without_one(pair):
    """precond="auto" at a raw solve: block preconditioner without a
    hierarchy; with one, the fit's rule (here n < 4096: none as well)."""
    _, gp = pair
    v = torch.as_tensor(_rhs(gp))
    cfg = SolveConfig(method="pcg", iters=80, tol=1e-9, precond="auto")
    want = solve_mhat(gp.ops, v, dataclasses.replace(cfg, precond="none"))
    assert torch.equal(solve_mhat(gp.ops, v, cfg), want)
    assert torch.equal(solve_mhat(gp.ops, v, cfg, hier=gp.hier), want)


def test_hierarchy_depth_and_strides(pair):
    _, gp = pair
    hier = build_hierarchy(0, gp.omega, gp.sigma ** 2, gp.X, gp.xs, gp.ops,
                           levels=3, coarsen=4)
    assert [lv.stride for lv in hier] == [4, 16]
    assert [lv.nc for lv in hier] == [64, 16]
