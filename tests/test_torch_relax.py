"""The port's relaxation backfitting solvers against the JAX package, on the
CPU.

* The plain versions of the one-sweep kernels (Jacobi, Gauss-Seidel) and
  of the whole-solve kernels, with and without the carried
  k stack and warm starts, against the Pallas kernels in interpret mode on
  the same padded operands: 1e-12 relative (the same arithmetic; the JAX
  kernels sum the dimensions in XLA's order).
* ``solve_mhat`` for jacobi and gauss_seidel in every fused mode, and pcg
  with ``fused="off"``, against the JAX ``solve_mhat`` in the same mode
  (Pallas for "whole"/"on", the "jax" backend for "off"): 1e-10 relative
  for the relaxation solves, 1e-9 for pcg (the reference's own bar between
  its pcg paths), equal iteration counts and verdicts.
* Inside the port: the whole solve equals the host loop of sweeps bit for
  bit, the exit residual included; the iters == 0 fallback; damping; the
  sweeps' backward error.
* ``fit`` -> ``posterior_mean`` -> ``posterior_var`` with both relaxation
  solvers, and a q = 2 serving case, against the JAX package at the
  tolerances of ``torch_port_jax_ref.py``.

Inputs are seeded numpy draws on jittered grids (``torch_port_inputs``),
n <= 64, D = 3, B = 2.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backfitting import DimOps as JaxDimOps
from repro.core.backfitting import SolveConfig as JaxSolveConfig
from repro.core.backfitting import solve_mhat as jax_solve_mhat
from repro.core.banded import Banded as JaxBanded
from repro.kernels.fused_sweep import (fused_gauss_seidel_iter_pallas,
                                       fused_jacobi_iter_pallas)
from repro.kernels.mega_solve import (mega_gauss_seidel_solve_pallas,
                                      mega_jacobi_solve_pallas)
from repro_torch.core import GPConfig
from repro_torch.core.additive_gp import resolve_config
from repro_torch.core.backfitting import SolveConfig, solve_mhat
from repro_torch.kernels import _build
from repro_torch.kernels.fused_sweep import (fused_gauss_seidel_iter_plain,
                                             fused_jacobi_iter_plain,
                                             sweep_backward_error)
from repro_torch.kernels.mega_solve import (mega_gauss_seidel_plain,
                                            mega_jacobi_plain)
from torch_port_inputs import dim_ops, padded_operands, solve_operands
from torch_port_jax_ref import (check_fit, check_queries,  # noqa: F401
                                check_queries_on_jax_factors, fit_cache,
                                fresh_jax_caches, shared_ref)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

N, DIMS, B, ITERS, ALPHA = 48, 3, 2, 6, 0.4


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _operands(q):
    """Padded operands of one seeded system: the port's tensors and the
    numpy arrays handed to the JAX kernels (sigma2 as the kernels' (1, 1))."""
    rng = np.random.default_rng(200 + q)
    fs, v, x0 = padded_operands(solve_operands(rng, N, DIMS, q), "cpu", B,
                                rng)
    t = dict(ops=(fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2),
             v=fs.pad_state(torch.as_tensor(v)),
             x0=fs.pad_state(torch.as_tensor(x0)),
             k=fs.pad_state(torch.as_tensor(
                 0.1 * rng.standard_normal(v.shape))),
             kw=dict(w_p=fs.w_p, w_s=fs.w_s))
    j = {k: jnp.asarray(t[k].numpy()) for k in ("v", "x0", "k")}
    j["ops"] = tuple(jnp.asarray(a.numpy()) for a in t["ops"][:4]) + (
        jnp.asarray(t["ops"][4].numpy().reshape(1, 1)),)
    return t, j


def _kernel_ref(q, part):
    """The Pallas kernel results one kernel test compares with, as numpy:
    ``part`` "sweep" (the one-sweep kernels) or "whole" (the whole-solve
    kernels) at q. The JAX sweeps' x output does not depend on whether k is
    carried, so the k-carrying calls also serve the port's sweeps without
    k."""
    t, j = _operands(q)
    kw = dict(t["kw"], interpret=True)
    ops, v, x0, k = j["ops"], j["v"], j["x0"], j["k"]
    if part == "sweep":
        out = dict(
            jac_k=fused_jacobi_iter_pallas(*ops, v, x0, k, alpha=ALPHA,
                                           want_resid=True, **kw),
            # one warm sweep: k0 = Khat^{-1} x0, then the sweep
            jac_warm=mega_jacobi_solve_pallas(*ops, v, x0, alpha=ALPHA,
                                              iters=1, warm=True, **kw),
            gs_k=fused_gauss_seidel_iter_pallas(*ops, v, x0, want_resid=True,
                                                **kw))
    else:
        out = dict(
            mjac=mega_jacobi_solve_pallas(*ops, v, jnp.zeros_like(v),
                                          alpha=ALPHA, iters=ITERS, **kw),
            mjac_warm=mega_jacobi_solve_pallas(*ops, v, x0, alpha=ALPHA,
                                               iters=ITERS, warm=True, **kw),
            mgs=mega_gauss_seidel_solve_pallas(*ops, v, x0, iters=ITERS,
                                               **kw))
    return jax.tree_util.tree_map(np.asarray, out)


def _check(got, want, tol=1e-12):
    got = got if isinstance(got, tuple) else (got,)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), np.asarray(b)) < tol


@pytest.mark.parametrize("q", [0, 1])
def test_sweep_plain_matches_pallas(jax_ref, q):
    t, _ = _operands(q)
    ops, v, x0, k, kw = t["ops"], t["v"], t["x0"], t["k"], t["kw"]
    ref = jax_ref("kernels", q, "sweep")
    _check(fused_jacobi_iter_plain(*ops, v, x0, alpha=ALPHA, **kw),
           ref["jac_k"][0])
    _check(fused_jacobi_iter_plain(*ops, v, x0, k, alpha=ALPHA, **kw),
           ref["jac_k"])
    _check(fused_jacobi_iter_plain(*ops, v, x0, alpha=ALPHA, warm=True,
                                   **kw), ref["jac_warm"])
    _check(fused_gauss_seidel_iter_plain(*ops, v, x0, **kw), ref["gs_k"][0])
    _check(fused_gauss_seidel_iter_plain(*ops, v, x0, want_resid=True, **kw),
           ref["gs_k"])


@pytest.mark.parametrize("q", [0, 1])
def test_whole_plain_matches_pallas(jax_ref, q):
    t, _ = _operands(q)
    ops, v, x0, kw = t["ops"], t["v"], t["x0"], t["kw"]
    ref = jax_ref("kernels", q, "whole")
    _check(mega_jacobi_plain(*ops, v, torch.zeros_like(v), alpha=ALPHA,
                             iters=ITERS, **kw), ref["mjac"])
    _check(mega_jacobi_plain(*ops, v, x0, alpha=ALPHA, iters=ITERS,
                             warm=True, **kw), ref["mjac_warm"])
    _check(mega_gauss_seidel_plain(*ops, v, x0, iters=ITERS, **kw),
           ref["mgs"])


# ---------------------------------------------------------------------------
# solve_mhat in every mode against the JAX package's
# ---------------------------------------------------------------------------

MODES = [("jacobi", "whole"), ("jacobi", "on"), ("jacobi", "off"),
         ("gauss_seidel", "whole"), ("gauss_seidel", "on"),
         ("gauss_seidel", "off"), ("pcg", "off")]


def _system(q=1):
    rng = np.random.default_rng(300 + q)
    ops = solve_operands(rng, N, DIMS, q)
    v = rng.standard_normal((DIMS, N, B))
    return ops, v, 0.5 * v


def _jax_ops(ops):
    bd = lambda k, w: JaxBanded(jnp.asarray(ops[k]), w, w)
    return JaxDimOps(A=bd("A", ops["w_a"]), Phi=bd("Phi", ops["w_p"]),
                     SAPhi=bd("SAPhi", ops["w_s"]),
                     sort_idx=jnp.asarray(ops["sort_idx"]),
                     rank_idx=jnp.asarray(ops["rank_idx"]),
                     sigma2=jnp.asarray(ops["sigma2"]))


def _cfg_kw(method, fused, warm):
    # pcg runs to convergence; at an unconverged count its rounding grows
    iters = 40 if method == "pcg" else ITERS
    return dict(method=method, iters=iters, fused=fused,
                tol=1e-9 if method == "pcg" and warm else 0.0)


def _solve_ref(method, fused, warm):
    """The JAX ``solve_mhat`` of one mode, cold or warm, with its info."""
    ops, v, x0 = _system()
    cfg = JaxSolveConfig(backend="jax" if fused == "off" else "pallas",
                         **_cfg_kw(method, fused, warm))
    x, info = jax_solve_mhat(_jax_ops(ops), jnp.asarray(v), cfg,
                             x0=jnp.asarray(x0) if warm else None,
                             return_info=True)
    return (np.asarray(x), int(info.iters), float(info.resid),
            int(info.verdict))


@pytest.fixture(scope="module")
def jax_ref(shared_ref):
    """``get("kernels", q, part)`` or ``get("solves", method, fused,
    warm)``: the JAX side of one kernel or solve test, computed once per
    run and only where a test asks for it (interpret-mode compiles
    dominate this file's time)."""
    fns = {"kernels": _kernel_ref, "solves": _solve_ref}

    def get(kind, *key):
        return shared_ref(("test_torch_relax", kind) + key,
                          lambda: fns[kind](*key))

    return get


@pytest.mark.parametrize("method,fused", MODES)
@pytest.mark.parametrize("warm", [False, True])
def test_solve_mhat_matches_jax(jax_ref, method, fused, warm):
    """A warm "on" solve is held against the JAX "whole" one: the port's
    "on" equals its "whole" bit for bit (tested below)."""
    ops, v, x0 = _system()
    x, info = solve_mhat(dim_ops(ops, "cpu"), torch.as_tensor(v),
                         SolveConfig(**_cfg_kw(method, fused, warm)),
                         x0=torch.as_tensor(x0) if warm else None,
                         return_info=True)
    key = (method, "whole" if fused == "on" and warm else fused, warm)
    xj, iters, resid, verdict = jax_ref("solves", *key)
    tol = 1e-9 if method == "pcg" else 1e-10
    assert _rel(x.numpy(), xj) < tol
    assert abs(float(info.resid) - resid) <= tol * float(info.rhs)
    assert int(info.iters) == iters and int(info.verdict) == verdict


@pytest.mark.parametrize("method", ["jacobi", "gauss_seidel"])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("B_", [2, 5])
def test_whole_equals_host_loop_bitwise(monkeypatch, method, warm, B_):
    """fused="whole" and fused="on" give the same bits, SolveInfo.resid
    included; B_ = 5 with the kernels' column limit set to 2 also runs both
    as column chunks."""
    from repro_torch.kernels import fused_sweep, mega_solve

    if B_ == 5:
        monkeypatch.setattr(mega_solve, "MAX_B", 2)
        monkeypatch.setattr(fused_sweep, "MAX_B", 2)
    ops, _, _ = _system()
    rng = np.random.default_rng(301)
    v = torch.as_tensor(rng.standard_normal((DIMS, N, B_)))
    x0 = 0.5 * v if warm else None
    res = [solve_mhat(dim_ops(ops, "cpu"), v,
                      SolveConfig(method=method, iters=ITERS, fused=f),
                      x0=x0, return_info=True) for f in ("whole", "on")]
    (xw, iw), (xh, ih) = res
    assert torch.equal(xw, xh) and torch.equal(iw.resid, ih.resid)
    assert torch.equal(iw.verdict, ih.verdict)


@pytest.mark.parametrize("method", ["jacobi", "gauss_seidel"])
def test_zero_iterations_fall_back_to_a_matvec(method):
    """iters == 0: x = x0, and the residual is one explicit Mhat matvec, in
    every mode (held against the JAX package's unfused solve)."""
    ops, v, x0 = _system()
    vt, x0t = torch.as_tensor(v), torch.as_tensor(x0)
    _, ij = jax_solve_mhat(_jax_ops(ops), jnp.asarray(v),
                           JaxSolveConfig(method=method, iters=0, fused="off",
                                          backend="jax"),
                           x0=jnp.asarray(x0), return_info=True)
    for fused in ("whole", "on", "off"):
        x, info = solve_mhat(dim_ops(ops, "cpu"), vt,
                             SolveConfig(method=method, iters=0,
                                         fused=fused),
                             x0=x0t, return_info=True)
        assert torch.equal(x, x0t)
        assert _rel(float(info.resid), float(ij.resid)) < 1e-12
        assert int(info.verdict) == int(ij.verdict)


def test_jacobi_damping():
    """An explicit damping replaces 1/D, in every mode, as in the reference."""
    ops, v, _ = _system()
    cfg = dict(method="jacobi", iters=ITERS, damping=0.25)
    xj, ij = jax_solve_mhat(_jax_ops(ops), jnp.asarray(v),
                            JaxSolveConfig(backend="jax", fused="off", **cfg),
                            return_info=True)
    for fused in ("whole", "on", "off"):
        x, info = solve_mhat(dim_ops(ops, "cpu"), torch.as_tensor(v),
                             SolveConfig(fused=fused, **cfg),
                             return_info=True)
        assert _rel(x.numpy(), np.asarray(xj)) < 1e-10
        assert _rel(float(info.resid), float(ij.resid)) < 1e-9
    default = solve_mhat(dim_ops(ops, "cpu"), torch.as_tensor(v),
                         SolveConfig(method="jacobi", iters=ITERS))
    assert _rel(default.numpy(), np.asarray(xj)) > 1e-3


@pytest.mark.parametrize("method", ["jacobi", "gauss_seidel"])
def test_pivot_runs_on_every_fused_path(method):
    """pivot=True runs on the CR and w = 0 solves of every mode and matches
    the JAX package's pivoted whole solve."""
    ops, v, x0 = _system()
    xj = jax_solve_mhat(_jax_ops(ops), jnp.asarray(v),
                        JaxSolveConfig(method=method, iters=ITERS,
                                       pivot=True, backend="pallas",
                                       fused="whole"))
    for fused in ("whole", "on", "off"):
        x = solve_mhat(dim_ops(ops, "cpu"), torch.as_tensor(v),
                       SolveConfig(method=method, iters=ITERS, pivot=True,
                                   fused=fused))
        assert _rel(x.numpy(), np.asarray(xj)) < 1e-10


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("method", ["jacobi", "gauss_seidel"])
def test_sweep_backward_error(q, method):
    """The backward error of one undamped plain sweep's SAPhi solves is a
    few eps; a result off by 1e-8 in one entry reads far above that."""
    t, _ = _operands(q)
    ops, v, x0, kw = t["ops"], t["v"], t["x0"], t["kw"]
    if method == "jacobi":
        new = fused_jacobi_iter_plain(*ops, v, x0, alpha=1.0, **kw)
    else:
        new = fused_gauss_seidel_iter_plain(*ops, v, x0, **kw)
    seq = method == "gauss_seidel"
    assert sweep_backward_error(*ops, v, x0, new, sequential=seq, **kw) < 1e-14
    bad = new.clone()
    bad[1, 5, 0] += 1e-8 * float(new.abs().max())
    assert sweep_backward_error(*ops, v, x0, bad, sequential=seq, **kw) > 1e-10


def test_relaxation_configs_resolve():
    """The relaxation configurations resolve at fit time: fused "auto"
    bakes to "whole", the explicit modes stay; kmg with a relaxation solver
    raises, and pcg with fused="on" resolves to the per-iteration kernel."""
    for solver in ("jacobi", "gauss_seidel"):
        for fused, want in (("auto", "whole"), ("whole", "whole"),
                            ("on", "on"), ("off", "off")):
            cfg = resolve_config(GPConfig(solver=solver, fused=fused,
                                          precond="none"), 20, "cpu")
            assert cfg.fused == want
    assert resolve_config(GPConfig(solve_alg="lu", precond="none"), 20,
                          "cpu").fused == "off"
    assert resolve_config(GPConfig(pivot=True, precond="none"), 20,
                          "cpu").pivot
    with pytest.raises(ValueError, match="solve alg 'lu'"):
        resolve_config(GPConfig(fused="whole", solve_alg="lu",
                                precond="none"), 20, "cpu")
    with pytest.raises(ValueError, match="method='pcg' only"):
        resolve_config(GPConfig(solver="jacobi", precond="kmg"), 20, "cpu")
    assert resolve_config(GPConfig(fused="on", precond="none"), 20,
                          "cpu").fused == "on"


def test_unfused_paths_launch_no_kernel_on_cpu():
    ops, v, _ = _system()
    _build.reset_launch_counts()
    for method in ("jacobi", "gauss_seidel", "pcg"):
        for fused in ("whole", "off") + (("on",) if method != "pcg" else ()):
            solve_mhat(dim_ops(ops, "cpu"), torch.as_tensor(v),
                       SolveConfig(method=method, iters=3, fused=fused))
    assert all(c == 0 for c in _build.launch_counts().values())


# ---------------------------------------------------------------------------
# the slice as a whole: fit -> posterior_mean -> posterior_var
# ---------------------------------------------------------------------------

# the JAX side runs its "jax" backend (its unfused sweeps): a Pallas
# interpret-mode fit costs minutes of compile; the kernels are held
# against Pallas above
GP_CASES = [(37, 0, False, "gauss_seidel", "jax"),
            (37, 0, False, "jacobi", "jax"),
            (37, 1, False, "gauss_seidel", "jax"),
            (37, 2, False, "pcg", "jax")]


@pytest.fixture(scope="module")
def fitted(shared_ref):
    return fit_cache(shared_ref)


@pytest.mark.parametrize("case", GP_CASES)
def test_relaxation_fit_matches_jax(fitted, case):
    check_fit(fitted, case)


@pytest.mark.parametrize("case", GP_CASES)
def test_relaxation_queries_match_jax(fitted, case):
    check_queries(fitted, case, 40)
    check_queries_on_jax_factors(fitted, case)


def test_config_baking_keeps_reference_fields():
    cfg = resolve_config(GPConfig(solver="gauss_seidel", precond="none"), 37,
                         "cpu")
    sc = cfg.solve_cfg()
    assert dataclasses.asdict(sc) == dict(
        method="gauss_seidel", iters=cfg.solver_iters, damping=0.0,
        pivot=False, tol=0.0, backend="auto", alg="auto", fused="whole",
        precond="none", precond_smooth=cfg.precond_smooth)
