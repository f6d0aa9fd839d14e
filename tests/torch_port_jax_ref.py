"""JAX-side reference fits for the torch-port serving-path tests.

One JAX fit (pallas backend, interpret mode) and one 40-query mean/variance
per case, plus the port's own CPU fit of the same seeded data; the checks
the test files share; and :func:`shared_ref`, which computes a JAX-side
result once per test run, however many workers ask for it.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPConfig as JaxGPConfig
from repro.core import fit as jax_fit
from repro.core import posterior_mean as jax_mean
from repro.core import posterior_var as jax_var
from repro_torch.core import (GPConfig, fit, gp_from_arrays, posterior_mean,
                              posterior_var)
from repro_torch.core.convert import BAND_KEYS
from torch_port_inputs import OMEGA, points

jax.config.update("jax_enable_x64", True)

# 80 iterations converge every solve to rounding, so the two frameworks'
# different summation orders cannot grow through unconverged CG steps
D, M, SIGMA, ITERS = 3, 40, 0.5, 80


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """Drop the JAX executables this process holds before a port test module
    compiles its own, and again after it. Every compiled XLA CPU executable
    keeps memory mappings, and the jit caches keep executables alive: a test
    worker that runs the JAX package's Pallas suites and then a port
    module's interpret-mode references passes the kernel's
    vm.max_map_count, and the next compile fails in LLVM's memory manager
    ("releaseMappedMemory failed ... Cannot allocate memory") and crashes
    the worker. Modules that compile JAX import this fixture."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def shared_ref(request, tmp_path_factory):
    """``get(key, compute)``: ``compute()``'s result for ``key`` (a repr-able
    key naming the test module and the result; the result picklable),
    computed once per test run. In one process it is cached in memory;
    under pytest-xdist the first worker that asks computes it under a file
    lock in the run's shared temporary directory (the parent of the
    workers' own, pytest-xdist's documented pattern) and the others read
    its file. The JAX references are deterministic, so which worker
    computes one does not matter, and a run computes each once, not once
    per worker that holds one of its tests."""
    local: dict = {}
    root = None
    if hasattr(request.config, "workerinput"):
        root = tmp_path_factory.getbasetemp().parent / "torch_port_ref"
        root.mkdir(exist_ok=True)

    def get(key, compute):
        if key in local:
            return local[key]
        if root is None:
            local[key] = compute()
            return local[key]
        name = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        path = root / f"{name}.pkl"
        with open(root / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when lock closes
            if path.exists():
                out = pickle.loads(path.read_bytes())
            else:
                out = compute()
                tmp = root / f"{name}.tmp"
                tmp.write_bytes(pickle.dumps(out))
                os.replace(tmp, path)
        local[key] = out
        return out

    return get


def _data(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    X = points(rng, n, D)
    if ties:  # exact ties in two dimensions (separated by TIE_EPS in fit)
        X[5, 0] = X[9, 0] = X[17, 0]
        X[3, 2] = X[4, 2]
    Y = np.sin(2.0 * X).sum(1) + 0.1 * rng.standard_normal(n)
    Xq = rng.uniform(0.0, 4.0, (M, D))
    return X, Y, Xq


def _jax_arrays(gp):
    out = {k: np.asarray(getattr(gp, k)) for k in
           ("X", "Y", "omega", "sigma", "xs", "bY", "u_sy")}
    out["sort_idx"] = np.asarray(gp.ops.sort_idx)
    out["rank_idx"] = np.asarray(gp.ops.rank_idx)
    bands = dict(A=gp.ops.A, Phi=gp.ops.Phi, SAPhi=gp.ops.SAPhi, B=gp.B,
                 Psi=gp.Psi, Gband=gp.Gband, Hband=gp.Hband)
    for k, b in bands.items():
        out[k], out[f"{k}_lo"], out[f"{k}_hi"] = np.asarray(b.data), b.lo, b.hi
    return out


def _jax_case(n, q, ties, solver, jax_backend, precond, pivot=False,
              solve_alg="auto", iters=ITERS, learning=False):
    """The JAX fit of one seeded case, and its arrays, verdict and 40-query
    mean and variance; with ``learning`` also its log-likelihood (key 7)
    and gradients (key 8), with the probes they drew (``probes``: the
    power method's restarts, the log-determinant's probes, the gradients'
    Hutchinson block)."""
    X, Y, Xq = _data(n, 100 + n + q + ties, ties)
    jgp = jax_fit(JaxGPConfig(q=q, solver=solver, solver_iters=iters,
                              precond=precond, backend=jax_backend,
                              pivot=pivot, solve_alg=solve_alg),
                  jnp.asarray(X), jnp.asarray(Y),
                  jnp.asarray(np.full(D, OMEGA)), SIGMA)
    ref = dict(arrays=_jax_arrays(jgp), verdict=int(jgp.health.verdict),
               mean=np.asarray(jax_mean(jgp, jnp.asarray(Xq))),
               var=np.asarray(jax_var(jgp, jnp.asarray(Xq))))
    if learning:
        from repro.core import log_likelihood, mll_gradients
        from repro.core.additive_gp import _probe_block
        from repro.core.stochastic import rademacher_rows

        key = jax.random.PRNGKey(7)
        k1, k2 = jax.random.split(key)
        gkey = jax.random.PRNGKey(8)
        ref["probes"] = (
            np.array(_probe_block(jgp, k1, 4)),
            np.array(_probe_block(jgp, k2, jgp.config.logdet_probes)),
            np.array(rademacher_rows(gkey, n, (jgp.config.trace_probes,),
                                     dtype=jnp.float64)))
        ref["ll"] = float(log_likelihood(jgp, key))
        g_om, g_sg = mll_gradients(jgp, gkey)
        ref["grads"] = np.concatenate([np.asarray(g_om), [float(g_sg)]])
    return jgp, ref


def fit_cache(shared=None):
    """``get(n, q, ties=False, solver="pcg", jax_backend="pallas",
    precond="none", pivot=False, solve_alg="auto", iters=ITERS,
    learning=False)``: the JAX fit (on ``jax_backend``) and the port's CPU
    fit of one seeded case, cached. With ``shared`` (the
    :func:`shared_ref` fixture's getter) the JAX side is computed once per
    run; without it ``ref["gp"]`` is also the JAX GP itself. The seed
    depends on (n, q, ties) only, so the solvers of one case see the same
    data."""
    cache = {}

    def get(n, q, ties=False, solver="pcg", jax_backend="pallas",
            precond="none", pivot=False, solve_alg="auto", iters=ITERS,
            learning=False):
        key = (n, q, ties, solver, jax_backend, precond, pivot, solve_alg,
               iters, learning)
        if key not in cache:
            X, Y, Xq = _data(n, 100 + n + q + ties, ties)
            if shared is None:
                jgp, ref = _jax_case(*key)
                ref["gp"] = jgp
            else:
                ref = shared(("fit_cache",) + key,
                             lambda: _jax_case(*key)[1])
            cfg = GPConfig(q=q, solver=solver, solver_iters=iters,
                           precond=precond, pivot=pivot, solve_alg=solve_alg)
            gp = fit(cfg, X, Y, np.full(D, OMEGA), SIGMA, device="cpu")
            cache[key] = (cfg, gp, Xq, ref)
        return cache[key]

    return get


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _port_arrays(gp):
    bands = dict(A=gp.ops.A, Phi=gp.ops.Phi, SAPhi=gp.ops.SAPhi, B=gp.B,
                 Psi=gp.Psi, Gband=gp.Gband, Hband=gp.Hband)
    return {k: b.data.numpy() for k, b in bands.items()}


# The tied case puts two points TIE_EPS * span apart: the windows over them
# are ill-conditioned by construction, and two LAPACK builds agree there
# only to ~1e-7 on the generalized-KP factors (B, Psi; never read by the
# serving path) and ~1e-9 on the variance band (ROADMAP Queue 3).
ILL_CONDITIONED = {(37, 0, True): {"B": 1e-6, "Psi": 1e-6, "Gband": 1e-8}}


def check_fit(fitted, case):
    _, gp, _, ref = fitted(*case)
    ours = _port_arrays(gp)
    for k in BAND_KEYS:
        tol = ILL_CONDITIONED.get(tuple(case), {}).get(k, 1e-10)
        assert _rel(ours[k], ref["arrays"][k]) < tol, k
    assert _rel(gp.u_sy.numpy(), ref["arrays"]["u_sy"]) < 1e-8
    assert _rel(gp.bY.numpy(), ref["arrays"]["bY"]) < 1e-8
    assert int(gp.health.verdict) == ref["verdict"]


def check_queries(fitted, case, m):
    _, gp, Xq, ref = fitted(*case)
    mu = posterior_mean(gp, Xq[:m], device="cpu").numpy()
    var = posterior_var(gp, Xq[:m], device="cpu").numpy()
    assert _rel(mu, ref["mean"][:m]) < 1e-7
    assert _rel(var, ref["var"][:m]) < 1e-7


def check_queries_on_jax_factors(fitted, case):
    cfg, _, Xq, ref = fitted(*case)
    gp = gp_from_arrays(ref["arrays"], cfg, "cpu")
    assert _rel(posterior_mean(gp, Xq, device="cpu").numpy(), ref["mean"]) < 1e-8
    assert _rel(posterior_var(gp, Xq, device="cpu").numpy(), ref["var"]) < 1e-8
