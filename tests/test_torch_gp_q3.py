"""The port's serving path against the JAX package at q = 3 (Matérn-7/2),
on the CPU; see ``test_torch_gp.py`` for what is checked and the bars.

At q = 3 the KP windows span 2q + 3 = 9 points, and the null vectors that
``kernel_packets`` takes from them agree between jaxlib's and torch's
LAPACK only where omega times the window's width is not small (ROADMAP
Queue 3): on the n = 37 jittered grid with omega = 4 every band agrees to
<= 1e-10, at n = 64 the generalized-KP B only to ~2e-9. The JAX side runs
its plain reference backend ("jax"): the Pallas kernels at these widths
are held by ``test_torch_cr_factor.py`` (block CR at w = 4, 5). The port's
fit resolves ``fused="auto"`` as at q <= 2 (the fused kernels take
half-width 4).

The fused solves at q = 3 (``fused="whole"`` and ``"on"``, every solver)
are held against the JAX package's whole-solve kernels (Pallas, interpret
mode) from the same KP factors (``gp_from_arrays``): the fit's mean caches
and the variance at the bars of ``check_queries_on_jax_factors`` (1e-8),
and "on" equals "whole" bit for bit.
"""
from __future__ import annotations

import pytest
import torch

import jax.numpy as jnp
import numpy as np

from repro.core import GPConfig as JaxGPConfig
from repro.core import fit as jax_fit
from repro.core import posterior_var as jax_var
from repro_torch.core import GPConfig, gp_from_arrays, posterior_var
from repro_torch.core.additive_gp import mean_caches
from torch_port_jax_ref import (ITERS, SIGMA, _data, _jax_arrays,  # noqa: F401
                                _rel, check_fit, check_queries,
                                check_queries_on_jax_factors, fit_cache,
                                fresh_jax_caches, shared_ref)

torch.set_num_threads(2)

CASES = [(37, 3, False, "pcg", "jax")]


@pytest.fixture(scope="module")
def fitted(shared_ref):
    return fit_cache(shared_ref)


@pytest.mark.parametrize("case", CASES)
def test_fit_matches_jax(fitted, case):
    check_fit(fitted, case)
    assert fitted(*case)[1].config.fused == "whole"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", [8, 40])
def test_queries_match_jax(fitted, case, m):
    check_queries(fitted, case, m)


@pytest.mark.parametrize("case", CASES)
def test_queries_on_jax_factors(fitted, case):
    check_queries_on_jax_factors(fitted, case)


@pytest.mark.parametrize("solver", ["pcg", "gauss_seidel", "jacobi"])
def test_fused_solves_match_jax_whole(solver):
    """fused="whole" and "on" at q = 3 (A and SAPhi of half-width 4)
    through the plain versions, from the JAX whole-solve fit's factors."""
    n, q = CASES[0][:2]
    X, Y, Xq = _data(n, 100 + n + q)
    kw = dict(q=q, solver=solver, solver_iters=ITERS, precond="none")
    jgp = jax_fit(JaxGPConfig(backend="pallas", fused="whole", **kw),
                  jnp.asarray(X), jnp.asarray(Y),
                  jnp.asarray(np.full(X.shape[1], 4.0)), SIGMA)
    arrays = _jax_arrays(jgp)
    jvar = np.asarray(jax_var(jgp, jnp.asarray(Xq)))
    out = {}
    for fused in ("whole", "on"):
        gp = gp_from_arrays(arrays, GPConfig(fused=fused, **kw), "cpu")
        assert gp.config.fused == fused and gp.ops.SAPhi.lo == 4
        u_sy, bY = mean_caches(gp.config, gp.ops, gp.Y)
        var = posterior_var(gp, Xq, device="cpu")
        assert _rel(u_sy.numpy(), arrays["u_sy"]) < 1e-8
        assert _rel(bY.numpy(), arrays["bY"]) < 1e-8
        assert _rel(var.numpy(), jvar) < 1e-8
        out[fused] = (u_sy, bY, var)
    assert all(torch.equal(a, b) for a, b in zip(out["whole"], out["on"]))
