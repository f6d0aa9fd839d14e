"""The port's per-iteration PCG path (``fused="on"``) against the JAX
package, on the CPU.

* ``fused_pcg_iter_plain`` against ``fused_pcg_iter_pallas`` in interpret
  mode on the same padded operands, q = 0, 1, 2: 1e-12 relative (the same
  arithmetic; the JAX kernel sums in XLA's order), the updated residual
  relative to the residual it updates.
* ``solve_mhat(method="pcg", fused="on")``, cold and warm with tol, against
  the JAX package's "on" solve: 1e-9 relative (the reference's bar between
  its pcg paths; its "on" seeds through the unfused block solve) and equal
  iteration counts and verdicts.
* Inside the port: "on" equals "whole" bit for bit (x, the exit residual,
  the iteration count), cold, warm and with tol, also as column chunks.

Inputs are seeded numpy draws on jittered grids (``torch_port_inputs``),
n = 48, D = 3, B = 2.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backfitting import DimOps as JaxDimOps
from repro.core.backfitting import SolveConfig as JaxSolveConfig
from repro.core.backfitting import solve_mhat as jax_solve_mhat
from repro.core.banded import Banded as JaxBanded
from repro.kernels.fused_sweep import fused_pcg_iter_pallas
from repro_torch.core.backfitting import SolveConfig, solve_mhat
from repro_torch.kernels import _build
from repro_torch.kernels.fused_sweep import (_dot, fused_pcg_iter_plain,
                                             pcg_seed_plain)
from torch_port_inputs import dim_ops, padded_operands, solve_operands
from torch_port_jax_ref import (fresh_jax_caches,  # noqa: F401 (autouse)
                                shared_ref)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

N, DIMS, B = 48, 3, 2


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("q", [0, 1, 2])
def test_pcg_iter_plain_matches_pallas(q):
    rng = np.random.default_rng(400 + q)
    fs, v, x0 = padded_operands(solve_operands(rng, N, DIMS, q), "cpu", B,
                                rng)
    ops = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s)
    # a warm seed makes a state with every term nonzero; one iteration on
    # it moves all four outputs
    state = pcg_seed_plain(*ops, fs.pad_state(torch.as_tensor(v)),
                           fs.pad_state(torch.as_tensor(x0)), warm=True,
                           **kw)
    ours = fused_pcg_iter_plain(*ops, *state, **kw)
    jops = tuple(jnp.asarray(t.numpy()) for t in ops[:5]) + (
        jnp.asarray(fs.sigma2.numpy().reshape(1, 1)),)
    ref = fused_pcg_iter_pallas(*jops, *(jnp.asarray(t.numpy())
                                         for t in state), interpret=True,
                                **kw)
    # r = r - alpha A p cancels: |alpha A p| is far above the new |r|, so
    # r is judged at the scale of the residual it updates (ROADMAP Queue 3,
    # the recursive PCG residual); x, p and rz at their own scales
    scales = [None, float(state[1].abs().max()), None, None]
    for a, b, sc in zip(ours, ref, scales):
        err = _rel(a.numpy(), b) if sc is None else float(
            np.max(np.abs(a.numpy() - np.asarray(b)))) / sc
        assert err < 1e-12
    assert _rel(state[3].numpy(), _dot(state[1], state[2])[None].numpy()) \
        == 0.0


def _system(q=1):
    rng = np.random.default_rng(500 + q)
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


CASES = [(False, 0.0), (False, 1e-9), (True, 1e-9)]  # (warm, tol)


def _jax_on(warm, tol):
    """The JAX package's fused="on" pcg solve of one case, with info."""
    ops, v, x0 = _system()
    cfg = JaxSolveConfig(method="pcg", iters=40, tol=tol, fused="on",
                         backend="pallas")
    x, info = jax_solve_mhat(_jax_ops(ops), jnp.asarray(v), cfg,
                             x0=jnp.asarray(x0) if warm else None,
                             return_info=True)
    return (np.asarray(x), int(info.iters), float(info.resid),
            int(info.verdict))


@pytest.fixture(scope="module")
def jax_on(shared_ref):
    """``get(warm, tol)``: :func:`_jax_on`, computed once per run and only
    for the case a test asks for."""
    return lambda warm, tol: shared_ref(("test_torch_pcg_iter", warm, tol),
                                        lambda: _jax_on(warm, tol))


@pytest.mark.parametrize("warm,tol", CASES)
def test_on_solve_matches_jax(jax_on, warm, tol):
    ops, v, x0 = _system()
    x, info = solve_mhat(dim_ops(ops, "cpu"), torch.as_tensor(v),
                         SolveConfig(method="pcg", iters=40, tol=tol,
                                     fused="on"),
                         x0=torch.as_tensor(x0) if warm else None,
                         return_info=True)
    xj, iters, resid, verdict = jax_on(warm, tol)
    assert _rel(x.numpy(), xj) < 1e-9
    assert abs(float(info.resid) - resid) <= 1e-9 * float(info.rhs)
    assert int(info.iters) == iters and int(info.verdict) == verdict
    assert tol == 0 or iters < 40


@pytest.mark.parametrize("warm,tol", CASES)
@pytest.mark.parametrize("B_", [2, 5])
def test_on_equals_whole_bitwise(monkeypatch, warm, tol, B_):
    """fused="on" and fused="whole" give the same bits; B_ = 5 with the
    kernels' column limit set to 2 runs both as column chunks (with
    tol > 0, in lockstep under one exit)."""
    from repro_torch.kernels import fused_sweep, mega_solve

    if B_ == 5:
        monkeypatch.setattr(mega_solve, "MAX_B", 2)
        monkeypatch.setattr(fused_sweep, "MAX_B", 2)
    ops, _, _ = _system()
    rng = np.random.default_rng(501)
    v = torch.as_tensor(rng.standard_normal((DIMS, N, B_)))
    x0 = 0.5 * v if warm else None
    res = [solve_mhat(dim_ops(ops, "cpu"), v,
                      SolveConfig(method="pcg", iters=40, tol=tol, fused=f),
                      x0=x0, return_info=True) for f in ("whole", "on")]
    (xw, iw), (xh, ih) = res
    assert torch.equal(xw, xh) and torch.equal(iw.resid, ih.resid)
    assert torch.equal(iw.iters, ih.iters)
    assert tol == 0 or int(iw.iters) < 40


def test_on_launches_no_kernel_on_cpu():
    ops, v, _ = _system()
    _build.reset_launch_counts()
    solve_mhat(dim_ops(ops, "cpu"), torch.as_tensor(v),
               SolveConfig(method="pcg", iters=3, fused="on"))
    assert all(c == 0 for c in _build.launch_counts().values())
