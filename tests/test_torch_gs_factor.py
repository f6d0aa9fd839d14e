"""The Gauss-Seidel wrappers' held SAPhi factor and column chunks, on the CPU.

On the card the Gauss-Seidel kernel solves each dimension from SAPhi's
block-CR factor (``factors=``, made once per ``FusedSweep``) in items of
``cols`` columns. On CPU tensors the wrappers run the plain versions, which
solve from the band: both arguments must leave their results unchanged, bit
for bit, and the plain backend must hold no factor. A factor carries its
pivot mode, and every sweep-kernel wrapper rejects one of the other mode
on either device. The chunk rule (``csrc/sweep.cuh`` auto_cols) is held
through the kernels' own queries on the card (``tests/test_torch_cuda.py``).

Inputs are seeded numpy draws on jittered grids (``torch_port_inputs``),
n = 61, D = 3, B = 5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.backfitting import SolveConfig, solve_mhat
from repro_torch.kernels import _build
from repro_torch.kernels.block_cr import block_cr_factor, cr_factor_size
from repro_torch.kernels.fused_sweep import (fused_gauss_seidel_iter,
                                             fused_gauss_seidel_iter_plain,
                                             fused_jacobi_iter,
                                             fused_pcg_iter, pcg_factors,
                                             pcg_seed, sweep_factor)
from repro_torch.kernels.mega_solve import (MegaSolve,
                                            mega_gauss_seidel_plain,
                                            mega_gauss_seidel_solve,
                                            mega_jacobi_solve,
                                            mega_pcg_solve)
from torch_port_inputs import dim_ops, padded_operands, solve_operands

torch.set_num_threads(2)

N, DIMS, B = 61, 3, 5


def _case(q):
    rng = np.random.default_rng(70 + q)
    fs, v, x0 = padded_operands(solve_operands(rng, N, DIMS, q), "cpu", B,
                                rng)
    ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    return (fs, ops, fs.pad_state(torch.as_tensor(v)),
            fs.pad_state(torch.as_tensor(x0)), v, x0)


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(s, t) for s, t in zip(a, b))


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("pivot", [False, True])
def test_sweep_ignores_factor_and_cols_on_cpu(q, pivot):
    """One sweep, with and without k: a factor and any chunk width give the
    plain sweep's bits."""
    fs, ops, v, x0, _, _ = _case(q)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)
    fac = sweep_factor(fs.saphi, fs.w_s, pivot=pivot)
    assert fac.data.shape == (fs.D,
                              cr_factor_size(fs.npad // fs.w_s, fs.w_s))
    assert (fac.w, fac.n, fac.pivot) == (fs.w_s, fs.npad, pivot)
    for want in (False, True):
        ref = fused_gauss_seidel_iter_plain(*ops, v, x0, want_resid=want,
                                            **kw)
        assert _same(fused_gauss_seidel_iter(*ops, v, x0, want_resid=want,
                                             **kw), ref)
        for cols in (None, 1, 2, 4, 8):
            assert _same(fused_gauss_seidel_iter(
                *ops, v, x0, want_resid=want, factors=fac, cols=cols, **kw),
                ref), cols


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("pivot", [False, True])
def test_whole_solve_ignores_factor_and_cols_on_cpu(q, pivot):
    """The whole solve (7 sweeps, x and k) with a factor and any chunk
    width gives the plain whole solve's bits; no kernel launches."""
    fs, ops, v, x0, _, _ = _case(q)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, iters=7, pivot=pivot)
    fac = sweep_factor(fs.saphi, fs.w_s, pivot=pivot)
    _build.reset_launch_counts()
    ref = mega_gauss_seidel_plain(*ops, v, x0, **kw)
    for cols in (None, 1, 2, 4, 8):
        assert _same(mega_gauss_seidel_solve(*ops, v, x0, factors=fac,
                                             cols=cols, **kw), ref), cols
    assert _same(mega_gauss_seidel_solve(*ops, v, x0, **kw), ref)
    assert sum(_build.launch_counts().values()) == 0


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("warm", [False, True])
def test_megasolve_gauss_seidel_on_cpu(q, warm):
    """``MegaSolve.gauss_seidel`` gives the plain whole solve's bits on the
    padded state."""
    fs, ops, v_p, _, v, x0 = _case(q)
    v = torch.as_tensor(v)
    x0 = torch.as_tensor(x0) if warm else None
    ms = MegaSolve(fs)
    ref = ms.gauss_seidel(v, x0, iters=6)
    start = fs.pad_state(x0) if warm else torch.zeros_like(v_p)
    xp, kp = mega_gauss_seidel_plain(*ops, v_p, start, w_p=fs.w_p,
                                     w_s=fs.w_s, iters=6)
    assert _same(ref, (fs.unpad(xp), fs.unpad(kp)))


@pytest.mark.parametrize("q", [0, 1, 2])
def test_plain_backend_holds_no_factor(q):
    """On the plain backend ``cr_factors`` and ``saphi_factor`` are None and
    a sweep or whole solve makes no factor: the plain versions solve from
    the bands."""
    fs, _, v_p, x0_p, v, _ = _case(q)
    assert fs.cr_factors() is None and fs.saphi_factor() is None
    _build.reset_launch_counts()
    fs.gauss_seidel_iter(v_p, x0_p, want_resid=True)
    MegaSolve(fs).gauss_seidel(torch.as_tensor(v), None, iters=2)
    assert fs._factors == {}
    assert sum(_build.launch_counts().values()) == 0


@pytest.mark.parametrize("fused", ["whole", "on"])
def test_gauss_seidel_solve_mhat_cpu_makes_no_factor(fused):
    """``solve_mhat`` with Gauss-Seidel on the CPU, "whole" and "on": the
    same bits in both modes (one machine code on the card, one plain sweep
    here), and no factor launch."""
    rng = np.random.default_rng(75)
    dops = dim_ops(solve_operands(rng, N, DIMS, 1), "cpu")
    v = torch.as_tensor(rng.standard_normal((DIMS, N, 3)))
    _build.reset_launch_counts()
    out = solve_mhat(dops, v, SolveConfig(method="gauss_seidel", iters=5,
                                          fused=fused), return_info=True)
    ref = solve_mhat(dops, v, SolveConfig(method="gauss_seidel", iters=5,
                                          fused="whole"), return_info=True)
    assert torch.equal(out[0], ref[0])
    assert torch.equal(out[1].resid, ref[1].resid)
    assert _build.launch_counts()["cr_factor"] == 0


def _factor_calls(fs, ops, v, x0):
    """Each sweep-kernel wrapper that takes ``factors=``, as a function of
    (factors, pivot)."""
    kw = dict(w_p=fs.w_p, w_s=fs.w_s)
    pkw = dict(kw, w_a=fs.w_a)
    a_ops = (fs.a,) + ops
    rz = torch.ones((1, v.shape[-1]), dtype=torch.float64)
    return {
        "fused_gauss_seidel_iter": lambda f, p: fused_gauss_seidel_iter(
            *ops, v, x0, pivot=p, factors=f, **kw),
        "mega_gauss_seidel_solve": lambda f, p: mega_gauss_seidel_solve(
            *ops, v, x0, iters=2, pivot=p, factors=f, **kw),
        "pcg_seed": lambda f, p: pcg_seed(*a_ops, v, x0, warm=True, pivot=p,
                                          factors=f, **pkw),
        "fused_pcg_iter": lambda f, p: fused_pcg_iter(
            *a_ops, x0, v, v, rz, pivot=p, factors=f, **pkw),
        "mega_pcg_solve": lambda f, p: mega_pcg_solve(
            *a_ops, v, x0, iters=2, pivot=p, factors=f, **pkw),
        "fused_jacobi_iter": lambda f, p: fused_jacobi_iter(
            *ops, v, x0, alpha=0.5, warm=True, pivot=p, factors=f, **kw),
        "mega_jacobi_solve": lambda f, p: mega_jacobi_solve(
            *ops, v, x0, alpha=0.5, iters=2, warm=True, pivot=p, factors=f,
            **kw),
    }


@pytest.mark.parametrize("name", ["fused_gauss_seidel_iter",
                                  "mega_gauss_seidel_solve", "pcg_seed",
                                  "fused_pcg_iter", "mega_pcg_solve",
                                  "fused_jacobi_iter", "mega_jacobi_solve"])
def test_factor_of_other_pivot_mode_raises(name):
    """A factor made in one pivot mode has the shape of the other mode's,
    and a kernel would solve wrongly from it: every wrapper that takes
    ``factors=`` rejects it (here on CPU tensors, where the plain version
    would otherwise ignore it), as it rejects a bare tensor; a factor of
    the call's own mode runs."""
    fs, ops, v, x0, _, _ = _case(1)
    pair = "gauss_seidel" not in name  # (Phi's, SAPhi's), as pcg_factors
    call = _factor_calls(fs, ops, v, x0)[name]
    for pivot in (False, True):
        make = (lambda p: pcg_factors(fs.phi, fs.saphi, w_p=fs.w_p,
                                      w_s=fs.w_s, pivot=p)) if pair else (
            lambda p: sweep_factor(fs.saphi, fs.w_s, pivot=p))
        call(make(pivot), pivot)
        with pytest.raises(ValueError, match="pivot"):
            call(make(not pivot), pivot)
    bare = block_cr_factor(fs.saphi, fs.w_s)
    with pytest.raises(TypeError, match="sweep_factor"):
        call((None, bare) if pair else bare, False)
