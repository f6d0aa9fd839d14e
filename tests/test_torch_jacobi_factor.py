"""The Jacobi wrappers' held block-CR factors and column chunks, on the CPU,
and the one owner of SAPhi's factor.

On the card the Jacobi kernel solves SAPhi (and, on a warm start at
w_p >= 1, Phi) from block-CR factors (``factors=``, made once per
``FusedSweep``) in items of ``cols`` columns. On CPU tensors the wrappers
run the plain versions, which solve from the bands: both arguments must
leave their results unchanged, bit for bit, and the plain backend must
hold no factor of its own. A ``FusedSweep`` built for a solve takes the
factors its ``DimOps`` made at fit wherever their padding to whole blocks
is the stack's. The chunk rule (``csrc/sweep.cuh`` auto_cols) is held
through the kernel's own queries on the card (``tests/test_torch_cuda.py``).

Inputs are seeded numpy draws on jittered grids (``torch_port_inputs``),
n = 61, D = 3, B = 5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.backfitting import SolveConfig, _maybe_fused, solve_mhat
from repro_torch.kernels import _build
from repro_torch.kernels.fused_sweep import (MAX_B, fused_jacobi_iter,
                                             fused_jacobi_iter_plain,
                                             pcg_factors)
from repro_torch.kernels.mega_solve import (MegaSolve, mega_jacobi_plain,
                                            mega_jacobi_solve)
from torch_port_inputs import dim_ops, padded_operands, solve_operands

torch.set_num_threads(2)

N, DIMS, B = 61, 3, 5
ALPHA = 0.4


def _case(q):
    rng = np.random.default_rng(80 + q)
    fs, v, x0 = padded_operands(solve_operands(rng, N, DIMS, q), "cpu", B,
                                rng)
    ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    k = fs.pad_state(torch.as_tensor(0.1 * rng.standard_normal(v.shape)))
    return (fs, ops, fs.pad_state(torch.as_tensor(v)),
            fs.pad_state(torch.as_tensor(x0)), k, v, x0)


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(s, t) for s, t in zip(a, b))


def _factors(fs, pivot):
    return pcg_factors(fs.phi, fs.saphi, w_p=fs.w_p, w_s=fs.w_s, pivot=pivot)


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("pivot", [False, True])
def test_sweep_ignores_factors_and_cols_on_cpu(q, pivot):
    """One sweep without k, with k carried and from a warm start: held
    factors and any chunk width give the plain sweep's bits."""
    fs, ops, v, x0, k, _, _ = _case(q)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, alpha=ALPHA, pivot=pivot)
    fac = _factors(fs, pivot)
    assert (fac[0] is None) == (fs.w_p == 0)
    for extra in ({}, {"k": k}, {"warm": True}):
        ref = fused_jacobi_iter_plain(*ops, v, x0, **extra, **kw)
        assert _same(fused_jacobi_iter(*ops, v, x0, **extra, **kw), ref)
        for cols in (None, 1, 2, 4, 8):
            assert _same(fused_jacobi_iter(*ops, v, x0, factors=fac,
                                           cols=cols, **extra, **kw),
                         ref), (extra.keys(), cols)


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("pivot", [False, True])
def test_whole_solve_ignores_factors_and_cols_on_cpu(q, pivot):
    """The whole solve (7 sweeps, x and k), cold and warm, with held
    factors and any chunk width gives the plain whole solve's bits; no
    kernel launches."""
    fs, ops, v, x0, _, _, _ = _case(q)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, alpha=ALPHA, iters=7, pivot=pivot)
    fac = _factors(fs, pivot)
    _build.reset_launch_counts()
    for warm in (False, True):
        start = x0 if warm else torch.zeros_like(v)
        ref = mega_jacobi_plain(*ops, v, start, warm=warm, **kw)
        assert _same(mega_jacobi_solve(*ops, v, start, warm=warm, **kw), ref)
        for cols in (None, 1, 2, 4, 8):
            assert _same(mega_jacobi_solve(*ops, v, start, warm=warm,
                                           factors=fac, cols=cols, **kw),
                         ref), (warm, cols)
    assert sum(_build.launch_counts().values()) == 0


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("warm", [False, True])
def test_megasolve_jacobi_on_cpu(q, warm):
    """``MegaSolve.jacobi`` gives the plain whole solve's bits on the
    padded state."""
    fs, ops, v_p, _, _, v, x0 = _case(q)
    v = torch.as_tensor(v)
    x0 = torch.as_tensor(x0) if warm else None
    got = MegaSolve(fs).jacobi(v, x0, alpha=ALPHA, iters=6)
    start = fs.pad_state(x0) if warm else torch.zeros_like(v_p)
    xp, kp = mega_jacobi_plain(*ops, v_p, start, w_p=fs.w_p, w_s=fs.w_s,
                               alpha=ALPHA, iters=6, warm=warm)
    assert _same(got, (fs.unpad(xp), fs.unpad(kp)))


@pytest.mark.parametrize("warm", [False, True])
def test_megasolve_jacobi_column_split_on_cpu(warm):
    """More than ``MAX_B`` columns: ``MegaSolve.jacobi`` runs chunks of at
    most ``MAX_B`` (as the kernel must), each with the bits of the plain
    solve of its columns, and within 1e-12 of one plain solve of all."""
    fs, ops, _, _, _, _, _ = _case(1)
    rng = np.random.default_rng(84)
    width = MAX_B + 44
    v = torch.as_tensor(rng.standard_normal((DIMS, N, width)))
    x0 = 0.1 * v if warm else None
    x, k = MegaSolve(fs).jacobi(v, x0, alpha=ALPHA, iters=5)
    assert x.shape == k.shape == (DIMS, N, width)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, alpha=ALPHA, iters=5, warm=warm)

    def plain(cols):
        v_p = fs.pad_state(v[..., cols])
        start = fs.pad_state(x0[..., cols]) if warm else torch.zeros_like(v_p)
        return tuple(fs.unpad(t) for t in mega_jacobi_plain(
            *ops, v_p, start, **kw))

    chunks = [plain(slice(0, MAX_B)), plain(slice(MAX_B, width))]
    assert _same((x, k), tuple(torch.cat(p, dim=-1) for p in zip(*chunks)))
    for got, want in zip((x, k), plain(slice(0, width))):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-12


@pytest.mark.parametrize("q", [0, 1, 2])
def test_plain_backend_holds_no_jacobi_factor(q):
    """On the plain backend the Jacobi sweeps and whole solves make no
    factor: the plain versions solve from the bands."""
    fs, _, v_p, x0_p, k, v, x0 = _case(q)
    assert fs.cr_factors(phi=False) is None
    _build.reset_launch_counts()
    fs.jacobi_iter(v_p, x0_p, ALPHA, k=k)
    fs.jacobi_iter(v_p, x0_p, ALPHA, warm=True)
    MegaSolve(fs).jacobi(torch.as_tensor(v), torch.as_tensor(x0),
                         alpha=ALPHA, iters=2)
    assert fs._factors == {}
    assert sum(_build.launch_counts().values()) == 0


@pytest.mark.parametrize("warm", [False, True])
def test_jacobi_solve_mhat_whole_equals_on_cpu(warm):
    """``solve_mhat`` with Jacobi on the CPU: "whole" and "on" give the
    same bits, the exit residual included (one machine code on the card,
    one plain sweep here), and no factor launch."""
    rng = np.random.default_rng(85)
    dops = dim_ops(solve_operands(rng, N, DIMS, 1), "cpu")
    v = torch.as_tensor(rng.standard_normal((DIMS, N, 3)))
    x0 = 0.5 * v if warm else None
    _build.reset_launch_counts()
    out = {fused: solve_mhat(dops, v, SolveConfig(method="jacobi", iters=5,
                                                  fused=fused),
                             x0=x0, return_info=True)
           for fused in ("whole", "on")}
    assert torch.equal(out["whole"][0], out["on"][0])
    assert torch.equal(out["whole"][1].resid, out["on"][1].resid)
    assert _build.launch_counts()["cr_factor"] == 0


@pytest.mark.parametrize("q,n,want", [
    (0, 61, {"saphi"}), (1, 61, {"saphi"}), (1, 62, {"phi", "saphi"}),
    (2, 61, set()), (2, 66, {"phi", "saphi"})])
@pytest.mark.parametrize("method", ["jacobi", "gauss_seidel", "pcg"])
def test_maybe_fused_takes_dimops_factors(q, n, want, method):
    """The solve's ``FusedSweep`` holds the very factors its ``DimOps``
    made, each where the band's padding to whole blocks is the stack's
    (n a multiple of the band's w against the lcm of w_p and w_s), and
    none made in another pivot mode; on the CPU its solves make no factor
    of their own."""
    rng = np.random.default_rng(86 + q)
    dops = dim_ops(solve_operands(rng, n, DIMS, q), "cpu")
    cfg = SolveConfig(method=method, iters=3, fused="whole")
    v = torch.as_tensor(rng.standard_normal((DIMS, n, 2)))
    mode, fs = _maybe_fused(dops, v, cfg)
    assert mode == "whole"
    assert set(fs._factors) == want
    for name in want:
        held, made = fs._factors[name], getattr(dops, f"{name}_factor")
        assert held.data is made.data and held.n == fs.npad
    other = dataclasses.replace(cfg, pivot=True)
    assert _maybe_fused(dops, v, other)[1]._factors == {}
    ms = MegaSolve(fs)
    if method == "jacobi":
        ms.jacobi(v, v, alpha=ALPHA, iters=2)
    elif method == "gauss_seidel":
        ms.gauss_seidel(v, v, iters=2)
    else:
        ms.pcg(v, v, iters=2, tol=0.0)
    assert set(fs._factors) == want
