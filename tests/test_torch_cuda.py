"""The port's CUDA kernels against their plain versions, on the card.

Every test needs an NVIDIA GPU and nvcc and skips without them. Run on the
card with ``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(``--noconftest``: the repository's conftest imports JAX, which the card's
machine does not need). Inputs come from numpy seeds; the kernel and its
plain version get the same CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import (GPConfig, fit, log_likelihood, mll_gradients,
                              posterior_mean, posterior_var)
from repro_torch.core.band_inverse import _to_blocks
from repro_torch.kernels import _build, ops
from repro_torch.kernels.band_matmul import band_matmul, band_matmul_plain
from repro_torch.kernels.banded_lu import banded_lu, banded_lu_plain
from repro_torch.kernels.banded_matvec import (banded_matvec,
                                               banded_matvec_plain)
from repro_torch.kernels.block_cr import block_cr, block_cr_plain
from repro_torch.kernels.mega_solve import (MegaSolve, mega_pcg_plain,
                                            mega_pcg_solve)
from repro_torch.kernels.rgf import rgf_blocks, rgf_blocks_plain
from torch_port_inputs import band, padded_operands, points, solve_operands

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (2, 2), (1, 2)])
def test_banded_lu_kernel(dev, lo, hi):
    rng = np.random.default_rng(1)
    bd = torch.as_tensor(band(rng, 3, 300, lo, hi), device=dev)
    rhs = torch.as_tensor(rng.standard_normal((3, 300, 5)), device=dev)
    x, ld = banded_lu(bd, rhs, lo, hi)
    xr, ldr = banded_lu_plain(bd, rhs, lo, hi)
    assert _rel(x, xr) < 1e-12 and _rel(ld, ldr) < 1e-12


@pytest.mark.parametrize("widths", [(1, 1, 0, 0), (2, 2, 1, 1)])
def test_band_matmul_kernel(dev, widths):
    rng = np.random.default_rng(2)
    a_lo, a_hi, b_lo, b_hi = widths
    a = torch.as_tensor(band(rng, 4, 257, a_lo, a_hi), device=dev)
    b = torch.as_tensor(band(rng, 4, 257, b_lo, b_hi), device=dev)
    assert _rel(band_matmul(a, b, *widths), band_matmul_plain(a, b, *widths)) < 1e-14


@pytest.mark.parametrize("w", [1, 3])
def test_rgf_kernel(dev, w):
    rng = np.random.default_rng(3)
    data = torch.as_tensor(band(rng, 3, 150, w, w), device=dev)
    blocks = [t.contiguous() for t in _to_blocks(data, w, w, w)]
    for k, p in zip(rgf_blocks(*blocks), rgf_blocks_plain(*blocks)):
        assert _rel(k, p) < 1e-10


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("warm", [False, True])
def test_mega_pcg_kernel(dev, q, B, warm):
    rng = np.random.default_rng(4)
    ops = solve_operands(rng, 131, 3, q)
    fs, v, x0 = padded_operands(ops, dev, B, rng)
    v_p, x0_p = fs.pad_state(torch.as_tensor(v)), fs.pad_state(torch.as_tensor(x0))
    if not warm:
        x0_p = torch.zeros_like(v_p)
    args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p, x0_p)
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=25, warm=warm)
    # r is updated recursively (r -= alpha A p, |alpha A p| >> |r| once
    # converged), so its rounding is judged against the right-hand side's
    # scale; the kernel's and the plain version's summation orders leave
    # ~5e-9 of |v| there on the card
    scale = float(v_p.abs().max())
    x, r, it = mega_pcg_solve(*args, **kw)
    xr, rr, itr = mega_pcg_plain(*args, **kw)
    assert _rel(x, xr) < 1e-9 and int(it) == int(itr) == 25
    assert float((r - rr).abs().max()) / scale < 1e-7
    x, r, it = mega_pcg_solve(*args, tol=1e-8, **kw)
    xr, rr, itr = mega_pcg_plain(*args, tol=1e-8, **kw)
    assert int(it) == int(itr) and _rel(x, xr) < 1e-9


def test_gp_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    n, D = 700, 3
    X = points(rng, n, D)
    Y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    Xq = rng.uniform(0, 4, (40, D))
    cfg = GPConfig(q=0, solver_iters=40, precond="none")
    omega = np.full(D, 2.0)
    _build.reset_launch_counts()
    g = fit(cfg, X, Y, omega, 0.5)
    mu, var = posterior_mean(g, Xq), posterior_var(g, Xq)
    counts = _build.launch_counts()
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    assert _rel(mu, posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(var, posterior_var(c, Xq, device="cpu")) < 1e-7
    serving = ("banded_lu", "band_matmul", "rgf_blocks", "mega_pcg")
    assert all(counts[k] > 0 for k in serving), counts


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (2, 2), (1, 2), (3, 3),
                                   (8, 8)])
def test_banded_matvec_kernel(dev, lo, hi):
    rng = np.random.default_rng(6)
    bd = torch.as_tensor(band(rng, 3, 301, lo, hi), device=dev)
    x = torch.as_tensor(rng.standard_normal((3, 301, 7)), device=dev)
    assert _rel(banded_matvec(bd, x, lo, hi),
                banded_matvec_plain(bd, x, lo, hi)) < 1e-13
    # the vector form through ops (a trailing axis of one column)
    y = ops.banded_matvec(bd, x[..., 0], lo, hi)
    assert y.shape == (3, 301)
    assert _rel(y, banded_matvec_plain(bd, x, lo, hi)[..., 0]) < 1e-13


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("n", [8, 301])
@pytest.mark.parametrize("pivot", [False, True])
def test_block_cr_kernel(dev, w, n, pivot):
    rng = np.random.default_rng(7)
    bd = torch.as_tensor(band(rng, 3, n, w, w), device=dev)
    rhs = torch.as_tensor(rng.standard_normal((3, n, 5)), device=dev)
    x, ld = block_cr(bd, rhs, w, pivot=pivot)
    xr, ldr = block_cr_plain(bd, rhs, w, pivot=pivot)
    assert _rel(x, xr) < 1e-12 and _rel(ld, ldr) < 1e-12
    x0, ld0 = block_cr(bd, rhs, w, pivot=pivot, solve=False)
    assert x0 is None and _rel(ld0, ldr) < 1e-12


@pytest.mark.parametrize("B", [160, 300])
def test_mega_pcg_column_chunks(dev, B):
    """More than MAX_B = 256 columns: fixed-count solves run in chunks."""
    rng = np.random.default_rng(8)
    ops_np = solve_operands(rng, 131, 3, 0)
    fs, v, _ = padded_operands(ops_np, dev, B, rng)
    v_t = torch.as_tensor(v, device=dev)
    _build.reset_launch_counts()
    x, r, it = MegaSolve(fs).pcg(v_t, None, iters=25, tol=0.0)
    assert _build.launch_counts()["mega_pcg"] == -(-B // 256)
    args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2,
            fs.pad_state(v_t), torch.zeros_like(fs.pad_state(v_t)))
    xr, rr, itr = mega_pcg_plain(*args, w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s,
                                 iters=25)
    assert x.shape == v_t.shape and int(it) == int(itr) == 25
    assert _rel(x, fs.unpad(xr)) < 1e-9
    if B > 256:
        with pytest.raises(ValueError, match="cannot be split"):
            MegaSolve(fs).pcg(v_t, None, iters=25, tol=1e-8)


def _gp_data(rng, n, D):
    X = points(rng, n, D)
    Y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, Y, rng.uniform(0, 4, (40, D))


def test_likelihood_and_gradients_card_match_cpu(dev):
    """Same probes on the card and the CPU (one CPU generator seed)."""
    rng = np.random.default_rng(9)
    X, Y, _ = _gp_data(rng, 700, 3)
    cfg = GPConfig(q=0, solver_iters=40, precond="none")
    omega = np.full(3, 2.0)
    _build.reset_launch_counts()
    g = fit(cfg, X, Y, omega, 0.5)
    ll, vd = log_likelihood(g, torch.Generator().manual_seed(0),
                            return_verdict=True)
    go, gs, info = mll_gradients(g, torch.Generator().manual_seed(1),
                                 return_info=True)
    counts = _build.launch_counts()
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    llc = log_likelihood(c, torch.Generator().manual_seed(0))
    goc, gsc = mll_gradients(c, torch.Generator().manual_seed(1))
    assert int(vd) == 0 and int(info.verdict) == 0
    assert _rel(ll, llc) < 1e-7
    assert _rel(go, goc) < 1e-7 and _rel(gs, gsc) < 1e-7
    assert all(v > 0 for v in counts.values()), counts


def test_q1_card_matches_cpu(dev):
    rng = np.random.default_rng(10)
    X, Y, Xq = _gp_data(rng, 500, 3)
    cfg = GPConfig(q=1, solver_iters=60, precond="none")
    omega = np.full(3, 4.0)
    g = fit(cfg, X, Y, omega, 0.5)
    c = fit(cfg, X, Y, omega, 0.5, device="cpu")
    assert _rel(posterior_mean(g, Xq), posterior_mean(c, Xq, device="cpu")) < 1e-7
    assert _rel(posterior_var(g, Xq), posterior_var(c, Xq, device="cpu")) < 1e-7
    assert _rel(log_likelihood(g, torch.Generator().manual_seed(2)),
                log_likelihood(c, torch.Generator().manual_seed(2))) < 1e-7


def test_q2_on_card_raises(dev):
    with pytest.raises(NotImplementedError, match="widths"):
        fit(GPConfig(q=2, precond="none"), points(np.random.default_rng(0), 50, 2),
            np.zeros(50), np.ones(2), 1.0)
