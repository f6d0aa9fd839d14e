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

from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
from repro_torch.core.band_inverse import _to_blocks
from repro_torch.kernels import _build
from repro_torch.kernels.band_matmul import band_matmul, band_matmul_plain
from repro_torch.kernels.banded_lu import banded_lu, banded_lu_plain
from repro_torch.kernels.mega_solve import mega_pcg_plain, mega_pcg_solve
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
    assert all(v > 0 for v in counts.values()), counts


def test_q1_on_card_raises(dev):
    with pytest.raises(NotImplementedError):
        fit(GPConfig(q=1, precond="none"), points(np.random.default_rng(0), 50, 2),
            np.zeros(50), np.ones(2), 1.0)
