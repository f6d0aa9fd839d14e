"""The CUDA kernel's order of the variance band's block inverse, on the CPU.

``csrc/rgf.cu`` eliminates H = A Phi^T by block cyclic reduction and
recovers the band of H^{-1} by selected inversion; ``rgf_blocks_cr_plain``
replays that order in plain torch (the CPU path keeps the reference's RGF
order, ``rgf_blocks_plain``). Here the twin is held against the JAX
package's Pallas kernel (interpret mode) and the dense inverse on
diagonally dominant bands at 1e-10, against the RGF order on the path's own
H from small CPU fits at the bar its conditioning allows, and against an
RGF in extended precision at q = 0, n = 4000.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rgf import rgf_blocks_pallas
from repro_torch.core import GPConfig, fit
from repro_torch.core.band_inverse import (_blocks_to_band, _to_blocks,
                                           variance_band)
from repro_torch.core.banded import Banded, to_dense
from repro_torch.data import sample_test_function
from repro_torch.kernels import ref
from repro_torch.kernels import rgf as rgf_mod
from repro_torch.kernels.rgf import (rgf_blocks_cr_plain, rgf_blocks_plain,
                                     rgf_tile_rows)
from torch_port_inputs import band, points
from torch_port_jax_ref import fresh_jax_caches  # noqa: F401 (autouse)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

CSRC = Path(rgf_mod.__file__).resolve().parents[1] / "csrc" / "rgf.cu"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _blocks(h, w):
    return [t.contiguous() for t in _to_blocks(torch.as_tensor(h), w, w, w)]


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("T", [1, 2, 3, 17, 64, 100, "tiles"])
def test_cr_plain_matches_pallas_and_dense(w, T):
    """"tiles": T = 2P + 5 (P = ``rgf_tile_rows(w)``), so the kernel's tile
    edges and top levels all run."""
    T = 2 * rgf_tile_rows(w) + 5 if T == "tiles" else T
    rng = np.random.default_rng(40 + 7 * w + T)
    h = band(rng, 2, T * w, w, w)
    blocks = _blocks(h, w)
    out = rgf_blocks_cr_plain(*blocks)
    outj = rgf_blocks_pallas(*(jnp.asarray(t.numpy()) for t in blocks),
                             T=T, w=w, interpret=True)
    for k, j in zip(out, outj):
        assert _rel(k, j) < 1e-10
    g = _blocks_to_band(*out, T * w, w)
    for k in range(2):
        oracle = ref.rgf_band_inverse_ref(torch.as_tensor(h[k]), w, w, w)
        assert _rel(g[k], oracle) < 1e-10
    assert not out[1][:, -1].any() and not out[2][:, -1].any()


def _path_h(q, n, D=2):
    """H = A Phi^T of a small CPU fit: q = 0 on uniform points (as the
    Schwefel data, omega = 8 / span), q >= 1 on a jittered grid of spacing
    0.1 at omega = 4 (chip_smoke.py's q >= 1 points)."""
    rng = np.random.default_rng(50 + q)
    if q == 0:
        X = rng.uniform(-500.0, 500.0, (n, D))
        omega = np.full(D, 8.0 / 1000.0)
    else:
        X = points(rng, n, D, span=0.1 * n)
        omega = np.full(D, 4.0)
    Y = np.sin(X).sum(1) + 0.1 * rng.standard_normal(n)
    gp = fit(GPConfig(q=q, solver_iters=40, precond="none"), X, Y, omega,
             0.5, device="cpu")
    return variance_band(gp.ops.A, gp.ops.Phi, return_h=True)[1]


@pytest.mark.parametrize("q", [0, 1, 3])
def test_cr_plain_on_path_h(q):
    """On the path's own H the two orders differ by its conditioning: two
    backward-stable inversions of H agree to about cond(H) eps of G's
    scale, so that is the bar (cond(H) of the worst band, dense, in the
    test)."""
    H = _path_h(q, 300)
    w = max(H.lo, H.hi, 1)
    blocks = [t.contiguous() for t in _to_blocks(H.data, H.lo, H.hi, w)]
    cond = max(np.linalg.cond(to_dense(Banded(H.data[d], H.lo, H.hi)).numpy())
               for d in range(H.data.shape[0]))
    err = ref.rgf_band_error(rgf_blocks_cr_plain(*blocks),
                             rgf_blocks_plain(*blocks))
    assert err <= cond * np.finfo(np.float64).eps, (err, cond)


def test_cr_plain_against_longdouble():
    """q = 0 at the quickstart's size (Schwefel, n = 4000, D = 10): the CR
    order's error against an RGF in extended precision, over Gd, Gu and Gl
    together, is at most twice the float64 RGF's (``chip_smoke.py`` holds
    the kernel to the same gate at n = 30000)."""
    X, Y, _, bounds = sample_test_function("schwefel", 4000, 10, seed=0)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    gp = fit(GPConfig(q=0, solver_iters=40, precond="none"), X, Y, omega,
             1.0, device="cpu")
    H = variance_band(gp.ops.A, gp.ops.Phi, return_h=True)[1]
    blocks = [t.contiguous() for t in _to_blocks(H.data, 1, 1, 1)]
    exact = ref.rgf_longdouble_ref(*blocks)
    err_rgf = ref.rgf_band_error(rgf_blocks_plain(*blocks), exact)
    err_cr = ref.rgf_band_error(rgf_blocks_cr_plain(*blocks), exact)
    assert 0 < err_cr <= 2 * err_rgf, (err_cr, err_rgf)


def test_longdouble_ref_matches_plain():
    """The extended-precision RGF is the float64 one on a well-conditioned
    band."""
    h = band(np.random.default_rng(60), 3, 500, 1, 1)
    blocks = _blocks(h, 1)
    assert ref.rgf_band_error(rgf_blocks_plain(*blocks),
                              ref.rgf_longdouble_ref(*blocks)) < 1e-14


def test_tile_rows_match_kernel():
    """The twin tiles as the kernel does: the same items per tile, and
    P / 2 (node, lane) items of a tile's first level fit them, P not."""
    src = CSRC.read_text()
    items = int(re.search(r"constexpr int TILE_THREADS = (\d+);",
                          src).group(1))
    assert items == rgf_mod.TILE_ITEMS
    for w in rgf_mod.BLOCKS:
        p = rgf_tile_rows(w)
        assert p & (p - 1) == 0 and (p // 2) * w <= items < p * w
