"""The port's plain kernel versions against the JAX package, on the CPU.

Each kernel module of ``repro_torch`` holds a plain PyTorch version of its
CUDA kernel; on CPU tensors the wrappers run it. Here it is held against
the JAX package's Pallas kernel (interpret mode, as the package's own tests
run it) and against the port's dense oracle (``repro_torch.kernels.ref``),
on the same seeded float64 inputs. Direct methods must agree to 1e-10
relative; the PCG solve to 1e-8.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.banded import _band_mask as jax_band_mask
from repro.kernels.band_matmul import band_matmul_pallas
from repro.kernels.banded_lu import banded_lu_pallas
from repro.kernels.fused_sweep import FusedSweep as JaxFusedSweep
from repro.kernels.kp_gram import kp_gram_pallas
from repro.kernels.mega_solve import mega_pcg_solve_pallas
from repro.kernels.rgf import rgf_inverse_band as jax_rgf_inverse_band
from repro_torch.core.kernel_packets import kp_factors
from repro_torch.kernels import ops, ref
from repro_torch.kernels.banded_lu import banded_lu
from repro_torch.kernels.fused_sweep import _pad_len
from repro_torch.kernels.kp_gram import kp_gram_plain, kp_gram_table_plain
from repro_torch.kernels.mega_solve import mega_pcg_solve
from repro_torch.kernels.rgf import rgf_inverse_band
from torch_port_inputs import (OMEGA, band, padded_operands, points,
                               solve_operands)
from torch_port_jax_ref import fresh_jax_caches  # noqa: F401 (autouse)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (2, 2), (1, 2)])
def test_banded_lu_plain_matches_pallas(lo, hi):
    rng = np.random.default_rng(10 + 3 * lo + hi)
    bd = band(rng, 2, 37, lo, hi)
    rhs = rng.standard_normal((2, 37, 3))
    x, ld = banded_lu(torch.as_tensor(bd), torch.as_tensor(rhs), lo, hi)
    xj, ldj = banded_lu_pallas(jnp.asarray(bd), jnp.asarray(rhs), lo, hi,
                               interpret=True)
    assert _rel(x, xj) < 1e-10 and _rel(ld, ldj) < 1e-10
    for g in range(2):
        b_t = torch.as_tensor(bd[g])
        assert _rel(x[g], ref.banded_solve_ref(b_t, torch.as_tensor(rhs[g]),
                                               lo, hi)) < 1e-10
        assert _rel(ld[g], ref.banded_logdet_ref(b_t, lo, hi)) < 1e-10


@pytest.mark.parametrize("widths", [(1, 1, 0, 0), (2, 2, 1, 1)])
def test_band_matmul_plain_matches_pallas(widths):
    a_lo, a_hi, b_lo, b_hi = widths
    rng = np.random.default_rng(20 + a_lo)
    a = band(rng, 2, 37, a_lo, a_hi)
    b = band(rng, 2, 37, b_lo, b_hi)
    out = ops.band_band_matmul(torch.as_tensor(a), torch.as_tensor(b), *widths)
    outj = band_matmul_pallas(jnp.asarray(a), jnp.asarray(b), *widths,
                              interpret=True)
    outj = outj * jax_band_mask(37, a_lo + b_lo, a_hi + b_hi)
    assert _rel(out, outj) < 1e-10
    for g in range(2):
        oracle = ref.band_matmul_ref(torch.as_tensor(a[g]),
                                     torch.as_tensor(b[g]), *widths)
        assert _rel(out[g], oracle) < 1e-10


@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("n", [8, 37])
def test_rgf_plain_matches_pallas(w, n):
    rng = np.random.default_rng(30 + w + n)
    h = band(rng, 2, n, w, w)
    g = rgf_inverse_band(torch.as_tensor(h), w, w, w)
    gj = jax_rgf_inverse_band(jnp.asarray(h), w, w, w, interpret=True)
    assert _rel(g, gj) < 1e-10
    for k in range(2):
        oracle = ref.rgf_band_inverse_ref(torch.as_tensor(h[k]), w, w, w)
        assert _rel(g[k], oracle) < 1e-10


# --- whole PCG solve -------------------------------------------------------
# One interpret-mode JAX solve per (q, n) serves every case: a tol-exit run
# over 8 columns, warm-started from x0 = 0 in columns 0-3 (exactly a cold
# start: r = v - Mhat 0 = v) and from a random x0 in columns 4-7. The exit
# only decides how many iterations run, and at a fixed count the columns
# are independent, so the port's fixed-count solves of any column subset
# are held against the matching columns.

_TOL = 1e-8
_MAX_ITERS = 80


@pytest.fixture(scope="module")
def mega_case():
    cache = {}

    def get(q, n):
        if (q, n) not in cache:
            rng = np.random.default_rng(40 + 7 * q + n)
            ops_np = solve_operands(rng, n, 2, q)
            fs, v, x0 = padded_operands(ops_np, "cpu", 8, rng)
            x0[:, :, :4] = 0.0
            jfs = JaxFusedSweep(
                jnp.asarray(ops_np["Phi"]), jnp.asarray(ops_np["SAPhi"]),
                jnp.asarray(ops_np["sort_idx"]),
                jnp.asarray(ops_np["rank_idx"]), ops_np["sigma2"],
                w_p=ops_np["w_p"], w_s=ops_np["w_s"],
                a=jnp.asarray(ops_np["A"]), w_a=ops_np["w_a"], interpret=True)
            x, r, it = mega_pcg_solve_pallas(
                jfs.a, jfs.phi, jfs.saphi, jfs.sort_idx, jfs.rank_idx,
                jfs.sigma2, jfs.pad_state(jnp.asarray(v)),
                jfs.pad_state(jnp.asarray(x0)), w_a=jfs.w_a, w_p=jfs.w_p,
                w_s=jfs.w_s, iters=_MAX_ITERS, tol=_TOL, warm=True,
                interpret=True)
            cache[q, n] = (fs, v, x0, np.asarray(jfs.unpad(x)),
                           np.asarray(jfs.unpad(r)), int(it))
        return cache[q, n]

    return get


def _port_solve(fs, v, x0, warm, iters, tol):
    v_p = fs.pad_state(torch.as_tensor(v))
    x0_p = fs.pad_state(torch.as_tensor(x0)) if warm else torch.zeros_like(v_p)
    x, r, it = mega_pcg_solve(fs.a, fs.phi, fs.saphi, fs.sort_idx,
                              fs.rank_idx, fs.sigma2, v_p, x0_p, w_a=fs.w_a,
                              w_p=fs.w_p, w_s=fs.w_s, iters=iters, tol=tol,
                              warm=warm)
    return fs.unpad(x).numpy(), fs.unpad(r).numpy(), int(it)


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("n", [37, 128])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("warm", [False, True])
def test_mega_pcg_plain_matches_pallas(mega_case, q, n, B, warm):
    fs, v, x0, xj, rj, itj = mega_case(q, n)
    assert fs.npad == _pad_len(n, (fs.w_p, fs.w_s))
    cols = slice(4, 4 + B) if warm else slice(0, B)
    x, r, it = _port_solve(fs, v[..., cols], x0[..., cols], warm, itj, 0.0)
    assert it == itj
    assert _rel(x, xj[..., cols]) < 1e-8
    # r is the recursively updated residual, small after convergence: judge
    # its rounding against the right-hand side it was carved from
    assert np.max(np.abs(r - rj[..., cols])) / np.max(np.abs(v)) < 1e-8


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("n", [37, 128])
def test_mega_pcg_tol_exit_matches_pallas(mega_case, q, n):
    fs, v, x0, xj, rj, itj = mega_case(q, n)
    x, r, it = _port_solve(fs, v, x0, True, _MAX_ITERS, _TOL)
    assert 0 < it == itj < _MAX_ITERS
    assert _rel(x, xj) < 1e-8


# --- building blocks the kernels sit on -----------------------------------


def test_masking_matches_jax():
    from repro import masking as jm
    from repro_torch import masking as tm

    rng = np.random.default_rng(50)
    band_np = rng.standard_normal((2, 11, 4))
    x_np = rng.standard_normal((2, 11, 3))
    idx_np = np.stack([rng.permutation(11) for _ in range(2)])
    for na in (None, 7):
        np.testing.assert_array_equal(
            tm.canonical_band(torch.as_tensor(band_np), 1, 2, na).numpy(),
            np.asarray(jm.canonical_band(jnp.asarray(band_np), 1, 2, na)))
        np.testing.assert_array_equal(
            tm.mask_rows(torch.as_tensor(x_np), na, axis=1).numpy(),
            np.asarray(jm.mask_rows(jnp.asarray(x_np), na, axis=1)))
        np.testing.assert_array_equal(
            tm.canonical_perm(torch.as_tensor(idx_np), na).numpy(),
            np.asarray(jm.canonical_perm(jnp.asarray(idx_np), na)))
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(
            tm.tree_sum(torch.as_tensor(x_np), axis).numpy(),
            np.asarray(jm.tree_sum(jnp.asarray(x_np), axis)))


@pytest.mark.parametrize("w", [1, 2])
def test_block_cr_plain_solve_and_logdet(w):
    rng = np.random.default_rng(60 + w)
    bd = band(rng, 2, 37, w, w)
    rhs = rng.standard_normal((2, 37, 3))
    x = ops.banded_solve(torch.as_tensor(bd), torch.as_tensor(rhs), w, w)
    ld = ops.banded_logdet(torch.as_tensor(bd), w, w)
    for g in range(2):
        b_t = torch.as_tensor(bd[g])
        assert _rel(x[g], ref.banded_solve_ref(b_t, torch.as_tensor(rhs[g]),
                                               w, w)) < 1e-10
        assert _rel(ld[g], ref.banded_logdet_ref(b_t, w, w)) < 1e-10


@pytest.mark.parametrize("q", [0, 1])
def test_dimops_and_mhat_matvec_match_jax(q):
    from repro.core.backfitting import DimOps as JaxDimOps
    from repro.core.backfitting import mhat_matvec as jax_mhat_matvec
    from repro.core.banded import Banded as JaxBanded
    from repro_torch.core.backfitting import DimOps, mhat_matvec
    from repro_torch.core.banded import Banded

    rng = np.random.default_rng(70 + q)
    o = solve_operands(rng, 37, 2, q)
    u = rng.standard_normal((2, 37, 3))
    w = {"A": o["w_a"], "Phi": o["w_p"], "SAPhi": o["w_s"]}
    t_ops = DimOps(*(Banded(torch.as_tensor(o[k]), w[k], w[k]) for k in w),
                   sort_idx=torch.as_tensor(o["sort_idx"]),
                   rank_idx=torch.as_tensor(o["rank_idx"]),
                   sigma2=torch.tensor(o["sigma2"], dtype=torch.float64))
    j_ops = JaxDimOps(*(JaxBanded(jnp.asarray(o[k]), w[k], w[k]) for k in w),
                      sort_idx=jnp.asarray(o["sort_idx"]),
                      rank_idx=jnp.asarray(o["rank_idx"]),
                      sigma2=jnp.asarray(o["sigma2"]))
    ut, uj = torch.as_tensor(u), jnp.asarray(u)
    assert _rel(mhat_matvec(t_ops, ut),
                jax_mhat_matvec(j_ops, uj, backend="pallas")) < 1e-10
    assert _rel(t_ops.block_solve(ut),
                j_ops.block_solve(uj, backend="pallas")) < 1e-10


@pytest.mark.parametrize("q", [0, 1, 2, 3])
def test_kp_gram_plain_matches_pallas(q):
    """kp_gram's plain version against the Pallas kernel (interpret, block
    128, n = 300 not a multiple of it), the dense-gather oracle and the fit's
    own Phi band (``kp_factors``) on a jittered grid: 1e-12 relative.

    Phi = A K cancels by design (A annihilates K's smooth part): at q = 2
    here |Phi| ~ 1e-6 while the summed terms |A K| reach ~2 (|k| <= 1), so
    one ulp of difference between XLA's and torch's exp reads ~4e-10 of
    |Phi|. The Pallas comparison is therefore relative to the terms' scale,
    max_i sum_t |A[i, t]|; the torch oracles share torch's exp and are held
    relative to |Phi|."""
    rng = np.random.default_rng(60 + q)
    n = 300
    xs = torch.as_tensor(np.sort(points(rng, n, 1)[:, 0]))
    A, Phi = kp_factors(q, torch.tensor(OMEGA, dtype=torch.float64), xs)
    phi = ops.kp_gram(q, OMEGA, xs, A.data, block=128)
    want = kp_gram_pallas(q, OMEGA, jnp.asarray(xs.numpy()),
                          jnp.asarray(A.data.numpy()), block=128,
                          interpret=True)
    assert phi.shape == (n, 2 * q + 1)
    terms = float(A.data.abs().sum(-1).max())
    assert float(np.abs(phi.numpy() - np.asarray(want)).max()) / terms < 1e-12
    assert _rel(phi, ref.kp_gram_ref(q, OMEGA, xs, A.data)) < 1e-12
    assert _rel(phi, Phi.data) < 1e-12


@pytest.mark.parametrize("n", [1, 2, "window", 255, 256, 257, 1000])
@pytest.mark.parametrize("q", [0, 1, 2, 3])
def test_kp_gram_table_twin_bitwise(q, n):
    """The CUDA kernel's order replayed in plain torch (one Matern value per
    distinct pair, read from a table) equals kp_gram_plain bit for bit on
    the CPU: fewer rows than the window (n < 2q+3), the window itself,
    and one row either side of a 256-row edge."""
    n = 2 * q + 3 if n == "window" else n
    rng = np.random.default_rng(70 + 10 * q + n)
    xs = torch.as_tensor(np.sort(points(rng, n, 1)[:, 0]))
    a = torch.as_tensor(rng.standard_normal((n, 2 * q + 3)))
    want = kp_gram_plain(q, OMEGA, xs, a)
    got = kp_gram_table_plain(q, OMEGA, xs, a)
    assert got.shape == (n, 2 * q + 1)
    assert torch.equal(got, want)
