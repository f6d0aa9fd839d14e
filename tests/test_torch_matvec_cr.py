"""The port's banded matvec and standalone block cyclic reduction against the
JAX package, on the CPU.

The plain versions that the wrappers run on CPU tensors are held against
the Pallas kernels in interpret mode (as the package's own tests run them)
and against the dense oracles of ``repro_torch.kernels.ref``, on the same
seeded float64 inputs: the matvec to 1e-13 relative, the block-CR solve and
log-determinant to 1e-12 (a direct method; the pivoted mode swaps rows
inside the w x w blocks, which reorders the rounding). Also here: the ops
routing of ``pivot`` (the LU route's pivoted solves against the
reference's scan), and the column chunks of the whole-PCG solve.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banded as jbanded
from repro.kernels.banded_matvec import banded_matvec_pallas
from repro.kernels.block_cr import block_cr_pallas
from repro_torch.kernels import fused_sweep, mega_solve, ops, ref
from repro_torch.kernels.banded_lu import banded_lu_pivot_plain
from repro_torch.kernels.banded_matvec import banded_matvec
from repro_torch.kernels.block_cr import block_cr
from repro_torch.kernels.mega_solve import MegaSolve, mega_pcg_plain
from torch_port_inputs import band, padded_operands, solve_operands
from torch_port_jax_ref import fresh_jax_caches  # noqa: F401 (autouse)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (2, 2), (1, 2), (3, 3)])
def test_banded_matvec_plain_matches_pallas(lo, hi):
    rng = np.random.default_rng(80 + 3 * lo + hi)
    bd = band(rng, 2, 37, lo, hi)
    x = rng.standard_normal((2, 37, 4))
    y = banded_matvec(torch.as_tensor(bd), torch.as_tensor(x), lo, hi)
    yj = banded_matvec_pallas(jnp.asarray(bd), jnp.asarray(x), lo, hi,
                              block=16, interpret=True)
    assert _rel(y, yj) < 1e-13
    for g in range(2):
        oracle = ref.banded_matvec_ref(torch.as_tensor(bd[g]),
                                       torch.as_tensor(x[g]), lo, hi)
        assert _rel(y[g], oracle) < 1e-13
    # ops: broadcast batch dims and the vector form reach the same values
    yv = ops.banded_matvec(torch.as_tensor(bd), torch.as_tensor(x[..., 1]),
                           lo, hi)
    assert _rel(yv, y[..., 1]) < 1e-15


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("n", [8, 37, 256])
@pytest.mark.parametrize("pivot", [False, True])
def test_block_cr_plain_matches_pallas(w, n, pivot):
    rng = np.random.default_rng(90 + 7 * w + n + pivot)
    bd = band(rng, 2, n, w, w)
    rhs = rng.standard_normal((2, n, 3))
    x, ld = block_cr(torch.as_tensor(bd), torch.as_tensor(rhs), w,
                     pivot=pivot)
    xj, ldj = block_cr_pallas(jnp.asarray(bd), jnp.asarray(rhs), w,
                              pivot=pivot, interpret=True)
    assert _rel(x, xj) < 1e-12 and _rel(ld, ldj) < 1e-12
    x0, ld0 = block_cr(torch.as_tensor(bd), torch.as_tensor(rhs), w,
                       pivot=pivot, solve=False)
    assert x0 is None and _rel(ld0, ldj) < 1e-12
    for g in range(2):
        b_t = torch.as_tensor(bd[g])
        assert _rel(x[g], ref.banded_solve_ref(b_t, torch.as_tensor(rhs[g]),
                                               w, w)) < 1e-12
        assert _rel(ld[g], ref.banded_logdet_ref(b_t, w, w)) < 1e-12


def test_pivoted_block_mode_survives_a_dead_pivot():
    """An odd block (frozen at the first level) whose leading entry is
    zero: the unpivoted block solve meets a zero pivot, the pivoted one
    swaps it away and stays exact."""
    rng = np.random.default_rng(97)
    n, w = 40, 2
    bd = band(rng, 1, n, w, w)
    bd[0, 2, w] = 0.0  # M[2, 2] = 0 in block 1; row 2 keeps M[2, 3] = 5
    bd[0, 2, w + 1] = 5.0
    rhs = rng.standard_normal((1, n, 2))
    b_t, r_t = torch.as_tensor(bd), torch.as_tensor(rhs)
    x, ld = ops.banded_solve(b_t, r_t, w, w, pivot=True)[0], \
        ops.banded_logdet(b_t, w, w, pivot=True)[0]
    xj = block_cr_pallas(jnp.asarray(bd), jnp.asarray(rhs), w, pivot=True,
                         interpret=True)[0][0]
    assert _rel(x, ref.banded_solve_ref(b_t[0], r_t[0], w, w)) < 1e-12
    assert _rel(ld, ref.banded_logdet_ref(b_t[0], w, w)) < 1e-12
    assert _rel(x, xj) < 1e-12
    assert not torch.isfinite(ops.banded_logdet(b_t, w, w)[0])


def test_pivot_on_the_lu_route_raises():
    """(Named from when the route raised.) The LU route's pivoted gbsv
    scan is ported: an asymmetric band, or alg="lu" on w >= 1, solves and
    takes its log-determinant through the pivoted banded LU, its plain twin
    on CPU tensors bit for bit, within 1e-12 of the reference's scan; on a
    diagonal band pivoting is a no-op and the LU kernel runs."""
    rng = np.random.default_rng(98)
    bd = torch.as_tensor(band(rng, 1, 20, 1, 2))
    rhs = torch.as_tensor(rng.standard_normal((1, 20, 2)))
    x = ops.banded_solve(bd, rhs, 1, 2, pivot=True)
    assert torch.equal(x, banded_lu_pivot_plain(bd, rhs, 1, 2)[0])
    xj = jbanded._solve_scan(jbanded.Banded(jnp.asarray(bd.numpy()), 1, 2),
                             jnp.asarray(rhs.numpy()), pivot=True)
    assert _rel(x, xj) < 1e-12
    sym = torch.as_tensor(band(rng, 1, 20, 1, 1))
    ld = ops.banded_logdet(sym, 1, 1, pivot=True, alg="lu")
    assert torch.equal(ld, banded_lu_pivot_plain(sym, None, 1, 1,
                                                 solve=False)[1])
    ldj = jbanded._logdet_scan(jbanded.Banded(jnp.asarray(sym.numpy()), 1, 1))
    assert _rel(ld, ldj) < 1e-12
    diag = torch.as_tensor(band(rng, 1, 20, 0, 0))
    assert torch.equal(ops.banded_logdet(diag, 0, 0, pivot=True),
                       ops.banded_logdet(diag, 0, 0))
    assert torch.equal(ops.banded_solve(diag, rhs, 0, 0, pivot=True),
                       ops.banded_solve(diag, rhs, 0, 0))


@pytest.mark.parametrize("warm", [False, True])
def test_mega_pcg_column_chunks_match_one_solve(monkeypatch, warm):
    """Fixed-count solves wider than MAX_B run as column chunks with the
    same result; a wider tol-exit solve runs its chunks in lockstep, never
    through independent whole-solve calls."""
    rng = np.random.default_rng(99)
    fs, v, x0 = padded_operands(solve_operands(rng, 37, 2, 0), "cpu", 7, rng)
    v_t, x0_t = torch.as_tensor(v), torch.as_tensor(x0) if warm else None
    whole = MegaSolve(fs).pcg(v_t, x0_t, iters=15, tol=0.0)
    calls = []
    plain = mega_solve.mega_pcg_solve
    monkeypatch.setattr(mega_solve, "mega_pcg_solve",
                        lambda *a, **k: calls.append(a[6].shape[-1])
                        or plain(*a, **k))
    monkeypatch.setattr(mega_solve, "MAX_B", 3)
    x, r, it = MegaSolve(fs).pcg(v_t, x0_t, iters=15, tol=0.0)
    assert calls == [3, 3, 1] and int(it) == int(whole[2]) == 15
    assert _rel(x, whole[0]) < 1e-12
    assert np.max(np.abs((r - whole[1]).numpy())) / np.max(np.abs(v)) < 1e-12
    calls.clear()
    MegaSolve(fs).pcg(v_t, x0_t, iters=15, tol=1e-8)
    assert calls == []


@pytest.mark.parametrize("warm", [False, True])
def test_mega_pcg_tol_exit_lockstep_matches_one_solve(monkeypatch, warm):
    """A tol-exit solve of 300 > MAX_B columns runs its two column chunks
    (256 and 44) in lockstep, one per-iteration step each per iteration,
    under the reference's one exit over every column: through the plain
    twins it takes the iterations of one plain PCG over all the columns,
    and the same x to 1e-12."""
    rng = np.random.default_rng(98)
    fs, v, x0 = padded_operands(solve_operands(rng, 37, 2, 0), "cpu", 300,
                                rng)
    v_t, x0_t = torch.as_tensor(v), torch.as_tensor(x0) if warm else None
    widths = []
    step = fused_sweep.fused_pcg_iter
    monkeypatch.setattr(fused_sweep, "fused_pcg_iter",
                        lambda *a, **k: widths.append(a[6].shape[-1])
                        or step(*a, **k))
    x, r, it = MegaSolve(fs).pcg(v_t, x0_t, iters=40, tol=1e-6)
    v_p = fs.pad_state(v_t)
    start = fs.pad_state(x0_t) if warm else torch.zeros_like(v_p)
    xr, rr, itr = mega_pcg_plain(
        fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v_p,
        start, w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=40, tol=1e-6,
        warm=warm)
    assert int(it) == int(itr) < 40
    assert widths == [256, 44] * int(it)
    assert _rel(x, fs.unpad(xr)) < 1e-12
    assert (np.max(np.abs((r - fs.unpad(rr)).numpy())) / np.max(np.abs(v))
            < 1e-12)
