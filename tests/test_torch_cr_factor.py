"""The factored block cyclic reduction and the log-determinant-only banded LU
of the port, on the CPU.

``block_cr_factor_plain`` stores what the elimination computes without the
right-hand side (each level's coefficients, the final block triples), and
``block_cr_apply_plain`` replays the right-hand-side updates from it: the
two together must give ``block_cr_plain``'s solution bit for bit (the same
operations on the same values), and so agree with the JAX package's
``block_cr_solve_pallas`` in interpret mode to 1e-12 (a direct method;
``block_cr_plain`` is held there by ``test_torch_matvec_cr.py``). The
factor's log-determinant is ``block_cr_plain``'s bit for bit, and a
``DimOps`` solves from the factors it holds with the bits of a solve from
the band. Also ``banded_lu(..., solve=False)`` and ``ops.banded_logdet``'s
LU route, held against the JAX package's ``banded_lu_pallas(...,
solve=False)`` and ``ops.banded_logdet`` to 1e-12.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.banded_lu import banded_lu_pallas
from repro.kernels.block_cr import (block_cr_logdet_pallas,
                                    block_cr_solve_pallas)
from repro_torch.core.backfitting import DimOps
from repro_torch.core.banded import matvec, solve
from repro_torch.kernels import ops
from repro_torch.kernels.banded_lu import banded_lu
from repro_torch.kernels.block_cr import (block_cr_apply,
                                          block_cr_apply_plain,
                                          block_cr_factor,
                                          block_cr_factor_plain,
                                          block_cr_plain, cr_factor_size,
                                          pad_band)
from torch_port_inputs import band, dim_ops, solve_operands
from torch_port_jax_ref import fresh_jax_caches  # noqa: F401 (autouse)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("nb", [1, 8, 37])
@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("pivot", [False, True])
def test_factor_apply_equals_block_cr_bitwise(w, nb, B, pivot):
    """nb = 37 is an odd block count (its last row has no right neighbour
    at several levels), nb = 1 has no level at all."""
    rng = np.random.default_rng(300 + 11 * w + nb + 3 * B + pivot)
    bd = torch.as_tensor(band(rng, 2, nb * w, w, w))
    rhs = torch.as_tensor(rng.standard_normal((2, nb * w, B)))
    fac = block_cr_factor(bd, w, pivot=pivot)  # CPU tensors: the plain twin
    assert fac.shape == (2, cr_factor_size(nb, w))
    assert torch.equal(fac, block_cr_factor_plain(bd, w, pivot=pivot))
    x = block_cr_apply_plain(fac, rhs, w, pivot=pivot)
    xr, _ = block_cr_plain(bd, rhs, w, pivot=pivot)
    assert torch.equal(x, xr)
    xj = block_cr_solve_pallas(jnp.asarray(bd.numpy()),
                               jnp.asarray(rhs.numpy()), w, pivot=pivot,
                               interpret=True)
    assert _rel(x, xj) < 1e-12


@pytest.mark.parametrize("w", [1, 2, 3])
def test_factor_layout(w):
    """The factor is the final block triples, then alpha and beta of every
    level's even rows (i = 2^{k+1} j), level by level: its size and the
    blocks' values (B of an identity band stays the identity)."""
    nb = 37
    levels = [-(-nb // (2 << k)) for k in range((nb - 1).bit_length())]
    assert cr_factor_size(nb, w) == (3 * nb + 2 * sum(levels)) * w * w
    bd = torch.zeros((1, nb * w, 2 * w + 1), dtype=torch.float64)
    bd[..., w] = 1.0
    fac = block_cr_factor_plain(bd, w)
    ww = w * w
    eye = torch.eye(w, dtype=torch.float64).expand(nb, w, w)
    assert torch.equal(fac[0, nb * ww:2 * nb * ww].reshape(nb, w, w), eye)
    assert not fac[0, :nb * ww].any() and not fac[0, 2 * nb * ww:].any()


def test_factor_needs_whole_blocks():
    bd = torch.as_tensor(band(np.random.default_rng(1), 1, 10, 3, 3))
    with pytest.raises(ValueError, match="multiple of w"):
        block_cr_factor(bd, 3)
    # w = 6-8 is the wide instantiation's (the streaming patch solves);
    # above it the factor refuses
    with pytest.raises(ValueError, match="1 <= w <= 8"):
        block_cr_factor(torch.as_tensor(band(np.random.default_rng(1), 1, 18,
                                             9, 9)), 9)


@pytest.mark.parametrize("w", [4, 5])
@pytest.mark.parametrize("pivot", [False, True])
def test_factor_apply_wide_blocks(w, pivot):
    """The widths q = 3 adds (A and SAPhi at w = 4, the generalized-KP B
    at w = 5): factor + apply == ``block_cr_plain`` bit for bit, and the
    JAX package's solve to 1e-12 (n = 37: padded to whole blocks)."""
    rng = np.random.default_rng(330 + w + 2 * pivot)
    bd = torch.as_tensor(band(rng, 2, 37, w, w))
    rhs = torch.as_tensor(rng.standard_normal((2, 37, 3)))
    bp = pad_band(bd, w)
    rp = torch.cat([rhs, rhs.new_zeros((2, bp.shape[1] - 37, 3))], dim=1)
    fac = block_cr_factor(bp, w, pivot=pivot)
    x = block_cr_apply(fac, rp, w, pivot=pivot)[:, :37]
    xr, _ = block_cr_plain(bd, rhs, w, pivot=pivot)
    assert torch.equal(x, xr)
    xj = block_cr_solve_pallas(jnp.asarray(bd.numpy()),
                               jnp.asarray(rhs.numpy()), w, pivot=pivot,
                               interpret=True)
    assert _rel(x, xj) < 1e-12


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("pivot", [False, True])
def test_factor_logdet_matches_block_cr(w, pivot):
    """The factor's log-determinant (what ``block_cr_logdet`` and
    ``ops.banded_logdet`` now return) is ``block_cr_plain``'s bit for bit,
    and the JAX package's ``block_cr_logdet_pallas`` to 1e-12."""
    rng = np.random.default_rng(340 + w + 7 * pivot)
    bd = torch.as_tensor(band(rng, 3, 37, w, w))
    fac, ld = block_cr_factor(pad_band(bd, w), w, pivot=pivot, logdet=True)
    assert torch.equal(fac, block_cr_factor(pad_band(bd, w), w, pivot=pivot))
    _, ldr = block_cr_plain(bd, torch.zeros((3, 37, 1), dtype=bd.dtype), w,
                            pivot=pivot)
    assert torch.equal(ld, ldr)
    assert torch.equal(ops.banded_logdet(bd, w, w, pivot=pivot), ldr)
    ldj = block_cr_logdet_pallas(jnp.asarray(bd.numpy()), w, pivot=pivot,
                                 interpret=True)
    assert _rel(ld, ldj) < 1e-12


@pytest.mark.parametrize("q", [0, 1, 2])
@pytest.mark.parametrize("pivot", [False, True])
def test_dimops_solves_from_held_factor_bitwise(q, pivot):
    """A ``DimOps`` holds SAPhi's block-CR factor (w = q + 1) and, at
    q >= 1, Phi's, made for its pivot mode; ``block_solve`` and
    ``khat_inv_mv`` from them equal the solves from the bands bit for bit.
    A solve in the other pivot mode solves from the band; with
    ``alg="lu"`` no factor is made."""
    rng = np.random.default_rng(350 + q + 5 * pivot)
    base = dim_ops(solve_operands(rng, 41, 3, q), "cpu")
    fields = (base.A, base.Phi, base.SAPhi, base.sort_idx, base.rank_idx,
              base.sigma2)
    d = DimOps(*fields, pivot=pivot)
    assert d.saphi_factor is not None and d.saphi_factor.pivot == pivot
    assert (d.phi_factor is not None) == (q >= 1)
    r = torch.as_tensor(rng.standard_normal((3, 41, 5)))
    for pv in (pivot, not pivot):
        bsolve = d.from_sorted(d.sigma2 * solve(
            d.SAPhi, matvec(d.Phi, d.to_sorted(r)), pivot=pv))
        kinv = d.from_sorted(solve(d.Phi, matvec(d.A, d.to_sorted(r)),
                                   pivot=pv))
        assert torch.equal(d.block_solve(r, pivot=pv), bsolve)
        assert torch.equal(d.khat_inv_mv(r, pivot=pv), kinv)
    lu = DimOps(*fields, alg="lu")
    assert lu.saphi_factor is None and lu.phi_factor is None


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (1, 2)])
def test_banded_lu_logdet_only_matches_pallas(lo, hi):
    """``solve=False`` takes no right-hand side and returns x as None, as
    the reference's flag skips the back substitution; ``logdet=False``
    returns the log-determinant as None."""
    rng = np.random.default_rng(310 + 3 * lo + hi)
    bd = band(rng, 3, 37, lo, hi)
    rhs = rng.standard_normal((3, 37, 4))
    x, ld = banded_lu(torch.as_tensor(bd), None, lo, hi, solve=False)
    _, ldj = banded_lu_pallas(jnp.asarray(bd), jnp.asarray(rhs), lo, hi,
                              solve=False, interpret=True)
    assert x is None and _rel(ld, ldj) < 1e-12
    xs, none = banded_lu(torch.as_tensor(bd), torch.as_tensor(rhs), lo, hi,
                         logdet=False)
    xj, _ = banded_lu_pallas(jnp.asarray(bd), jnp.asarray(rhs), lo, hi,
                             interpret=True)
    assert none is None and _rel(xs, xj) < 1e-12
    with pytest.raises(ValueError, match="nothing to compute"):
        banded_lu(torch.as_tensor(bd), None, lo, hi, solve=False,
                  logdet=False)


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 2)])
def test_ops_banded_logdet_lu_route_matches_jax(lo, hi):
    """``ops.banded_logdet`` on the LU route (a diagonal band, and an
    asymmetric one) against the JAX package's, batched over two leading
    dims."""
    rng = np.random.default_rng(320 + lo + hi)
    bd = band(rng, 6, 37, lo, hi).reshape(2, 3, 37, lo + hi + 1)
    ld = ops.banded_logdet(torch.as_tensor(bd), lo, hi)
    ldj = jops.banded_logdet(jnp.asarray(bd), lo, hi, backend="pallas")
    assert ld.shape == (2, 3) and _rel(ld, ldj) < 1e-12
    rhs = rng.standard_normal((2, 3, 37, 2))
    x = ops.banded_solve(torch.as_tensor(bd), torch.as_tensor(rhs), lo, hi)
    xj = jops.banded_solve(jnp.asarray(bd), jnp.asarray(rhs), lo, hi,
                           backend="pallas")
    assert _rel(x, xj) < 1e-12
