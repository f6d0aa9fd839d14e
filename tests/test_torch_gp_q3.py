"""The port's serving path against the JAX package at q = 3 (Matérn-7/2),
on the CPU; see ``test_torch_gp.py`` for what is checked and the bars.

At q = 3 the KP windows span 2q + 3 = 9 points, and the null vectors that
``kernel_packets`` takes from them agree between jaxlib's and torch's
LAPACK only where omega times the window's width is not small (ROADMAP
Queue 3): on the n = 37 jittered grid with omega = 4 every band agrees to
<= 1e-10, at n = 64 the generalized-KP B only to ~2e-9. The JAX side runs
its plain reference backend ("jax"): the Pallas kernels at these widths
are held by ``test_torch_cr_factor.py`` (block CR at w = 4, 5). The port's
fit resolves ``fused="auto"`` to "off" (the bands are wider than the fused
kernels take), as the reference's own "auto" runs unfused where its fused
kernels cannot take the shape.
"""
from __future__ import annotations

import pytest
import torch

from torch_port_jax_ref import (check_fit, check_queries,  # noqa: F401
                                check_queries_on_jax_factors, fit_cache,
                                fresh_jax_caches)

torch.set_num_threads(2)

CASES = [(37, 3, False, "pcg", "jax")]


@pytest.fixture(scope="module")
def fitted():
    return fit_cache()


@pytest.mark.parametrize("case", CASES)
def test_fit_matches_jax(fitted, case):
    check_fit(fitted, case)
    assert fitted(*case)[1].config.fused == "off"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", [8, 40])
def test_queries_match_jax(fitted, case, m):
    check_queries(fitted, case, m)


@pytest.mark.parametrize("case", CASES)
def test_queries_on_jax_factors(fitted, case):
    check_queries_on_jax_factors(fitted, case)
