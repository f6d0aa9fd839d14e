"""The port's serving path against the JAX package at q = 1 (Matérn-3/2),
on the CPU; see ``test_torch_gp.py`` for what is checked and the bars."""
from __future__ import annotations

import pytest
import torch

from torch_port_jax_ref import (check_fit, check_queries,  # noqa: F401
                                check_queries_on_jax_factors, fit_cache,
                                fresh_jax_caches, shared_ref)

torch.set_num_threads(2)

CASES = [(37, 1), (128, 1)]


@pytest.fixture(scope="module")
def fitted(shared_ref):
    return fit_cache(shared_ref)


@pytest.mark.parametrize("case", CASES)
def test_fit_matches_jax(fitted, case):
    check_fit(fitted, case)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", [8, 40])
def test_queries_match_jax(fitted, case, m):
    check_queries(fitted, case, m)


@pytest.mark.parametrize("case", CASES)
def test_queries_on_jax_factors(fitted, case):
    check_queries_on_jax_factors(fitted, case)
