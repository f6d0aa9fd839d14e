"""The port's serving path (fit -> posterior_mean -> posterior_var) against
the JAX package on the pallas backend (interpret mode), on the CPU, at q = 0
(Matérn-1/2, the default), including a tied-coordinates case. The q = 1
cases are in ``test_torch_gp_q1.py``, so the two run on separate workers.

One JAX fit and one 40-query mean/variance per (n, q) serve every case: the
queries are independent of each other (each variance column is its own PCG
solve at a fixed iteration count), so the port's 8-query batch (one column
chunk) is held against the first 8 of the 40, and its 40-query batch (two
chunks of ``_VAR_CHUNK = 32``) against all of them.

Tolerances: the directly computed factors 1e-10 relative, the solve-based
caches 1e-8, the queries 1e-7 (the repository's own jax-vs-pallas bar).
"""
from __future__ import annotations

import pytest
import torch

from torch_port_jax_ref import (check_fit, check_queries,  # noqa: F401
                                check_queries_on_jax_factors, fit_cache,
                                fresh_jax_caches, shared_ref)

torch.set_num_threads(2)

CASES = [(37, 0), (128, 0), (37, 0, True)]


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
