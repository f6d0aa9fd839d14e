"""Dense oracles for the kernels (the allclose targets of the tests).

Independent of the kernels and their plain versions: banded operands are
densified and handed to ``torch.linalg``.
"""
from __future__ import annotations

import torch

from ..core.banded import Banded, from_dense, to_dense

__all__ = ["banded_matvec_ref", "banded_solve_ref", "banded_logdet_ref",
           "band_matmul_ref", "rgf_band_inverse_ref"]


def banded_matvec_ref(band, x, lo: int, hi: int):
    """band (n, w); x (n,) or (n, B). Dense product oracle."""
    return to_dense(Banded(band, lo, hi)) @ x


def banded_solve_ref(band, rhs, lo: int, hi: int):
    """band (n, w); rhs (n,) or (n, B). Dense solve oracle."""
    return torch.linalg.solve(to_dense(Banded(band, lo, hi)), rhs)


def banded_logdet_ref(band, lo: int, hi: int):
    """log |det M| via dense slogdet."""
    return torch.linalg.slogdet(to_dense(Banded(band, lo, hi)))[1]


def band_matmul_ref(a_band, b_band, a_lo: int, a_hi: int, b_lo: int,
                    b_hi: int):
    """Band data of A @ B via the dense product."""
    dense = to_dense(Banded(a_band, a_lo, a_hi)) @ to_dense(
        Banded(b_band, b_lo, b_hi))
    return from_dense(dense, a_lo + b_lo, a_hi + b_hi).data


def rgf_band_inverse_ref(band, lo: int, hi: int, hw: int):
    """Band (half-bw ``hw``) of the dense inverse of a banded matrix."""
    G = torch.linalg.inv(to_dense(Banded(band, lo, hi)))
    return from_dense(G, hw, hw).data
