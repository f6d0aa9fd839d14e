"""Dense oracles for the kernels (the allclose targets of the tests).

Independent of the kernels and their plain versions: banded operands are
densified and handed to ``torch.linalg``.
"""
from __future__ import annotations

import torch

from ..core import matern as mk
from ..core.banded import Banded, from_dense, to_dense

__all__ = ["banded_matvec_ref", "banded_solve_ref", "banded_logdet_ref",
           "band_matmul_ref", "rgf_band_inverse_ref", "kp_gram_ref"]


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


def kp_gram_ref(q: int, omega, xs, a_band):
    """Phi band (n, 2q+1) via explicit windowed gathers (the math of
    ``core.kernel_packets.gram_band_rows``)."""
    n = xs.shape[0]
    lo = q + 1
    i = torch.arange(n, device=xs.device)[:, None]
    t = torch.arange(-lo, lo + 1, device=xs.device)[None, :]
    vv = ((i + t) >= 0) & ((i + t) < n)
    xw = xs[(i + t).clamp(0, n - 1)]
    m = torch.arange(-q, q + 1, device=xs.device)[None, :]
    vm = ((i + m) >= 0) & ((i + m) < n)
    xm = xs[(i + m).clamp(0, n - 1)]
    kv = mk.matern(q, omega, xm[:, :, None], xw[:, None, :]) * vv[:, None, :]
    return torch.einsum("nmt,nt->nm", kv, a_band) * vm
