"""Dense oracles for the kernels (the allclose targets of the tests).

Independent of the kernels and their plain versions: banded operands are
densified and handed to ``torch.linalg``; the variance band at w = 1 also
has an RGF in extended precision (``rgf_longdouble_ref``), the yardstick
that two float64 orders of its elimination are measured against.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import matern as mk
from ..core.banded import Banded, from_dense, to_dense

__all__ = ["banded_matvec_ref", "banded_solve_ref", "banded_logdet_ref",
           "band_matmul_ref", "rgf_band_inverse_ref", "rgf_longdouble_ref",
           "rgf_band_error", "kp_gram_ref"]


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


def rgf_longdouble_ref(Dg, U, L):
    """(Gd, Gu, Gl) of a block-tridiagonal inverse at w = 1 as
    ``np.longdouble`` arrays (G, T): the RGF recurrences of
    ``kernels.rgf.rgf_blocks_plain`` in extended precision (x86's 80-bit
    long double: 11 more bits than float64; quad precision where the
    platform's long double is), vectorised over the G bands."""
    if Dg.shape[-1] != 1:
        raise ValueError("rgf_longdouble_ref takes 1 x 1 blocks")
    if np.finfo(np.longdouble).eps >= np.finfo(np.float64).eps:
        raise RuntimeError("np.longdouble is no wider than float64 here")
    d, u, l = (t[..., 0, 0].detach().cpu().numpy().astype(np.longdouble)
               for t in (Dg, U, L))
    T = d.shape[1]
    F, W = np.empty_like(d), np.empty_like(d)
    F[:, 0] = d[:, 0]
    for j in range(1, T):
        F[:, j] = d[:, j] - l[:, j] * u[:, j - 1] / F[:, j - 1]
    W[:, T - 1] = d[:, T - 1]
    for j in range(T - 2, -1, -1):
        W[:, j] = d[:, j] - u[:, j] * l[:, j + 1] / W[:, j + 1]
    Gd = 1 / (F + W - d)
    Gu, Gl = np.zeros_like(d), np.zeros_like(d)
    Gu[:, :-1] = -u[:, :-1] * Gd[:, 1:] / F[:, :-1]
    Gl[:, :-1] = -l[:, 1:] * Gd[:, :-1] / W[:, 1:]
    return Gd, Gu, Gl


def rgf_band_error(out, ref) -> float:
    """Error of (Gd, Gu, Gl) blocks against ``ref`` (arrays or tensors of
    the same (G, T, ...) shapes): per band the largest difference over Gd,
    Gu and Gl together over that band's largest entry of ``ref``, the
    worst band's value."""
    def stack(ts):
        return np.stack([np.asarray(t.detach().cpu().numpy()
                                    if torch.is_tensor(t) else t,
                                    dtype=np.longdouble).reshape(
                                        t.shape[0], -1) for t in ts], -1)
    o, r = stack(out), stack(ref)
    per = np.abs(o - r).max(axis=(1, 2)) / np.abs(r).max(axis=(1, 2))
    return float(per.max())


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
