"""Kernel Packet Gram band without forming K: CUDA kernel and plain versions.

Counterpart of ``repro.kernels.kp_gram.kp_gram_pallas`` (paper Algorithm 2,
the step "Phi = A K"):

    Phi[i, q+m] = sum_{t=-(q+1)}^{q+1} A[i, q+1+t] * k_q(|x_{i+m} - x_{i+t}|)

for m in [-q, q]. Terms with ``i+t`` outside ``[0, n)`` are dropped and
outputs with ``i+m`` outside it are zero. The CUDA kernel is
``csrc/kp_gram.cu`` (q in {0, 1, 2, 3}): a block evaluates each distinct
(point, distance) kernel value once into shared memory and contracts its
rows from there. The wrapper launches it for CUDA tensors and runs
:func:`kp_gram_plain` for CPU tensors; :func:`kp_gram_table_plain` replays
the kernel's table in plain torch, with the same bits as
:func:`kp_gram_plain` on the CPU.
"""
from __future__ import annotations

import torch

from ..core import matern as mk
from . import _build
from .ops import resolve_backend

__all__ = ["kp_gram", "kp_gram_plain", "kp_gram_table_plain", "MAX_Q"]

MAX_Q = 3  # csrc/kp_gram.cu MAXQ

# the Matern polynomial's coefficients c0..c3 for each q (those above q zero)
_COEFFS = tuple(tuple(mk._poly_coeffs(q) + [0.0] * (MAX_Q - q))
                for q in range(MAX_Q + 1))


def _shift(x, k):
    """x_{i+k} over rows i, zero outside [0, n) (the Pallas kernel's zero
    halo)."""
    n = x.shape[0]
    out = torch.zeros_like(x)
    if k >= 0:
        out[:max(n - k, 0)] = x[k:]
    else:
        out[-k:] = x[:n + k]
    return out


def kp_gram_plain(q: int, omega, xs, a_band):
    """xs (n,) sorted, a_band (n, 2q+3) -> Phi band (n, 2q+1): the Pallas
    kernel's masked sums, in its order (t ascending for each m)."""
    n = xs.shape[0]
    lo = q + 1
    rows = torch.arange(n, device=xs.device)
    zero = torch.zeros((), dtype=a_band.dtype, device=a_band.device)
    out = torch.zeros((n, 2 * q + 1), dtype=a_band.dtype,
                      device=a_band.device)
    for m in range(-q, q + 1):
        xm = _shift(xs, m)
        acc = torch.zeros((n,), dtype=a_band.dtype, device=a_band.device)
        for t in range(-lo, lo + 1):
            kv = mk.matern(q, omega, xm, _shift(xs, t))
            valid = (rows + t >= 0) & (rows + t < n)
            acc = acc + torch.where(valid, a_band[:, lo + t] * kv, zero)
        valid_m = (rows + m >= 0) & (rows + m < n)
        out[:, q + m] = torch.where(valid_m, acc, zero)
    return out


def kp_gram_table_plain(q: int, omega, xs, a_band):
    """:func:`kp_gram_plain` in the CUDA kernel's order: first the table
    K[j, d] = k_q(|x_j - x_{j+d}|) of each point j in [-(q+1), n+q) and
    distance d in [0, 2q+1] over the zero-haloed x, then each row's terms
    read K[i + min(m, t), |m - t|] in kp_gram_plain's order. |x_a - x_b| ==
    |x_b - x_a| exactly, so on the CPU the result equals kp_gram_plain's
    bit for bit; no caller uses it but the tests."""
    n = xs.shape[0]
    lo = q + 1
    nk, nd = n + 2 * q + 1, 2 * q + 2
    # x_j for j = -lo .. n + 3q (zero outside [0, n))
    xp = torch.zeros((nk + nd - 1,), dtype=xs.dtype, device=xs.device)
    xp[lo:lo + n] = xs
    table = torch.stack([mk.matern(q, omega, xp[:nk], xp[d:d + nk])
                         for d in range(nd)], dim=1)
    rows = torch.arange(n, device=xs.device)
    zero = torch.zeros((), dtype=a_band.dtype, device=a_band.device)
    out = torch.zeros((n, 2 * q + 1), dtype=a_band.dtype,
                      device=a_band.device)
    for m in range(-q, q + 1):
        acc = torch.zeros((n,), dtype=a_band.dtype, device=a_band.device)
        for t in range(-lo, lo + 1):
            j0 = lo + min(m, t)
            kv = table[j0:j0 + n, abs(m - t)]
            valid = (rows + t >= 0) & (rows + t < n)
            acc = acc + torch.where(valid, a_band[:, lo + t] * kv, zero)
        valid_m = (rows + m >= 0) & (rows + m < n)
        out[:, q + m] = torch.where(valid_m, acc, zero)
    return out


def kp_gram(q: int, omega, xs, a_band, backend: str | None = None):
    """Phi band (n, 2q+1) of ``A K`` for sorted ``xs`` (n,) and the KP
    coefficients ``a_band`` (n, 2q+3), float64; ``omega`` a float. CUDA
    tensors launch ``csrc/kp_gram.cu`` (q <= 3)."""
    if resolve_backend(backend, xs.device) == "plain":
        return kp_gram_plain(q, omega, xs, a_band)
    if not 0 <= q <= MAX_Q:
        raise ValueError(f"kp_gram kernel takes 0 <= q <= {MAX_Q}")
    n = xs.shape[0]
    dev = xs.device
    _build.expect(xs, "xs", torch.float64, (n,), dev)
    _build.expect(a_band, "a_band", torch.float64, (n, 2 * q + 3), dev)
    phi = torch.empty((n, 2 * q + 1), dtype=torch.float64, device=dev)
    err = _build.load_library().repro_kp_gram_f64(
        xs.data_ptr(), a_band.data_ptr(), phi.data_ptr(), n, q,
        float(omega), *_COEFFS[q], _build.stream_handle(dev))
    _build.check(err, "kp_gram")
    _build.count_launch("kp_gram")
    return phi
