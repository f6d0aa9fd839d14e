"""Half-integer Matérn kernels and their omega-derivative (paper Eq. (7)/(37)).

With ``q = nu - 1/2``:

    k(x, x' | omega) = exp(-omega*r) * (q!/(2q)!) * sum_{l=0}^{q}
                       [(q+l)! / (l!(q-l)!)] * (2*omega*r)^{q-l},     r = |x - x'|

``q`` is a static Python int in {0, 1, 2, 3}.
"""
from __future__ import annotations

import math

import torch

__all__ = ["SUPPORTED_Q", "nu_from_q", "q_from_nu", "matern",
           "matern_domega", "matern_dx", "gram", "cross"]

SUPPORTED_Q = (0, 1, 2, 3)


def nu_from_q(q: int) -> float:
    return q + 0.5


def q_from_nu(nu: float) -> int:
    q = int(round(nu - 0.5))
    if abs(nu - (q + 0.5)) > 1e-12 or q not in SUPPORTED_Q:
        raise ValueError(f"nu={nu} is not a supported half-integer (q in "
                         f"{SUPPORTED_Q})")
    return q


def _poly_coeffs(q: int) -> list[float]:
    """Coefficients c_m of (2*omega*r)^m in the bracket, m = 0..q (Eq. 37)."""
    pref = math.factorial(q) / math.factorial(2 * q)
    out = [0.0] * (q + 1)
    for l in range(q + 1):
        out[q - l] = pref * math.factorial(q + l) / (
            math.factorial(l) * math.factorial(q - l))
    return out


def matern(q: int, omega, x, y):
    """k(x, y | omega) elementwise; broadcasts x, y, omega."""
    u = omega * torch.abs(x - y)
    coeffs = _poly_coeffs(q)
    acc = torch.zeros_like(u) + coeffs[q]
    for m in range(q - 1, -1, -1):
        acc = acc * (2.0 * u) + coeffs[m]
    return torch.exp(-u) * acc


def matern_domega(q: int, omega, x, y):
    """d k(x, y | omega) / d omega = r exp(-u) (P'(u) - P(u)), u = omega r."""
    r = torch.abs(x - y)
    u = omega * r
    coeffs = _poly_coeffs(q)
    p = torch.zeros_like(u) + coeffs[q]
    for m in range(q - 1, -1, -1):
        p = p * (2.0 * u) + coeffs[m]
    dp = torch.zeros_like(u)
    for m in range(q, 0, -1):
        dp = dp * u + coeffs[m] * m * (2.0 ** m)
    return r * torch.exp(-u) * (dp - p)


def matern_dx(q: int, omega, x, y):
    """d k(x, y | omega) / dx (gradient in the *first* argument).

    k = exp(-u) P(u), u = omega |x - y|; dk/dx = sign(x - y) omega exp(-u)
    (P'(u) - P(u)), zero at x == y (sign(0) = 0; for q = 0 the one-sided
    value times the sign).
    """
    d = x - y
    u = omega * torch.abs(d)
    coeffs = _poly_coeffs(q)
    p = torch.zeros_like(u) + coeffs[q]
    for m in range(q - 1, -1, -1):
        p = p * (2.0 * u) + coeffs[m]
    dp = torch.zeros_like(u)
    for m in range(q, 0, -1):
        dp = dp * u + coeffs[m] * m * (2.0 ** m)
    return torch.sign(d) * omega * torch.exp(-u) * (dp - p)


def gram(q: int, omega, xs):
    """Full covariance matrix k(xs, xs), O(n^2): the dense oracle's."""
    return matern(q, omega, xs[:, None], xs[None, :])


def cross(q: int, omega, xs, xq):
    """Cross covariance k(xs, xq), shape (len(xs), len(xq))."""
    return matern(q, omega, xs[:, None], xq[None, :])
