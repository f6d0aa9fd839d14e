"""Stochastic spectral estimators (paper Algorithms 6, 7, 8).

Counterpart of ``repro.core.stochastic``:

* ``power_method``  — largest eigenvalue of a PSD operator (Alg 6), batched
                      restarts;
* ``hutchinson``    — randomized trace of a matrix-free operator (Alg 7);
* ``logdet_taylor`` — log|M| via the truncated Taylor expansion Eq. (20)
                      with Hutchinson probes (Alg 8).

All Q probes ride one trailing axis, so each step is one batched operator
application. Draws come from an explicit ``torch.Generator`` and are made
on the generator's device, then moved to where the operator lives, so a
CPU generator gives the card and the CPU the same probes.
:func:`rademacher_rows` is the one function through which the port draws
Rademacher probes (the Gaussian option of ``hutchinson`` aside); a test
that feeds the JAX package's draws replaces it.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["power_method", "hutchinson", "logdet_taylor", "rademacher_rows"]


_M31 = 0x7FFFFFFF


def _hash31(h: torch.Tensor) -> torch.Tensor:
    """A 31-bit integer mix (xorshift-multiply rounds) on int64 tensors;
    every product stays below 2^62, so it is exact on every device."""
    for k in (0x2C1B3C6D, 0x297A2D39, 0x3B9E3779):
        h = h ^ (h >> 16)
        h = (h * k) & _M31
    return h ^ (h >> 16)


def rademacher_rows(generator: torch.Generator, n: int,
                    shape: tuple[int, ...], dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """Rademacher (+-1) draw of shape ``(n,) + shape`` keyed *per row*.

    One key is drawn from ``generator``; the sign of entry ``(i, c)`` is a
    hash of (key, i, c), computed on the generator's device. Row ``i``
    depends only on the key and ``i``, not on ``n``, so the first ``n`` rows
    of a capacity-sized draw equal an unpadded draw of ``n`` rows: the
    stochastic estimators of a capacity-padded GP see the same probes on
    the active prefix as the unpadded GP (the reference's row-keyed draw).
    """
    dev = generator.device
    key = torch.randint(0, _M31, (1,), generator=generator, device=dev)
    m = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    hr = _hash31((i * 0x5BD1E995 + key) & _M31)
    h = _hash31(hr ^ _hash31(((c + 1) * 0x27D4EB2F) & _M31))
    bits = (h >> 30) & 1
    return (2 * bits - 1).reshape((n,) + tuple(shape)).to(dtype=dtype,
                                                          device=device)


def _sum_lead(x: torch.Tensor, nd: int) -> torch.Tensor:
    return x.sum(dim=tuple(range(nd)))


def power_method(mv: Callable[[torch.Tensor], torch.Tensor],
                 shape: tuple[int, ...], generator: torch.Generator | None,
                 iters: int = 20, restarts: int = 4, dtype=torch.float64,
                 v0: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """Largest eigenvalue of the PSD operator ``mv`` on vectors of ``shape``.

    Runs ``restarts`` probes as one batch (trailing axis) with per-step
    normalization; returns the largest Rayleigh quotient (Alg 6). ``v0``
    overrides the probe draw.
    """
    nd = len(shape)
    v = (rademacher_rows(generator, shape[0], tuple(shape[1:]) + (restarts,),
                         dtype=dtype, device=device) if v0 is None else v0)
    for _ in range(iters):
        w = mv(v)
        norm = torch.sqrt(_sum_lead(w * w, nd))
        v = w / torch.clamp(norm, min=1e-30)
    w = mv(v)
    num = _sum_lead(v * w, nd)
    den = _sum_lead(v * v, nd)
    return torch.max(num / torch.clamp(den, min=1e-30))


def hutchinson(quad: Callable[[torch.Tensor], torch.Tensor],
               shape: tuple[int, ...], generator: torch.Generator,
               probes: int = 16, gaussian: bool = False, dtype=torch.float64,
               device=None) -> torch.Tensor:
    """E[v^T M v] trace estimator (Alg 7).

    ``quad(V)`` returns the per-probe quadratic forms v_q^T M v_q for a probe
    block V of shape ``shape + (Q,)`` -> (Q,).
    """
    if gaussian:
        v = torch.randn(tuple(shape) + (probes,), generator=generator,
                        dtype=dtype, device=generator.device).to(device)
    else:
        v = rademacher_rows(generator, shape[0],
                            tuple(shape[1:]) + (probes,), dtype=dtype,
                            device=device)
    return torch.mean(quad(v))


def logdet_taylor(mv: Callable[[torch.Tensor], torch.Tensor], dim_total,
                  shape: tuple[int, ...], generator: torch.Generator | None,
                  order: int = 25, probes: int = 16, lam_margin: float = 1.05,
                  power_iters: int = 20, dtype=torch.float64,
                  probe_v: torch.Tensor | None = None,
                  power_v0: torch.Tensor | None = None,
                  device=None) -> torch.Tensor:
    """log|M| for the SPD operator ``mv`` (Alg 8).

    log|M/lam| = -sum_s (1/s) tr((I - M/lam)^s), truncated at ``order``; the
    trace of every power is estimated with the same Hutchinson probe block
    (one operator application per Taylor term). ``probe_v`` / ``power_v0``
    override the probe draws; with both given the generator is not used.
    """
    nd = len(shape)
    lam = power_method(mv, shape, generator, iters=power_iters, dtype=dtype,
                       v0=power_v0, device=device) * lam_margin
    v0 = (rademacher_rows(generator, shape[0], tuple(shape[1:]) + (probes,),
                          dtype=dtype, device=device)
          if probe_v is None else probe_v)
    w = v0
    acc = torch.zeros((v0.shape[-1],), dtype=dtype, device=v0.device)
    for s in range(1, order + 1):
        w = w - mv(w) / lam  # w <- (I - M/lam) w
        acc = acc + _sum_lead(v0 * w, nd) / s
    trace_est = torch.mean(acc)
    return dim_total * torch.log(lam) - trace_est
