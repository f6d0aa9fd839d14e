"""Deterministic fault injection: the harness behind the health tests.

Counterpart of ``repro.health.inject``. Each injector takes a fitted
:class:`~repro_torch.core.additive_gp.AdditiveGP` (or, for
:func:`dense_cluster_stream`, sizes and a device) and returns a
deterministically broken copy carrying one serve-path fault class:

* :func:`nan_active_row`: a NaN observation, and by default the corruption
  it would leave in the posterior caches (the quarantine path's fault);
* :func:`near_singular_band`: one row of the smoother band ``SAPhi``
  driven near-singular; the ``DimOps`` is rebuilt with
  ``dataclasses.replace``, so its block-CR factor of SAPhi (which every
  solve applies) is made again from the poisoned band, and only the
  ladder's ``refit_clean`` recovers;
* :func:`corrupt_hierarchy`: the kmg hierarchy's finest prolongation
  weights scaled up, so the preconditioned solve stalls (``precond_off``'s
  fault);
* :func:`iteration_cap`: the posterior caches re-solved cold under a tiny
  iteration budget, a genuinely classified STALLED solve
  (``warm_to_cold``'s fault);
* :func:`dense_cluster_stream`: a densely oversampled insert stream that
  breaches the windowed variance band's truncation contract (the drift
  sentinel's fault).

Every injector is pure: it writes only into clones, so the caller's GP
(and any fixture sharing its tensors) stays as it was. Seeded, no global
RNG: every injection is bit-reproducible.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import verdict as hv

__all__ = ["nan_active_row", "near_singular_band", "corrupt_hierarchy",
           "iteration_cap", "dense_cluster_stream"]


def nan_active_row(gp, row: int = 0, *, poison_caches: bool = True):
    """Poison one active observation with NaN.

    ``Y[row]`` becomes NaN. With ``poison_caches`` (default) the state a
    corrupt solve would leave is injected too: the row's column of
    ``u_sy`` and its sorted slot per dimension in ``bY``, so posterior
    means over windows touching the row go NaN at once. With
    ``poison_caches=False`` only the observation is bad, and the next
    classified solve is what detects it."""
    Y = gp.Y.clone()
    Y[row] = float("nan")
    out = dataclasses.replace(gp, Y=Y)
    if not poison_caches:
        return out
    srow = gp.ops.rank_idx[:, row]  # (D,) sorted position per dimension
    u_sy, bY = gp.u_sy.clone(), gp.bY.clone()
    u_sy[:, row] = float("nan")
    bY[torch.arange(gp.D, device=gp.device), srow] = float("nan")
    return dataclasses.replace(out, u_sy=u_sy, bY=bY)


def near_singular_band(gp, *, row: int = 0, dim: int = 0, eps: float = 1e-13):
    """Drive one active row of the smoother band ``SAPhi`` near-singular:
    the row is zeroed but for a diagonal of ``eps * max|row|``, so solves
    through it amplify by ~1/eps and the next backfitting solve lands
    STALLED, DIVERGED or NONFINITE. The fault lives in the assembled ops
    (and the factor rebuilt from them), which every re-solve rung reuses."""
    sa = gp.ops.SAPhi
    scale = torch.clamp(sa.data[dim, row].abs().max(), min=1.0)
    data = sa.data.clone()
    data[dim, row] = 0.0
    data[dim, row, sa.lo] = eps * scale
    ops = dataclasses.replace(gp.ops,
                              SAPhi=dataclasses.replace(sa, data=data))
    return dataclasses.replace(gp, ops=ops)


def corrupt_hierarchy(gp, *, scale: float = 1e6):
    """Scale the kmg hierarchy's finest prolongation weights by ``scale``:
    the preconditioned solve stalls at an O(1) relative residual while the
    system stays solvable with ``precond="none"``."""
    if gp.hier is None:
        raise ValueError("corrupt_hierarchy needs a kmg fit (gp.hier set); "
                         f"got precond={gp.config.precond!r}")
    lvl = gp.hier[0]
    return dataclasses.replace(
        gp, hier=(dataclasses.replace(lvl, W=lvl.W * scale),)
        + tuple(gp.hier[1:]))


def iteration_cap(gp, *, iters: int = 1):
    """Re-solve the posterior-mean caches cold under a forced iteration
    cap. The solve is classified like any other, so the returned GP carries
    a genuinely earned verdict (STALLED for a one-iteration cold solve)."""
    from ..core.additive_gp import mean_caches

    u_sy, bY, info = mean_caches(gp.config, gp.ops, gp.Y, iters=int(iters),
                                 hier=gp.hier, return_info=True)
    health = (gp.health if gp.health is not None
              else hv.HealthState.fresh(gp.Y.dtype, gp.device, gp.lead))
    return dataclasses.replace(gp, u_sy=u_sy, bY=bY,
                               health=health.with_solve(info))


def dense_cluster_stream(m: int, D: int, *, center: float = 0.5,
                         width: float = 1e-7, seed: int = 0, device=None):
    """``(X (m, D), Y (m,))`` float64 tensors on ``device`` (the port's
    device rule: CUDA unless the caller names the CPU): ``m`` points packed
    into an interval of ``width`` per coordinate, drawn by numpy's
    ``default_rng(seed)`` as the reference draws them, so both packages
    get the same points. ``omega * gap`` is ~``width / m``, far below the
    windowed band's truncation contract."""
    from ..core.additive_gp import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = center + width * rng.random((m, D))
    Y = np.sin(2.0 * np.pi * (X - center).sum(axis=1) / max(width, 1e-300))
    return (torch.as_tensor(X, device=device),
            torch.as_tensor(Y, device=device))
