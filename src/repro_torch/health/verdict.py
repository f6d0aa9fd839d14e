"""Solve-health classification and the per-GP ``HealthState``.

Counterpart of ``repro.health.verdict``: a verdict is an integer code
computed from what the solver already carries (residual and RHS norms,
whether the iteration cap was hit) plus one nonfinite probe of the state.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["OK", "STALLED", "DIVERGED", "NONFINITE", "VERDICT_NAMES",
           "STALL_RTOL", "DRIFT_TOL", "RESYNC_EVERY", "HealthState",
           "classify_solve", "verdict_name"]

OK = 0  # converged (or tol-exited) with a finite, small residual
STALLED = 1  # exited at the iteration cap with the residual still large
DIVERGED = 2  # residual larger than the RHS itself: worse than x = 0
NONFINITE = 3  # NaN/Inf in the state or residual

VERDICT_NAMES = ("OK", "STALLED", "DIVERGED", "NONFINITE")

# relative residual separating "converged enough" from STALLED when a solve
# exits at its iteration cap (the reference's value and rationale)
STALL_RTOL = 1e-3

# Gband drift sentinel (the reference's policy): resync the variance band
# exactly once the accumulated truncation estimate of the windowed updates
# (``core.gband_update._drift_estimate``) crosses DRIFT_TOL, or after
# RESYNC_EVERY windowed mutations whatever the estimate
DRIFT_TOL = 1e-10
RESYNC_EVERY = 4096


@dataclasses.dataclass(frozen=True)
class HealthState:
    """Per-GP health scalars (0-d tensors on the GP's device): the latest
    solve's verdict, residual and RHS norms, and the Gband drift sentinel's
    accumulated truncation estimate and mutation count since the last
    exact resync."""

    verdict: torch.Tensor  # int32
    resid: torch.Tensor
    rhs: torch.Tensor
    drift: torch.Tensor
    muts: torch.Tensor  # int32

    @staticmethod
    def fresh(dtype=torch.float64, device=None, lead=()) -> "HealthState":
        """Zeroed state; ``lead`` (T,) for a fleet's per-tenant scalars."""
        z = torch.zeros(lead, dtype=dtype, device=device)
        zi = torch.zeros(lead, dtype=torch.int32, device=device)
        return HealthState(verdict=zi, resid=z, rhs=z, drift=z, muts=zi)

    def with_solve(self, info) -> "HealthState":
        """Fold a classified ``SolveInfo`` into the state."""
        return dataclasses.replace(
            self, verdict=info.verdict.to(torch.int32),
            resid=info.resid.to(self.resid.dtype),
            rhs=info.rhs.to(self.rhs.dtype))

    def with_drift(self, drift_est) -> "HealthState":
        """Accumulate one mutation's truncation estimate."""
        return dataclasses.replace(
            self, drift=self.drift + drift_est.to(self.drift.dtype),
            muts=self.muts + 1)

    def after_resync(self) -> "HealthState":
        """Zero the sentinel accumulators after an exact resync."""
        return dataclasses.replace(self, drift=torch.zeros_like(self.drift),
                                   muts=torch.zeros_like(self.muts))


def classify_solve(x, resid, rhs, at_cap, stall_rtol: float = STALL_RTOL):
    """Classify one solve into an int32 verdict code (tensor scalar), or a
    stack of solves (a fleet's (T,) ``resid``/``rhs``/``at_cap`` over the
    leading axis of ``x``) into one code each.

    Severity order NONFINITE > DIVERGED > STALLED > OK; a zero RHS is OK.
    """
    resid = torch.as_tensor(resid)
    rhs = torch.as_tensor(rhs, dtype=resid.dtype, device=resid.device)
    at_cap = torch.as_tensor(at_cap, device=resid.device)
    finite = torch.isfinite(resid) & torch.isfinite(x).reshape(
        resid.shape + (-1,)).all(-1)
    tiny = torch.finfo(resid.dtype).tiny
    rel = resid / torch.clamp(rhs, min=tiny)
    code = torch.where(
        rel > 1.0, DIVERGED,
        torch.where(at_cap & (rel > stall_rtol), STALLED, OK))
    return torch.where(finite, code, NONFINITE).to(torch.int32)


def verdict_name(code) -> str:
    i = int(code)
    return VERDICT_NAMES[i] if 0 <= i < len(VERDICT_NAMES) else f"?{i}"
