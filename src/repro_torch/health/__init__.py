"""Solve-health verdicts."""
from .verdict import (OK, STALLED, DIVERGED, NONFINITE, HealthState,
                      classify_solve, verdict_name)

__all__ = ["OK", "STALLED", "DIVERGED", "NONFINITE", "HealthState",
           "classify_solve", "verdict_name"]
