"""Serve-path numerical fault tolerance, cheapest layer first.

* :mod:`.verdict`: classification of every solve (OK, STALLED, DIVERGED,
  NONFINITE) and the ``HealthState`` a health-on GP carries;
* :mod:`.ladder`: the host-level degradation ladder that repairs a failed
  posterior through progressively safer configurations, one
  ``HealthEvent`` per escalation;
* :mod:`.inject`: the deterministic fault injectors the tests use.

``verdict`` is imported eagerly (the solvers depend on it); the ladder and
the injectors import the GP core, so they load lazily, which keeps this
package free of import cycles.
"""
from .verdict import (DIVERGED, NONFINITE, OK, STALLED, VERDICT_NAMES,
                      HealthState, classify_solve, verdict_name)

__all__ = [
    "OK", "STALLED", "DIVERGED", "NONFINITE", "VERDICT_NAMES",
    "HealthState", "classify_solve", "verdict_name",
    "HealthEvent", "RUNGS", "repair", "probe_gp",
    "nan_active_row", "near_singular_band", "corrupt_hierarchy",
    "iteration_cap", "dense_cluster_stream",
]

_LAZY = {
    "HealthEvent": "ladder", "RUNGS": "ladder", "repair": "ladder",
    "probe_gp": "ladder",
    "nan_active_row": "inject", "near_singular_band": "inject",
    "corrupt_hierarchy": "inject", "iteration_cap": "inject",
    "dense_cluster_stream": "inject",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
