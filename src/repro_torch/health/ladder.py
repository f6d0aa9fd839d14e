"""Host-level degradation ladder: deterministic repair of a failed solve.

Counterpart of ``repro.health.ladder``. The verdicts
(:mod:`repro_torch.health.verdict`) only classify; this module acts. When a
fitted :class:`~repro_torch.core.additive_gp.AdditiveGP` shows a bad
verdict (its carried ``HealthState``, or a nonfinite serve-path tensor),
:func:`repair` recomputes the posterior caches through a fixed sequence of
progressively safer and costlier configurations, stopping at the first
rung whose result probes healthy:

=================  ========================================================
rung               what it changes
=================  ========================================================
``warm_to_cold``   re-solve the caches cold at the full ``solver_iters``
``precond_off``    the same with ``precond="none"`` (kmg GPs); the stored
                   hierarchy is rebuilt from the factors
                   (``build_gp_hier``), so a corrupted one does not
                   outlive the repair
``unfused``        cold re-solve with ``fused="off"`` (GPs whose resolved
                   ``fused`` is not "off", on either device)
``gband_resync``   exact recompute of the variance band
                   (``streaming.updates.resync_gband``)
``backend_jax``    (the reference's name, kept so that an event trail reads
                   the same in both packages) the reference's re-solve on
                   its second backend; the port has one implementation on
                   each device, so it never applies here, as the reference
                   skips it on a ``backend="jax"`` fit
``refit_clean``    one host read of the active X and Y, nonfinite rows
                   dropped, a fresh fit at the same capacity on the GP's
                   device (every factor rebuilt)
=================  ========================================================

Rungs that do not apply to the GP are skipped, so the walk is
deterministic given the config and the verdicts. The stored ``GPConfig`` is
never changed: a rung solves with a safer configuration, and the returned
GP keeps the original. Each rung that runs records a :class:`HealthEvent`.
The healthy path never enters this module. Every rung re-solves on the GP's
own device: nothing is moved to the CPU because a solve failed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..masking import mask_rows
from . import verdict as hv

__all__ = ["HealthEvent", "RUNGS", "probe_gp", "repair"]

# escalation order: cheapest first, strongest last
RUNGS = ("warm_to_cold", "precond_off", "unfused", "gband_resync",
         "backend_jax", "refit_clean")


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One ladder escalation: which rung ran against which verdict.

    ``op`` names the operation repaired (the engines': "mutation", "query",
    "tenant<t>", "sentinel", ...); ``before`` and ``after`` are verdict
    codes entering and leaving the rung."""

    op: str
    rung: str
    before: int
    after: int
    detail: str = ""

    @property
    def fixed(self) -> bool:
        return self.after == hv.OK

    def __str__(self) -> str:
        tail = f" ({self.detail})" if self.detail else ""
        return (f"[{self.op}] {hv.verdict_name(self.before)} -> "
                f"{self.rung} -> {hv.verdict_name(self.after)}{tail}")


def probe_gp(gp) -> int:
    """The worst of the verdict the GP's last classified solve left on its
    ``HealthState`` and a nonfinite scan of the active rows of the
    serve-path tensors (``Y``, ``u_sy``, ``bY``, ``Gband``): data poisoning
    shows before any solve has run over it. One host read."""
    na = gp.n_active
    fin = torch.stack([
        torch.isfinite(mask_rows(gp.Y, na, axis=0)).all(),
        torch.isfinite(mask_rows(gp.u_sy, na, axis=1)).all(),
        torch.isfinite(mask_rows(gp.bY, na, axis=1)).all(),
        torch.isfinite(mask_rows(gp.Gband.data, na, axis=1)).all()]).all()
    code = torch.where(fin, hv.OK, hv.NONFINITE).to(torch.int32)
    if gp.health is not None:
        code = torch.maximum(code, gp.health.verdict.to(torch.int32))
    return int(code)


def _recache(gp, precond_off: bool = False, unfused: bool = False):
    """Cold full-budget re-solve of the posterior-mean caches under an
    optionally safer configuration; the stored config is untouched."""
    from ..core.additive_gp import build_gp_hier, mean_caches

    cfg = gp.config
    if precond_off:
        cfg = dataclasses.replace(cfg, precond="none")
    if unfused:
        cfg = dataclasses.replace(cfg, fused="off")
    hier = gp.hier if cfg.precond == "kmg" else None
    store_hier = gp.hier
    if precond_off and gp.config.precond == "kmg":
        store_hier = build_gp_hier(gp.config, gp.omega, gp.sigma, gp.X,
                                   gp.xs, gp.ops)
    u_sy, bY, info = mean_caches(cfg, gp.ops, gp.Y, hier=hier,
                                 return_info=True)
    return dataclasses.replace(gp, u_sy=u_sy, bY=bY, hier=store_hier,
                               health=_health(gp).with_solve(info))


def _health(gp):
    return (gp.health if gp.health is not None
            else hv.HealthState.fresh(gp.Y.dtype, gp.device, gp.lead))


def _refit_clean(gp):
    """Last rung: refit from the raw data at the same capacity on the GP's
    device with the nonfinite observations dropped, after one host read of
    X, Y and the active count. Returns ``(gp, n_dropped)``."""
    from ..core.additive_gp import fit

    n, D = gp.n, gp.D
    na = torch.as_tensor(gp.active(), dtype=gp.X.dtype, device=gp.device)
    host = torch.cat([gp.X.reshape(-1), gp.Y, na.reshape(1)]).cpu().numpy()
    n_act = int(host[-1])
    X = host[:n * D].reshape(n, D)[:n_act]
    Y = host[n * D:n * D + n][:n_act]
    good = np.isfinite(Y) & np.all(np.isfinite(X), axis=1)
    if not good.any():
        raise RuntimeError(
            "refit_clean: no finite observations survive; nothing to refit")
    # the baked config resolves to itself, so the refit's modes are the GP's
    out = fit(gp.config, X[good], Y[good], gp.omega, gp.sigma,
              device=gp.device, capacity=n)
    return out, int(n_act - good.sum())


def _applies(rung: str, gp) -> bool:
    cfg = gp.config
    if rung == "precond_off":
        return cfg.precond == "kmg"
    if rung == "unfused":
        return cfg.fused != "off"
    if rung == "gband_resync":
        return cfg.gband != "full" and gp.Hband is not None
    if rung == "backend_jax":
        return False  # one implementation per device: no second backend
    return True  # warm_to_cold, refit_clean


def _apply(rung: str, gp):
    """Run one rung; returns ``(gp, detail)``."""
    from ..streaming.updates import resync_gband

    if rung == "warm_to_cold":
        return _recache(gp), "cold full-iteration re-solve"
    if rung == "precond_off":
        return (_recache(gp, precond_off=True),
                "precond=none; hierarchy rebuilt")
    if rung == "unfused":
        return _recache(gp, unfused=True), "fused=off re-solve"
    if rung == "gband_resync":
        return resync_gband(gp), "full-RGF variance-band resync"
    if rung == "refit_clean":
        gp, dropped = _refit_clean(gp)
        return gp, f"clean refit, {dropped} nonfinite row(s) dropped"
    raise ValueError(f"ladder rung {rung!r} does not run in the port")


def repair(gp, *, op: str = "repair"):
    """Walk the ladder until the GP probes healthy.

    Returns ``(gp, events)``: the (possibly) repaired GP and one
    :class:`HealthEvent` per rung that ran. A GP that already probes OK
    comes back unchanged with no events; one still unhealthy after the last
    rung comes back as it is with its trail (the caller decides). The GP
    keeps its baked config; after ``refit_clean`` its active count may
    have shrunk (the engines read ``gp.num_points()`` again)."""
    events: list[HealthEvent] = []
    before = probe_gp(gp)
    if before == hv.OK:
        return gp, events
    for rung in RUNGS:
        if not _applies(rung, gp):
            continue
        gp, detail = _apply(rung, gp)
        after = probe_gp(gp)
        events.append(HealthEvent(op=op, rung=rung, before=before,
                                  after=after, detail=detail))
        if after == hv.OK:
            break
        before = after
    return gp, events
