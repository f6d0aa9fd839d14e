"""Multi-tenant serving: one batched tick per capacity-tier group.

Counterpart of ``repro.streaming.fleet_engine``. ``GPFleetEngine`` serves
``T`` independent capacity-padded posteriors together. Tenants are grouped
by capacity tier into stacked GPs (``core.fleet``), one ``_TierGroup`` per
tier, its lane count padded to a power of two with stale copies of a real
tenant, and the mixed query stream is routed to ``(tenant, slot)`` pairs:

  * **queries**: each tenant owns ``B`` request slots (mean / var / acq /
    ascend, the single engine's kinds). Every tick gathers each group's
    slots into one ``(lanes, B, D)`` block and runs one batched
    acquisition pass plus the ascent update (:func:`_fleet_engine_step`,
    the launches of one tenant's tick), then copies the group's results to
    the host once. A tenant's results equal a standalone
    :class:`~repro_torch.streaming.GPServeEngine` on its GP (bit for bit on
    the CPU).
  * **mutations**: ``insert`` / ``evict`` / ``set_posterior`` are staged per
    tenant and fence only that tenant: its admission pauses, its slots
    drain, then its ops apply while the others keep serving. Each tick runs
    at most one masked ``fleet_evict`` and one masked ``fleet_insert``
    round per group, however many tenants mutate.
  * **sliding windows**: a tenant's ``window``: a staged insert first
    drains drop-oldest evictions (one a tick) until the tenant is below it.
  * **configurations**: the tenants' shared ``GPConfig`` may be any the
    fleet takes (every solver, fused mode and preconditioner).
  * **tier re-homing**: a tenant whose insert would overflow its tier moves
    alone into the doubled tier's group (created on demand, lanes growing
    by powers of two).

Health (GPs fitted with ``health="on"``): after each mutation round one
read of the group's per-lane verdicts and drift counters; lanes whose
drift crosses ``DRIFT_TOL`` get one masked ``fleet_resync``, and a lane
with a non-OK verdict is quarantined: its GP is taken out, repaired by the
degradation ladder (``health.ladder.repair``; then the pre-round lane
snapshot, then the last-good checkpoint) and seated again, while every
other lane keeps its tensors, count and version. A lane whose query result
is nonfinite is quarantined the same way, its slots held and served again
on the next tick. A healthy round costs the one read.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..core.additive_gp import AdditiveGP, with_capacity
from ..core.bayesopt import acquisition_stats, ascent_step
from ..core.fleet import GPFleet, set_tenant_gp, tenant_gp, tree_map
from ..health import verdict as hv
from .gp_engine import Query, _next_tier
from .updates import fleet_evict, fleet_insert, fleet_resync

__all__ = ["GPFleetEngine"]


def _fleet_engine_step(stack: AdditiveGP, X, beta, best_y, lo, hi, step_len,
                       kind: str):
    """One batched tick of a tier group: per-lane ``(value, grad, mean,
    variance)`` at X (lanes, B, D) with ``best_y`` (lanes, B), and the next
    ascent iterates, as the single engine's tick computes them, packed as
    one (lanes, B, 3 + 2 D) tensor for one host copy."""
    val, grad, mu, var = acquisition_stats(stack, X, beta, best_y, kind=kind,
                                           device=stack.device)
    Xn = ascent_step(X, grad, lo, hi, step_len)
    return torch.cat([val[..., None], mu[..., None], var[..., None], grad,
                      Xn], dim=-1)


@dataclasses.dataclass
class _TierGroup:
    """One capacity tier: a stacked GP over ``lanes`` (a power of two).
    ``tenants[l]`` is the tenant in lane l (None: free; a free lane holds a
    stale copy of a real state, so every batched op stays finite, and its
    results are ignored)."""

    capacity: int
    lanes: int
    stack: AdditiveGP
    tenants: list


@dataclasses.dataclass
class _Tenant:
    tid: int
    group: _TierGroup
    lane: int
    count: int
    window: int | None
    best_y: float
    version: int = 0
    staged: list = dataclasses.field(default_factory=list)
    slots: list = dataclasses.field(default_factory=list)
    pending: deque = dataclasses.field(default_factory=deque)
    xs: np.ndarray | None = None
    besty: np.ndarray | None = None


def _as_per_tenant(val, T, name):
    if val is None or np.isscalar(val):
        return [val] * T
    vals = list(val)
    if len(vals) != T:
        raise ValueError(f"{name} must be a scalar or length-{T}; "
                         f"got length {len(vals)}")
    return vals


def _stack(gps):
    return tree_map(lambda *ts: torch.stack(ts), *gps)


class GPFleetEngine:
    """Serve ``T`` tenant posteriors through one batched tick per tier
    group.

    ``gps``: fitted :class:`AdditiveGP` s sharing one ``GPConfig``, D and
    device (the engine serves where they live); ``capacity`` and ``window``
    are scalars (shared) or per-tenant sequences. ``bounds``, ``kind``,
    ``beta``, ``lr`` and ``batch_slots`` are fleet-wide.
    """

    def __init__(self, gps, bounds, batch_slots: int = 8, kind: str = "ucb",
                 beta: float = 2.0, lr: float = 0.05,
                 insert_iters: int | None = None, capacity=None, window=None,
                 checkpointer=None, checkpoint_every: int = 64):
        gps = list(gps)
        if not gps:
            raise ValueError("GPFleetEngine needs at least one tenant GP")
        cfg0, D0 = gps[0].config, gps[0].D
        for g in gps:
            if g.config != cfg0 or g.D != D0:
                raise ValueError("all fleet tenants must share one GPConfig "
                                 "and input dimension")
        T = len(gps)
        caps = _as_per_tenant(capacity, T, "capacity")
        wins = _as_per_tenant(window, T, "window")
        self.device = gps[0].device
        self.bounds = torch.as_tensor(np.asarray(bounds, np.float64),
                                      device=self.device)
        self.B = batch_slots
        self.kind = kind
        self.beta = beta
        self.lr = lr
        self.insert_iters = insert_iters
        self._next_rid = 0
        # health (health="on" tenants): post-round quarantine and ladder
        # repair, the per-lane drift sentinel, a last-good checkpoint
        self._ckpt = checkpointer
        self._ckpt_every = max(1, int(checkpoint_every))
        self._ckpt_step = 0
        self._repairs = 0
        self._resyncs = 0
        self._quarantines = 0
        self._health_events: list = []
        self.tenants: list[_Tenant] = []
        by_tier: dict[int, list[tuple[int, AdditiveGP]]] = {}
        for tid, (gp, cap, win) in enumerate(zip(gps, caps, wins)):
            if win is not None and win < 2:
                raise ValueError(f"window must be >= 2; got {win} "
                                 f"(tenant {tid})")
            n_points = gp.num_points()
            if cap is None:
                cap = _next_tier(min(n_points + 1, win) if win is not None
                                 else n_points + 1)
            cap = max(int(cap), gp.n)
            self.tenants.append(_Tenant(
                tid=tid, group=None, lane=-1, count=n_points, window=win,
                best_y=0.0, slots=[None] * batch_slots,
                xs=np.zeros((batch_slots, D0), np.float64),
                besty=np.zeros(batch_slots, np.float64)))
            by_tier.setdefault(cap, []).append((tid, with_capacity(gp, cap)))
        self.groups: dict[int, _TierGroup] = {}
        for cap, members in sorted(by_tier.items()):
            lanes = 1 << (len(members) - 1).bit_length()
            padded = [g for _, g in members]
            padded += [padded[-1]] * (lanes - len(members))  # stale filler
            grp = _TierGroup(capacity=cap, lanes=lanes, stack=_stack(padded),
                             tenants=[tid for tid, _ in members]
                             + [None] * (lanes - len(members)))
            self.groups[cap] = grp
            for lane, (tid, _) in enumerate(members):
                self.tenants[tid].group = grp
                self.tenants[tid].lane = lane
        for t in self.tenants:
            t.best_y = self._fresh_best_y(t)

    # -- introspection -------------------------------------------------------

    @property
    def num_tenants(self) -> int:
        return len(self.tenants)

    def counts(self) -> np.ndarray:
        """Per-tenant active observation counts (host state, no read)."""
        return np.array([t.count for t in self.tenants])

    def versions(self) -> np.ndarray:
        """Per-tenant posterior version counters."""
        return np.array([t.version for t in self.tenants])

    def capacities(self) -> np.ndarray:
        """Per-tenant capacity tier (its group's capacity)."""
        return np.array([t.group.capacity for t in self.tenants])

    def tenant_gp(self, tenant: int) -> AdditiveGP:
        """One tenant's standalone capacity-padded GP."""
        t = self.tenants[tenant]
        return tenant_gp(t.group.stack, t.lane)

    def _fresh_best_y(self, t: _Tenant) -> float:
        return float(t.group.stack.Y[t.lane, :t.count].max())

    # -- health --------------------------------------------------------------

    def health_stats(self) -> dict:
        """Counters and the :class:`~repro_torch.health.HealthEvent` trail
        of every quarantine repair and sentinel resync so far."""
        return {"repairs": self._repairs, "resyncs": self._resyncs,
                "quarantines": self._quarantines,
                "events": list(self._health_events)}

    def _group_health(self, grp: _TierGroup, prev: AdditiveGP,
                      lanes: list) -> None:
        """After a mutation round: one read of the group's per-lane verdicts
        and drift counters, one masked resync of the lanes whose drift
        crossed the sentinel's threshold, and a quarantine repair of each
        non-OK lane (``prev``: the stack before the round)."""
        h = grp.stack.health
        if h is None:
            return
        verdicts, drifts, muts = torch.stack(
            [h.verdict.to(h.drift.dtype), h.drift,
             h.muts.to(h.drift.dtype)]).cpu().numpy()
        resync = [l for l in lanes if drifts[l] > hv.DRIFT_TOL
                  or muts[l] >= hv.RESYNC_EVERY]
        if resync:
            from ..health.ladder import HealthEvent

            do = np.zeros(grp.lanes, bool)
            do[resync] = True
            grp.stack = fleet_resync(GPFleet(gp=grp.stack), do).gp
            self._resyncs += len(resync)
            for l in resync:
                self._health_events.append(HealthEvent(
                    op=f"tenant{grp.tenants[l]}:sentinel",
                    rung="gband_resync", before=int(verdicts[l]),
                    after=int(verdicts[l]),
                    detail=f"drift={float(drifts[l]):.3e} after "
                           f"{int(muts[l])} windowed mutation(s)"))
        bad = [l for l in lanes if int(verdicts[l]) != hv.OK]
        for l in bad:
            self._quarantine_repair(grp, l, prev)
        if not bad and self._ckpt is not None:
            self._ckpt_step += 1
            if self._ckpt_step % self._ckpt_every == 0:
                self._ckpt.save(self._ckpt_step, grp.stack)

    def _quarantine_repair(self, grp: _TierGroup, lane: int,
                           prev: AdditiveGP | None = None) -> bool:
        """Quarantine one bad lane: take its GP out, ladder-repair it and
        seat it again; when the ladder is exhausted, the pre-round lane
        snapshot (``prev``), then the last-good checkpoint. Returns whether
        the lane's posterior changed (False: the fault was not in the
        posterior, e.g. a NaN query point)."""
        from ..health.ladder import HealthEvent, probe_gp, repair

        tid = grp.tenants[lane]
        t = self.tenants[tid]
        gp_fix, events = repair(tenant_gp(grp.stack, lane), op=f"tenant{tid}")
        if not events:
            return False
        self._quarantines += 1
        if probe_gp(gp_fix) != hv.OK:
            if prev is not None:
                gp_fix = tenant_gp(prev, lane)
                events.append(HealthEvent(
                    op=f"tenant{tid}", rung="snapshot_restore",
                    before=events[-1].after, after=probe_gp(gp_fix),
                    detail="pre-round lane snapshot"))
            if (probe_gp(gp_fix) != hv.OK and self._ckpt is not None
                    and self._ckpt.latest_step() is not None):
                stack, step = self._ckpt.restore(grp.stack)
                if stack is not None:
                    gp_fix = tenant_gp(stack, lane)
                    events.append(HealthEvent(
                        op=f"tenant{tid}", rung="checkpoint_restore",
                        before=events[-1].after, after=probe_gp(gp_fix),
                        detail=f"last-good checkpoint step {step}"))
        grp.stack = set_tenant_gp(grp.stack, gp_fix, lane)
        self._health_events += events
        self._repairs += 1
        t.count = gp_fix.num_points()
        t.version += 1
        t.best_y = self._fresh_best_y(t)
        return True

    # -- request lifecycle ---------------------------------------------------

    def submit(self, tenant: int, x, kind: str = "acq",
               steps: int = 0) -> Query:
        """Queue a query against one tenant; returns its handle."""
        if kind not in ("mean", "var", "acq", "ascend"):
            raise ValueError(f"unknown query kind {kind!r}")
        q = Query(rid=self._next_rid, x=np.asarray(x, np.float64), kind=kind,
                  steps=steps if kind == "ascend" else 0)
        self._next_rid += 1
        self.tenants[tenant].pending.append(q)
        return q

    def step(self) -> list[Query]:
        """One fleet tick; returns every query retired this tick: ready
        mutations first (batched per group), admission where not fenced,
        then one batched step per group with occupied slots."""
        self._apply_ready_mutations()
        for t in self.tenants:
            if t.staged:  # this tenant's fence: only its admission pauses
                continue
            for i in range(self.B):
                if t.slots[i] is None and t.pending:
                    q = t.pending.popleft()
                    q.version = t.version
                    t.slots[i] = q
                    t.xs[i] = q.x
                    t.besty[i] = t.best_y
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        D = self.bounds.shape[0]
        finished: list[Query] = []
        for grp in self.groups.values():
            serving = [l for l, tid in enumerate(grp.tenants)
                       if tid is not None
                       and any(s is not None for s in self.tenants[tid].slots)]
            if not serving:
                continue
            X = np.zeros((grp.lanes, self.B, D), np.float64)
            BY = np.zeros((grp.lanes, self.B), np.float64)
            for l in serving:
                t = self.tenants[grp.tenants[l]]
                X[l] = t.xs
                BY[l] = t.besty
            out = _fleet_engine_step(
                grp.stack, torch.as_tensor(X, device=self.device), self.beta,
                torch.as_tensor(BY, device=self.device), lo, hi,
                self.lr * (hi - lo), self.kind).cpu().numpy()
            val, mu, var = out[..., 0], out[..., 1], out[..., 2]
            grad, Xn = out[..., 3:3 + D], out[..., 3 + D:]
            # query-path detection (health-on fleets): a lane with a
            # nonfinite result is quarantined (its slots held, its GP
            # repaired and seated again, its queries served next tick)
            # while every other tenant retires as usual; with health off,
            # NaNs retire as they are
            held: set[int] = set()
            if grp.stack.health is not None:
                for l in serving:
                    t = self.tenants[grp.tenants[l]]
                    ok = all(np.isfinite(val[l, i]) and np.isfinite(mu[l, i])
                             and np.isfinite(var[l, i])
                             and np.all(np.isfinite(grad[l, i]))
                             for i, s in enumerate(t.slots) if s is not None)
                    if not ok and self._quarantine_repair(grp, l):
                        held.add(l)
            for l in serving:
                if l in held:
                    continue
                t = self.tenants[grp.tenants[l]]
                for i, q in enumerate(t.slots):
                    if q is None:
                        continue
                    if q.kind == "ascend" and q.steps > 0:
                        t.xs[i] = Xn[l, i]
                        q.steps -= 1
                        continue
                    q.result = {"x": t.xs[i].copy(), "mean": float(mu[l, i]),
                                "var": float(var[l, i]),
                                "value": float(val[l, i]),
                                "grad": grad[l, i].copy(),
                                "version": q.version}
                    q.done = True
                    finished.append(q)
                    t.slots[i] = None
        return finished

    def run_until_done(self, max_ticks: int = 10_000) -> list[Query]:
        done: list[Query] = []
        for _ in range(max_ticks):
            done += self.step()
            if all(not t.pending and not t.staged
                   and all(s is None for s in t.slots)
                   for t in self.tenants):
                break
        return done

    # -- per-tenant mutations (versioned fences, batched application) --------

    def insert(self, tenant: int, x_new, y_new) -> None:
        """Stage an observation insert for one tenant (applied at its
        fence; the other tenants keep serving)."""
        self.tenants[tenant].staged.append(
            ("insert", np.asarray(x_new, np.float64), float(y_new)))

    def evict(self, tenant: int) -> None:
        """Stage a drop-oldest eviction for one tenant, validated against
        its count projected over its staged ops."""
        t = self.tenants[tenant]
        projected = t.count
        for op in t.staged:
            if op[0] == "insert":
                projected += 1
            elif op[0] == "evict":
                projected -= 1
            else:
                projected = op[1].num_points()
        if projected <= 1:
            raise ValueError(
                f"cannot stage evict for tenant {tenant}: it would drop "
                f"below one observation ({projected} projected)")
        t.staged.append(("evict",))

    def set_posterior(self, tenant: int, gp: AdditiveGP) -> None:
        """Stage a full posterior replacement for one tenant."""
        if gp.config != self.tenant_config():
            raise ValueError("replacement GP must share the fleet's GPConfig")
        self.tenants[tenant].staged.append(("set", gp))

    def tenant_config(self):
        return next(iter(self.groups.values())).stack.config

    def _apply_ready_mutations(self) -> None:
        """Apply (at most) one staged op per fenced and drained tenant:
        host-side ops first (a posterior replacement; re-homing a tenant
        whose insert would overflow its tier, once any window drain is
        done), then one masked ``fleet_evict`` round (evictions and window
        drains) and one masked ``fleet_insert`` round per group. A tenant
        with several staged ops drains them over successive ticks, its
        fence held until the list is empty."""
        ready = [t for t in self.tenants
                 if t.staged and all(s is None for s in t.slots)]
        if not ready:
            return
        for t in ready:
            op = t.staged[0]
            if op[0] == "set":
                gp = op[1]
                cap = max(t.group.capacity, gp.n,
                          _next_tier(gp.num_points() + 1))
                self._release_lane(t)
                self._place(t, with_capacity(gp, cap), cap)
                t.count = gp.num_points()
                t.version += 1
                t.staged.pop(0)
            elif (op[0] == "insert"
                  and (t.window is None or t.count < t.window)
                  and t.count >= t.group.capacity):
                # tier overflow: this tenant alone moves to the doubled
                # tier's group (the same posterior, no version bump)
                cap = _next_tier(2 * t.group.capacity)
                gp = tenant_gp(t.group.stack, t.lane)
                self._release_lane(t)
                self._place(t, with_capacity(gp, cap), cap)
        for grp in list(self.groups.values()):
            members = [self.tenants[tid] for tid in grp.tenants
                       if tid is not None]
            ready_here = [t for t in members
                          if t.staged and all(s is None for s in t.slots)]
            if not ready_here:
                continue
            fleet = GPFleet(gp=grp.stack)
            # the pre-round stack is the quarantine's in-memory last-good
            # snapshot: no op of the round writes a stack tensor in place
            # (the masked rounds build new tensors), so it stays as it is
            prev = grp.stack
            mutated: set[int] = set()
            counts = np.zeros(grp.lanes, int)
            for t in members:
                counts[t.lane] = t.count
            drains = [t for t in ready_here if t.staged[0][0] == "insert"
                      and t.window is not None and t.count >= t.window]
            evicts = [t for t in ready_here if t.staged[0][0] == "evict"]
            if drains or evicts:
                do = np.zeros(grp.lanes, bool)
                for t in drains + evicts:
                    do[t.lane] = True
                fleet = fleet_evict(fleet, do, iters=self.insert_iters,
                                    counts=counts)
                for t in drains:  # a drain does not consume the insert
                    t.count -= 1
                    t.version += 1
                    counts[t.lane] -= 1
                    mutated.add(t.lane)
                for t in evicts:
                    t.count -= 1
                    t.version += 1
                    counts[t.lane] -= 1
                    t.staged.pop(0)
                    mutated.add(t.lane)
            inserts = [t for t in ready_here if t.staged
                       and t.staged[0][0] == "insert"
                       and (t.window is None or t.count < t.window)
                       and t.count < grp.capacity]
            if inserts:
                do = np.zeros(grp.lanes, bool)
                x_new = np.zeros((grp.lanes, self.bounds.shape[0]),
                                 np.float64)
                y_new = np.zeros(grp.lanes, np.float64)
                for t in inserts:
                    do[t.lane] = True
                    _, x, y = t.staged[0]
                    x_new[t.lane] = x
                    y_new[t.lane] = y
                fleet = fleet_insert(fleet, x_new, y_new, do,
                                     iters=self.insert_iters, counts=counts)
                for t in inserts:
                    t.count += 1
                    t.version += 1
                    t.staged.pop(0)
                    mutated.add(t.lane)
            grp.stack = fleet.gp
            if mutated:
                self._group_health(grp, prev, sorted(mutated))
        for t in ready:
            if not t.staged:  # the fence lifts: refresh the incumbent
                t.best_y = self._fresh_best_y(t)

    # -- tier-group lane management ------------------------------------------

    def _release_lane(self, t: _Tenant) -> None:
        grp = t.group
        grp.tenants[t.lane] = None
        t.group, t.lane = None, -1
        if all(tid is None for tid in grp.tenants):
            del self.groups[grp.capacity]

    def _place(self, t: _Tenant, gp: AdditiveGP, cap: int) -> None:
        """Seat ``gp`` (padded to ``cap``) in the ``cap``-tier group,
        doubling its lanes or creating it when needed."""
        grp = self.groups.get(cap)
        if grp is None:
            grp = _TierGroup(capacity=cap, lanes=1, stack=_stack([gp]),
                             tenants=[None])
            self.groups[cap] = grp
        if None not in grp.tenants:
            # the new upper half starts as stale copies (valid states,
            # masked out of every round)
            grp.stack = tree_map(lambda a: torch.cat([a, a]), grp.stack)
            grp.tenants += [None] * grp.lanes
            grp.lanes *= 2
        lane = grp.tenants.index(None)
        grp.stack = set_tenant_gp(grp.stack, gp, lane)
        grp.tenants[lane] = t.tid
        t.group, t.lane = grp, lane
