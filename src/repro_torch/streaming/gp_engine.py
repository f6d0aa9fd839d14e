"""Slot-batched query serving over a streaming posterior.

Counterpart of ``repro.streaming.gp_engine``: a fixed pool of B request
slots, an admit/retire lifecycle, and one batched tick that evaluates the
posterior mean, variance and acquisition (with its gradient) for every
occupied slot against one shared GP; multi-tick "ascend" queries run
projected gradient ascent on the acquisition, so many acquisition
maximizations share each batched evaluation.

Versioning: mutations (``insert``, ``evict``, ``set_posterior``) are staged
and act as a fence: admission pauses, running slots drain, the mutations
apply (the version bumps once per mutation) and admission resumes. A query
is pinned to the version current when it was admitted, and its result
carries it.

Capacity: the posterior is held capacity-padded, so every insert and evict
at a tier runs at the same shapes (the same launches, no new buffers). An
insert that would overflow the tier first re-homes the posterior into a
doubled allocation. With ``window=W`` the engine slides: each insert past
``W`` points is preceded by drop-oldest evictions, which pins memory at the
``W`` tier.

Health (a GP fitted with ``health="on"``): at the fence one read of the
carried health scalars; the drift sentinel resyncs the variance band when
the windowed updates' truncation estimate crosses ``DRIFT_TOL``, a non-OK
solve verdict walks the degradation ladder (``health.ladder.repair``), and
an optional :class:`~repro_torch.checkpoint.Checkpointer` keeps a
last-good snapshot every ``checkpoint_every`` versions, restored when the
ladder is exhausted. A nonfinite query result holds its slot, repairs the
posterior and serves the slot again on the next tick.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..core.additive_gp import AdditiveGP, with_capacity
from ..core.bayesopt import (BOConfig, acquisition_stats, ascent_step,
                             uniform_rows)
from ..health import verdict as hv
from .updates import evict as stream_evict
from .updates import insert as stream_insert
from .updates import resync_gband

__all__ = ["GPServeEngine", "Query", "propose_via_engine"]


def _next_tier(m: int) -> int:
    """Smallest power-of-two capacity >= m (>= 8)."""
    return max(8, 1 << (int(m) - 1).bit_length())


@dataclasses.dataclass
class Query:
    """One posterior request; ``kind`` selects what retires into ``result``.

    "mean" / "var" / "acq" retire after one tick with the posterior mean,
    variance and acquisition value (+gradient) at ``x``; "ascend" first runs
    ``steps`` acquisition-ascent ticks from ``x``. ``result`` holds x, mean,
    var, value, grad, and the version that served it."""

    rid: int
    x: np.ndarray
    kind: str = "acq"
    steps: int = 0
    version: int = -1
    result: dict | None = None
    done: bool = False


class GPServeEngine:
    """Fixed-slot batched server for posterior and acquisition queries.

    ``capacity`` pins the first allocation tier (default: the next power of
    two above the point count); ``window`` turns on sliding-window serving.
    The engine serves on the device the GP lives on.
    """

    def __init__(self, gp: AdditiveGP, bounds, batch_slots: int = 8,
                 kind: str = "ucb", beta: float = 2.0, lr: float = 0.05,
                 insert_iters: int | None = None,
                 capacity: int | None = None, window: int | None = None,
                 checkpointer=None, checkpoint_every: int = 64):
        n_points = gp.num_points()
        if window is not None and window < 2:
            raise ValueError(f"window must be >= 2; got {window}")
        if capacity is None:
            capacity = _next_tier(min(n_points + 1, window)
                                  if window is not None else n_points + 1)
        self.window = window
        self.gp = with_capacity(gp, max(capacity, gp.n))
        self.bounds = torch.as_tensor(np.asarray(bounds, np.float64),
                                      device=gp.device)
        self.B = batch_slots
        self.kind = kind
        self.beta = beta
        self.lr = lr
        self.insert_iters = insert_iters
        self.version = 0
        self.slots: list[Query | None] = [None] * batch_slots
        self.pending: deque[Query] = deque()
        self._staged: list[tuple] = []
        self._xs = np.zeros((batch_slots, gp.D), np.float64)
        # best_y pinned per slot at admission, like the version
        self._besty = np.zeros(batch_slots, np.float64)
        self._next_rid = 0
        self._count = n_points
        # health (health="on" GPs): the fence's sentinel and ladder repair,
        # the query tick's hold-and-repair, a last-good checkpoint
        self._ckpt = checkpointer
        self._ckpt_every = max(1, int(checkpoint_every))
        self._repairs = 0
        self._resyncs = 0
        self._health_events: list = []
        self.best_y = self._active_best()

    def _active_best(self) -> float:
        return float(self.gp.Y[:self._count].max())

    @property
    def num_points(self) -> int:
        """Active observation count (the capacity may be larger)."""
        return self._count

    @property
    def capacity(self) -> int:
        return self.gp.n

    # -- health --------------------------------------------------------------

    def health_stats(self) -> dict:
        """Counters and the :class:`~repro_torch.health.HealthEvent` trail
        of every ladder escalation and sentinel resync so far."""
        return {"repairs": self._repairs, "resyncs": self._resyncs,
                "events": list(self._health_events)}

    def _post_mutation_health(self) -> None:
        """Fence-time health pass: one read of the carried scalars, then the
        sentinel's resync and/or a ladder repair. A healthy fence costs the
        read (and, every ``checkpoint_every`` versions, a save)."""
        h = self.gp.health
        if h is None:
            return
        verdict, drift, muts = torch.stack(
            [h.verdict.to(h.drift.dtype), h.drift,
             h.muts.to(h.drift.dtype)]).tolist()
        verdict, muts = int(verdict), int(muts)
        if drift > hv.DRIFT_TOL or muts >= hv.RESYNC_EVERY:
            from ..health.ladder import HealthEvent

            self.gp = resync_gband(self.gp)
            self._resyncs += 1
            self._health_events.append(HealthEvent(
                op="sentinel", rung="gband_resync", before=verdict,
                after=verdict,
                detail=f"drift={drift:.3e} after {muts} windowed "
                       "mutation(s)"))
        if verdict != hv.OK:
            self._repair("mutation")
        elif (self._ckpt is not None
              and self.version % self._ckpt_every == 0):
            self._ckpt.save(self.version, self.gp)

    def _repair(self, op: str) -> bool:
        """Ladder-repair the posterior, the last-good checkpoint as the
        backstop. Returns whether the posterior changed."""
        from ..health.ladder import HealthEvent, probe_gp, repair

        gp, events = repair(self.gp, op=op)
        if not events:
            return False
        if (probe_gp(gp) != hv.OK and self._ckpt is not None
                and self._ckpt.latest_step() is not None):
            restored, step = self._ckpt.restore(self.gp)
            if restored is not None:
                gp = restored
                events.append(HealthEvent(
                    op=op, rung="checkpoint_restore", before=events[-1].after,
                    after=probe_gp(gp),
                    detail=f"last-good checkpoint step {step}"))
        self._health_events += events
        self._repairs += 1
        self.gp = gp
        self._count = gp.num_points()
        self.version += 1
        self.best_y = self._active_best()
        return True

    # -- request lifecycle --------------------------------------------------

    def submit(self, x, kind: str = "acq", steps: int = 0) -> Query:
        """Queue a query; returns its handle (filled in when it retires)."""
        if kind not in ("mean", "var", "acq", "ascend"):
            raise ValueError(f"unknown query kind {kind!r}")
        q = Query(rid=self._next_rid, x=np.asarray(x, np.float64),
                  kind=kind, steps=steps if kind == "ascend" else 0)
        self._next_rid += 1
        self.pending.append(q)
        return q

    def step(self) -> list[Query]:
        """One engine tick; returns the queries retired this tick."""
        if self._staged and all(s is None for s in self.slots):
            self._apply_staged()
        if not self._staged:  # staged mutations fence admission
            for i in range(self.B):
                if self.slots[i] is None and self.pending:
                    q = self.pending.popleft()
                    q.version = self.version
                    self.slots[i] = q
                    self._xs[i] = q.x
                    self._besty[i] = self.best_y
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        dev = self.gp.device
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        X = torch.as_tensor(self._xs, device=dev)
        best = torch.as_tensor(self._besty, device=dev)
        val, grad, mu, var = acquisition_stats(self.gp, X, self.beta, best,
                                               kind=self.kind, device=dev)
        Xn = ascent_step(X, grad, lo, hi, self.lr * (hi - lo))
        val, grad, mu, var, Xn = (t.cpu().numpy()
                                  for t in (val, grad, mu, var, Xn))
        # query-path detection (health-on posteriors): a nonfinite result
        # means a corrupt artifact reached serving. The affected slots are
        # held (no retire, no ascent step), the posterior is repaired, and
        # they are served again next tick. If the ladder finds nothing wrong
        # the NaN is the query's own and it retires as it is, as every
        # result of a health-off engine does.
        held: set[int] = set()
        if self.gp.health is not None:
            bad = [i for i in active
                   if not (np.isfinite(val[i]) and np.isfinite(mu[i])
                           and np.isfinite(var[i])
                           and np.all(np.isfinite(grad[i])))]
            if bad and self._repair("query"):
                held = set(bad)
        finished = []
        for i in active:
            if i in held:
                continue
            q = self.slots[i]
            if q.kind == "ascend" and q.steps > 0:
                self._xs[i] = Xn[i]
                q.steps -= 1
                continue
            q.result = {"x": self._xs[i].copy(), "mean": float(mu[i]),
                        "var": float(var[i]), "value": float(val[i]),
                        "grad": grad[i].copy(), "version": q.version}
            q.done = True
            finished.append(q)
            self.slots[i] = None
        return finished

    def run_until_done(self, max_ticks: int = 10_000) -> list[Query]:
        done: list[Query] = []
        for _ in range(max_ticks):
            done += self.step()
            if (not self.pending and not self._staged
                    and all(s is None for s in self.slots)):
                break
        return done

    # -- posterior mutations (versioned, fence semantics) ---------------------

    def insert(self, x_new, y_new) -> None:
        """Stage an incremental observation insert (applied at the fence)."""
        self._staged.append(("insert", np.asarray(x_new, np.float64),
                             float(y_new)))

    def evict(self) -> None:
        """Stage a drop-oldest eviction (applied at the fence), validated
        against the count projected over the staged mutations, so an
        over-eviction fails here and not at the fence."""
        projected = self._count
        for op in self._staged:
            if op[0] == "insert":
                projected += 1
            elif op[0] == "evict":
                projected -= 1
            else:
                projected = op[1].num_points()
        if projected <= 1:
            raise ValueError(
                "cannot stage evict: the engine would drop below one "
                f"observation ({projected} projected after staged mutations)")
        self._staged.append(("evict",))

    def set_posterior(self, gp: AdditiveGP) -> None:
        """Stage a full posterior replacement (e.g. a hyperparameter refit)."""
        self._staged.append(("set", gp))

    def _apply_staged(self) -> None:
        for op in self._staged:
            if op[0] == "insert":
                # sliding window: free the oldest slots first (a loop, so an
                # engine built above the window drains down to it)
                while self.window is not None and self._count >= self.window:
                    self.gp = stream_evict(self.gp, iters=self.insert_iters,
                                           count=self._count)
                    self._count -= 1
                    self.version += 1
                if self._count >= self.gp.n:
                    # tier overflow: re-home into a doubled allocation (the
                    # same posterior, no version bump)
                    self.gp = with_capacity(self.gp,
                                            _next_tier(2 * self.gp.n))
                self.gp = stream_insert(self.gp, op[1], op[2],
                                        iters=self.insert_iters,
                                        count=self._count)
                self._count += 1
                self.version += 1
            elif op[0] == "evict":
                self.gp = stream_evict(self.gp, iters=self.insert_iters,
                                       count=self._count)
                self._count -= 1
                self.version += 1
            else:
                gp = op[1]
                # keep the tier (never below the replacement's allocation)
                self.gp = with_capacity(
                    gp, max(self.gp.n, gp.n, _next_tier(gp.num_points() + 1)))
                self._count = gp.num_points()
                self.version += 1
        self._staged.clear()
        self._post_mutation_health()
        self.best_y = self._active_best()


def propose_via_engine(engine: GPServeEngine, generator: torch.Generator,
                       cfg: BOConfig, best_y=None):
    """Multi-start acquisition ascent routed through the engine's slots:
    ``propose_next``'s start draw (:func:`core.bayesopt.uniform_rows`) and
    update rule, served tick by tick. Returns the best point (D,) as a
    float64 numpy array. ``cfg``'s acquisition settings must be the
    engine's."""
    if (cfg.kind, cfg.beta, cfg.lr) != (engine.kind, engine.beta, engine.lr):
        raise ValueError(
            f"BOConfig(kind={cfg.kind!r}, beta={cfg.beta}, lr={cfg.lr}) does "
            f"not match the engine's (kind={engine.kind!r}, "
            f"beta={engine.beta}, lr={engine.lr}); construct the engine from "
            "the same config")
    lo, hi = engine.bounds[:, 0], engine.bounds[:, 1]
    starts = uniform_rows(generator, (cfg.n_starts, engine.gp.D),
                          dtype=engine.bounds.dtype, device=engine.gp.device)
    X0 = (lo + starts * (hi - lo)).cpu().numpy()
    if best_y is not None:
        engine.best_y = float(best_y)
    qs = [engine.submit(x, kind="ascend", steps=cfg.ascent_steps) for x in X0]
    # each request takes steps + 1 ticks; admission waves add B-sized rounds
    waves = -(-len(engine.pending) // engine.B) + 1
    engine.run_until_done(max_ticks=waves * (cfg.ascent_steps + 2) + 8)
    if not all(q.done for q in qs):
        raise RuntimeError("engine tick budget exhausted before all ascent "
                           "requests retired")
    return max(qs, key=lambda q: q.result["value"]).result["x"]
