"""The port's health ladder, fault injectors, engine repairs and
checkpointer on the CPU, against the JAX package (``tests/test_health.py``'s
sizes: n = 24 at capacity 32; fleets of T = 8 with n = 10 at capacity 16).

The port's ``GPConfig(q=0, solver="pcg", solver_iters=60, fused="off")``
is paired with the JAX package's ``backend="jax"`` config: the same rungs
apply to both, so for every injected fault the detection verdict and the
ladder's trail (rung, before, after) are equal rung for rung, and the
repaired mean and variance agree within 1e-10 with the JAX package's
repaired GP and with a clean refit. A ``fused="whole"`` GP (port only)
gains the ``unfused`` rung. The engines repair where the JAX package's do
(fence repair, query hold, fleet quarantine), with the same counts,
versions and results; the other lanes of a quarantined fleet keep their
tensors bit for bit. Injectors and the fleet's pre-round snapshot see no
in-place write. Checkpoints round-trip bit for bit and refuse another
structure. The reference side is computed once per module, lazily, part
by part.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.health as jhealth
from repro.core.additive_gp import mean_caches as jax_mean_caches
from repro.streaming import GPFleetEngine as JaxFleetEngine
from repro.streaming import GPServeEngine as JaxServeEngine
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
from repro_torch.core.additive_gp import mean_caches
from repro_torch.health import (DIVERGED, NONFINITE, OK, STALLED,
                                corrupt_hierarchy, dense_cluster_stream,
                                iteration_cap, nan_active_row,
                                near_singular_band, probe_gp, repair)
from repro_torch.health import ladder
from repro_torch.streaming import GPFleetEngine, GPServeEngine
from torch_port_jax_ref import (fresh_jax_caches,  # noqa: F401
                                shared_ref)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

CFG = GPConfig(q=0, solver="pcg", solver_iters=60, fused="off")
JCFG = jcore.GPConfig(q=0, solver="pcg", solver_iters=60, backend="jax")
BOUNDS = [[0.0, 5.0]] * 2
FLEET_BOUNDS = [[0.0, 1.0]] * 2
# each fault class and the verdict(s) it must be detected as
EXPECTED_VERDICTS = {"iteration_cap": (STALLED,),
                     "diverged_warm": (DIVERGED,),
                     "corrupt_hierarchy": (STALLED,),
                     "nan_active_row": (NONFINITE,),
                     "near_singular_band": (STALLED, DIVERGED, NONFINITE)}
FAULTS = tuple(EXPECTED_VERDICTS)
# Solves through near_singular_band's 1/eps pivot amplify rounding ~1e13:
# after two PCG iterations r.z is ~1e-7 against terms of ~1e10, so the two
# packages' float64 orders leave it on either side of rel = 1 (the port's
# 60-iteration solve lands DIVERGED, the JAX package's STALLED). There the
# codes are held to the fault's set and the rungs to the JAX package's.
ROUNDING_DETERMINED = {"near_singular_band"}


def _data(n, D=2, seed=0, scale=5.0):
    rng = np.random.default_rng(seed)
    X = rng.random((n, D)) * scale
    Y = np.sin(X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, Y, 0.8 + rng.random(D)


def _gap(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _trail(events):
    return [(e.rung, int(e.before), int(e.after)) for e in events]


def _fault_setup(fault):
    """(data seed, port config, JAX config) of one fault case: the kmg
    fault on ``test_health.py``'s seed-4 data, the rest on seed 0."""
    if fault == "corrupt_hierarchy":
        return (4, dataclasses.replace(CFG, precond="kmg"),
                dataclasses.replace(JCFG, precond="kmg"))
    return 0, CFG, JCFG


def _broken(fault, gp, pkg):
    """The fault injected into ``gp`` through package ``pkg``'s
    injectors (the port's, or the JAX package's)."""
    if fault == "iteration_cap":
        return pkg.iteration_cap(gp, iters=1)
    if fault == "corrupt_hierarchy":
        return pkg.iteration_cap(pkg.corrupt_hierarchy(gp), iters=60)
    if fault == "nan_active_row":
        return pkg.nan_active_row(gp, row=3)
    if fault == "near_singular_band":
        return pkg.iteration_cap(pkg.near_singular_band(gp, row=1, dim=0),
                                 iters=60)
    # a streaming warm solve started from a poisoned previous iterate
    mc = mean_caches if pkg is _PORT else jax_mean_caches
    u_sy, bY, info = mc(gp.config, gp.ops, gp.Y, x0=gp.u_sy * 1e8, iters=2,
                        return_info=True)
    return dataclasses.replace(gp, u_sy=u_sy, bY=bY,
                               health=gp.health.with_solve(info))


class _PORT:
    iteration_cap = staticmethod(iteration_cap)
    corrupt_hierarchy = staticmethod(corrupt_hierarchy)
    nan_active_row = staticmethod(nan_active_row)
    near_singular_band = staticmethod(near_singular_band)


def _clean_data(fault, X, Y):
    """The data a clean refit of the repaired GP sees."""
    if fault == "nan_active_row":
        return np.delete(X, 3, axis=0), np.delete(Y, 3)
    return X, Y


def _jax_fault(fault):
    seed, _, jcfg = _fault_setup(fault)
    X, Y, om = _data(24, seed=seed)
    gp = jcore.fit(jcfg, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(om),
                   0.3, capacity=32)
    bad = _broken(fault, gp, jhealth)
    fixed, events = jhealth.repair(bad, op="test")
    Xq = jnp.asarray(X[:6])
    return dict(verdict=jhealth.probe_gp(bad), trail=_trail(events),
                n=fixed.num_points(),
                mean=np.asarray(jcore.posterior_mean(fixed, Xq)),
                var=np.asarray(jcore.posterior_var(fixed, Xq)))


def _jax_engine_fence():
    X, Y, om = _data(24)
    gp = jcore.fit(JCFG, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(om),
                   0.3, capacity=32)
    eng = JaxServeEngine(gp, BOUNDS, batch_slots=2, insert_iters=60)
    eng.insert(X[0] + 0.01, float("nan"))
    q = eng.submit(X[1], kind="mean")
    eng.run_until_done()
    return _engine_summary(eng, [q])


def _jax_engine_query():
    X, Y, om = _data(24)
    gp = jcore.fit(JCFG, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(om),
                   0.3, capacity=32)
    eng = JaxServeEngine(jhealth.nan_active_row(gp, row=2), BOUNDS,
                         batch_slots=2)
    qs = [eng.submit(X[2], kind="mean"), eng.submit(X[5], kind="var")]
    eng.run_until_done()
    return _engine_summary(eng, qs)


def _engine_summary(eng, qs):
    stats = eng.health_stats()
    return dict(repairs=stats["repairs"], trail=_trail(stats["events"]),
                n=eng.num_points, version=eng.version,
                results=[(q.done, q.result["mean"], q.result["var"],
                          q.result["version"]) for q in qs])


def _fleet_data(T, n=10):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(T):
        X = rng.uniform(size=(n, 2))
        out.append((X, np.cos(2 * X).sum(axis=1)
                    + 0.05 * rng.standard_normal(n)))
    return out


FLEET_ITERS, POISONED, ROW = 40, 2, 4


def _jax_fleet():
    cfg = dataclasses.replace(JCFG, solver_iters=FLEET_ITERS)
    data = _fleet_data(8)
    gps = [jcore.fit(cfg, jnp.asarray(X), jnp.asarray(Y), jnp.ones(2), 0.25,
                     capacity=16) for X, Y in data]
    gps[POISONED] = jhealth.nan_active_row(gps[POISONED], row=ROW)
    fe = JaxFleetEngine(gps, FLEET_BOUNDS, batch_slots=2)
    qs = [fe.submit(t, data[t][0][ROW], kind="mean") for t in range(8)]
    fe.run_until_done()
    return _fleet_summary(fe, qs)


def _fleet_summary(fe, qs):
    stats = fe.health_stats()
    return dict(repairs=stats["repairs"], quarantines=stats["quarantines"],
                trail=_trail(stats["events"]), counts=list(fe.counts()),
                versions=list(fe.versions()),
                results=[(q.done, q.result["mean"]) for q in qs])


_REF = {("fault", f): (lambda f=f: _jax_fault(f)) for f in FAULTS}
_REF.update({"engine_fence": _jax_engine_fence,
             "engine_query": _jax_engine_query, "fleet": _jax_fleet})


@pytest.fixture(scope="module")
def ref(shared_ref):
    """``get(key)``: one part of the JAX package's side, computed once per
    run when a test first asks for it (``shared_ref``)."""
    return lambda key: shared_ref(("test_torch_health", key), _REF[key])


def _port_fit(cfg, X, Y, om, capacity=32):
    return fit(cfg, X, Y, om, 0.3, device="cpu", capacity=capacity)


# ---------------------------------------------------------------------------
# the injectors and the ladder against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_detected_and_repaired_as_reference(ref, fault):
    """Detection verdict, rung trail (rung, before, after) and fixing rung
    equal the JAX package's (``ROUNDING_DETERMINED``: the rungs, and the
    codes within the fault's set); the repaired mean and variance are
    within 1e-10 of its repaired GP's and of a clean refit's."""
    want = ref(("fault", fault))
    seed, cfg, _ = _fault_setup(fault)
    X, Y, om = _data(24, seed=seed)
    gp = _port_fit(cfg, X, Y, om)
    bad = _broken(fault, gp, _PORT)
    verdict = probe_gp(bad)
    assert verdict in EXPECTED_VERDICTS[fault]
    fixed, events = repair(bad, op="test")
    if fault in ROUNDING_DETERMINED:
        assert want["verdict"] in EXPECTED_VERDICTS[fault]
        assert [e.rung for e in events] == [r for r, _, _ in want["trail"]]
        assert all(e.before in EXPECTED_VERDICTS[fault] for e in events)
    else:
        assert verdict == want["verdict"]
        assert _trail(events) == want["trail"]
    assert events[-1].fixed and probe_gp(fixed) == OK
    assert fixed.config == gp.config and fixed.n == 32
    assert fixed.num_points() == want["n"]
    Xq = X[:6]
    mu = posterior_mean(fixed, Xq, device="cpu").numpy()
    var = posterior_var(fixed, Xq, device="cpu").numpy()
    assert _gap(mu, want["mean"]) < 1e-10
    assert _gap(var, want["var"]) < 1e-10
    clean = _port_fit(cfg, *_clean_data(fault, X, Y), om)
    assert _gap(mu, posterior_mean(clean, Xq, device="cpu")) < 1e-10
    assert _gap(var, posterior_var(clean, Xq, device="cpu")) < 1e-10
    if fault == "corrupt_hierarchy":
        # the stored hierarchy was rebuilt: a preconditioned solve is OK
        assert int(iteration_cap(fixed, iters=60).health.verdict) == OK


def test_fused_whole_trail_gains_unfused(ref):
    """Port only: a ``fused="whole"`` GP walks the ``unfused`` rung too
    (on either device), then ends where the paired config ends."""
    want = ref(("fault", "near_singular_band"))
    X, Y, om = _data(24)
    gp = _port_fit(dataclasses.replace(CFG, fused="whole"), X, Y, om)
    assert gp.config.fused == "whole"
    fixed, events = repair(iteration_cap(near_singular_band(gp, row=1, dim=0),
                                         iters=60), op="test")
    rungs = [r for r, _, _ in want["trail"]]
    assert [e.rung for e in events] == rungs[:1] + ["unfused"] + rungs[1:]
    assert events[-1].rung == "refit_clean" and events[-1].fixed
    Xq = X[:6]
    assert _gap(posterior_mean(fixed, Xq, device="cpu"), want["mean"]) < 1e-10
    assert _gap(posterior_var(fixed, Xq, device="cpu"), want["var"]) < 1e-10


def test_plain_versions_rung_is_a_cuda_rung():
    """The reference's fifth rung (``backend_jax``, its second backend) has
    no counterpart in the port, whose rungs all re-solve on the GP's own
    device: it applies to no GP, a walk that reaches ``refit_clean`` never
    records it, and running it by name is refused."""
    X, Y, om = _data(24)
    gp = _port_fit(CFG, X, Y, om)
    bad = nan_active_row(gp, row=3)
    assert not ladder._applies("backend_jax", bad)
    fixed, events = repair(bad, op="test")
    rungs = [e.rung for e in events]
    assert "backend_jax" not in rungs and rungs[-1] == "refit_clean"
    assert probe_gp(fixed) == OK
    with pytest.raises(ValueError, match="does not run in the port"):
        ladder._apply("backend_jax", bad)


def _leaves(gp):
    return [t.clone() for t in flatten(gp)[0]]


def test_injectors_and_repair_write_nothing_in_place():
    """Every injector and the ladder clone before they write: the GP they
    were given keeps every tensor."""
    X, Y, om = _data(24, seed=4)
    gp = _port_fit(dataclasses.replace(CFG, precond="kmg"), X, Y, om)
    before = _leaves(gp)
    bads = [nan_active_row(gp, row=3), near_singular_band(gp, row=1),
            corrupt_hierarchy(gp), iteration_cap(gp, iters=1),
            nan_active_row(gp, row=5, poison_caches=False)]
    for bad in bads:
        repair(bad, op="test")
    after = flatten(gp)[0]
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert torch.isnan(bads[0].Y[3]) and not torch.isnan(gp.Y[3])


def test_dense_cluster_stream_draws_the_references_points():
    X, Y = dense_cluster_stream(40, 2, seed=3, device="cpu")
    jX, jY = jhealth.dense_cluster_stream(40, 2, seed=3)
    assert X.device.type == "cpu" and X.dtype == torch.float64
    assert np.array_equal(X.numpy(), np.asarray(jX))
    assert np.array_equal(Y.numpy(), np.asarray(jY))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def _port_engine_fence():
    X, Y, om = _data(24)
    eng = GPServeEngine(_port_fit(CFG, X, Y, om), BOUNDS, batch_slots=2,
                        insert_iters=60)
    eng.insert(X[0] + 0.01, float("nan"))
    q = eng.submit(X[1], kind="mean")
    eng.run_until_done()
    return _engine_summary(eng, [q])


def _port_engine_query():
    X, Y, om = _data(24)
    eng = GPServeEngine(nan_active_row(_port_fit(CFG, X, Y, om), row=2),
                        BOUNDS, batch_slots=2)
    qs = [eng.submit(X[2], kind="mean"), eng.submit(X[5], kind="var")]
    eng.run_until_done()
    return _engine_summary(eng, qs)


def _same_summary(got, want):
    for k in ("repairs", "trail", "n", "version"):
        assert got[k] == want[k], k
    for (d, m, v, ver), (wd, wm, wv, wver) in zip(got["results"],
                                                  want["results"]):
        assert d and wd and ver == wver
        assert np.isfinite(m) and np.isfinite(v)
        assert abs(m - wm) < 1e-10 and abs(v - wv) < 1e-10


@pytest.mark.parametrize("case", ["engine_fence", "engine_query"])
def test_engine_repairs_as_reference(ref, case):
    """A NaN insert is repaired at the fence (``refit_clean`` drops it
    again); a poisoned posterior's query is held, the posterior repaired
    and the query served next tick. Counts, trails, versions and results
    as the JAX package's engine; the query result also equals a clean
    refit's."""
    got = {"engine_fence": _port_engine_fence,
           "engine_query": _port_engine_query}[case]()
    want = ref(case)
    _same_summary(got, want)
    assert got["repairs"] == 1 and got["trail"][-1][0] == "refit_clean"
    if case == "engine_query":
        X, Y, om = _data(24)
        clean = _port_fit(CFG, np.delete(X, 2, axis=0), np.delete(Y, 2), om)
        mu = float(posterior_mean(clean, X[2][None], device="cpu")[0])
        assert got["n"] == 23 and abs(got["results"][0][1] - mu) < 1e-10


def test_health_off_pins_nan_delivery():
    X, Y, om = _data(24)
    off = _port_fit(dataclasses.replace(CFG, health="off"), X, Y, om)
    eng = GPServeEngine(nan_active_row(off, row=2), BOUNDS, batch_slots=2)
    q = eng.submit(X[2], kind="mean")
    eng.run_until_done()
    assert q.done and not np.isfinite(q.result["mean"])
    assert eng.health_stats() == {"repairs": 0, "resyncs": 0, "events": []}


def _port_fleet(poison=True, **kw):
    cfg = dataclasses.replace(CFG, solver_iters=FLEET_ITERS)
    data = _fleet_data(8)
    gps = [fit(cfg, X, Y, np.ones(2), 0.25, device="cpu", capacity=16)
           for X, Y in data]
    if poison:
        gps[POISONED] = nan_active_row(gps[POISONED], row=ROW)
    return GPFleetEngine(gps, FLEET_BOUNDS, batch_slots=2, **kw), data


def test_fleet_query_quarantine_t8(ref):
    """One poisoned tenant of eight is quarantined and repaired while the
    others serve; counts, versions, trail and results as the JAX package's
    fleet engine, the repaired tenant equal to a clean refit, and every
    other lane's tensors bit for bit as before."""
    fe, data = _port_fleet()
    others = {t: _leaves(fe.tenant_gp(t)) for t in range(8) if t != POISONED}
    qs = [fe.submit(t, data[t][0][ROW], kind="mean") for t in range(8)]
    fe.run_until_done()
    got, want = _fleet_summary(fe, qs), ref("fleet")
    for k in ("repairs", "quarantines", "trail", "counts", "versions"):
        assert got[k] == want[k], k
    assert got["quarantines"] == 1 and got["counts"][POISONED] == 9
    for (d, m), (wd, wm) in zip(got["results"], want["results"]):
        assert d and wd and np.isfinite(m) and abs(m - wm) < 1e-10
    X2 = np.delete(data[POISONED][0], ROW, axis=0)
    Y2 = np.delete(data[POISONED][1], ROW)
    clean = fit(dataclasses.replace(CFG, solver_iters=FLEET_ITERS), X2, Y2,
                np.ones(2), 0.25, device="cpu", capacity=16)
    mu = float(posterior_mean(clean, data[POISONED][0][ROW][None],
                              device="cpu")[0])
    assert abs(got["results"][POISONED][1] - mu) < 1e-10
    for t, before in others.items():
        after = flatten(fe.tenant_gp(t))[0]
        assert all(torch.equal(a, b) for a, b in zip(after, before)), t


def _never(*a, **k):
    raise AssertionError("the healthy path entered the ladder")


def test_fleet_round_leaves_the_pre_round_snapshot_intact(monkeypatch):
    """The quarantine's pre-round snapshot is the stack object from before
    the round: no op of a mutation round writes its tensors in place. A
    healthy round never enters the ladder."""
    fe, data = _port_fleet(poison=False, insert_iters=FLEET_ITERS)
    prev = fe.groups[16].stack
    snap = _leaves(prev)
    monkeypatch.setattr(ladder, "repair", _never)
    for t in range(8):
        fe.insert(t, data[t][0][0] * 0.5, 0.1 * t)
    fe.evict(3)
    fe.run_until_done()
    assert fe.groups[16].stack is not prev
    assert list(fe.versions()) == [1, 1, 1, 2, 1, 1, 1, 1]
    assert fe.health_stats()["events"] == []
    assert all(torch.equal(a, b) for a, b in zip(flatten(prev)[0], snap))


def _failing_repair(gp, *, op="repair"):
    """A ladder that leaves the GP as bad as it found it."""
    v = probe_gp(gp)
    return gp, [ladder.HealthEvent(op=op, rung="refit_clean", before=v,
                                   after=v)]


def test_engine_checkpoint_backstop(tmp_path, monkeypatch):
    """With the ladder exhausted, the serving engine restores its last-good
    checkpoint (saved every ``checkpoint_every`` healthy versions)."""
    X, Y, om = _data(24)
    ck = Checkpointer(str(tmp_path), keep=2)
    eng = GPServeEngine(_port_fit(CFG, X, Y, om), BOUNDS, batch_slots=2,
                        insert_iters=60, checkpointer=ck, checkpoint_every=2)
    eng.insert(X[0] * 0.9, 0.5)
    eng.insert(X[1] * 0.9, 0.25)
    eng.run_until_done()
    ck.wait()
    assert eng.version == 2 and ck.latest_step() == 2
    good = eng.gp
    monkeypatch.setattr(ladder, "repair", _failing_repair)
    eng.insert(X[2] * 0.9, float("nan"))
    q = eng.submit(X[3], kind="mean")
    eng.run_until_done()
    ev = eng.health_stats()["events"]
    assert [e.rung for e in ev] == ["refit_clean", "checkpoint_restore"]
    assert ev[-1].fixed and eng.num_points == 26 and eng.version == 4
    assert torch.equal(eng.gp.u_sy, good.u_sy)
    mu = float(posterior_mean(good, X[3][None], device="cpu")[0])
    assert abs(q.result["mean"] - mu) < 1e-10


def test_fleet_snapshot_then_checkpoint_backstop(tmp_path, monkeypatch):
    """A lane the ladder cannot repair falls back to its pre-round
    snapshot; a lane that was bad before the round (so in the snapshot
    too) to the last-good checkpoint."""
    fe, data = _port_fleet(poison=False, insert_iters=FLEET_ITERS,
                           checkpoint_every=1,
                           checkpointer=Checkpointer(str(tmp_path), keep=1))
    lane1 = fe.tenant_gp(1)
    fe.insert(0, data[0][0][0] * 0.5, 0.3)
    fe.run_until_done()  # a healthy round: the checkpoint
    fe._ckpt.wait()
    saved0 = fe.tenant_gp(0)
    monkeypatch.setattr(ladder, "repair", _failing_repair)
    fe.insert(0, data[0][0][1] * 0.5, float("nan"))
    fe.run_until_done()
    ev = fe.health_stats()["events"]
    assert [e.rung for e in ev] == ["refit_clean", "snapshot_restore"]
    assert ev[-1].fixed and torch.equal(fe.tenant_gp(0).u_sy, saved0.u_sy)
    assert fe.counts()[0] == 11 and fe.versions()[0] == 3
    # tenant 1 poisoned by a replacement (no round checks it), then a round
    fe.set_posterior(1, nan_active_row(lane1, row=ROW))
    fe.insert(1, data[1][0][0] * 0.5, 0.2)
    fe.run_until_done()
    ev = fe.health_stats()["events"][2:]
    assert [e.rung for e in ev] == ["refit_clean", "snapshot_restore",
                                    "checkpoint_restore"]
    assert ev[1].after == NONFINITE and ev[-1].fixed
    assert torch.equal(fe.tenant_gp(1).u_sy, lane1.u_sy)
    assert fe.counts()[1] == 10 and fe.health_stats()["quarantines"] == 2


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_fitted_gp(tmp_path):
    """A capacity-padded kmg GP (hierarchy, health state and all) saved and
    restored: posterior mean and variance bit for bit; the save snapshots
    before its thread runs, so a later in-place write does not reach it."""
    X, Y, om = _data(20, seed=9)
    gp = _port_fit(dataclasses.replace(CFG, precond="kmg"), X, Y, om)
    assert gp.hier is not None and gp.health is not None
    ck = Checkpointer(str(tmp_path), keep=2)
    u_sy = gp.u_sy.clone()
    ck.save(0, gp)
    gp.u_sy.mul_(0.0)  # after the snapshot: must not reach the file
    ck.wait()
    gp.u_sy.copy_(u_sy)
    restored, step = ck.restore(gp)
    assert step == 0 and restored.ops.saphi_factor is not None
    Xq = X[:8]
    for f in (posterior_mean, posterior_var):
        assert torch.equal(f(gp, Xq, device="cpu"),
                           f(restored, Xq, device="cpu"))
    assert torch.equal(restored.u_sy, u_sy)
    assert int(restored.health.verdict) == OK
    assert restored.num_points() == 20 and restored.n == 32
    for s in (1, 2, 3):
        ck.save(s, gp, blocking=True)
    assert ck.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_2", "step_3"]


def test_checkpoint_rejects_structure_mismatch(tmp_path):
    X, Y, om = _data(20, seed=9)
    gp = _port_fit(CFG, X, Y, om)
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(0, gp, blocking=True)
    other = dataclasses.replace(gp, config=dataclasses.replace(gp.config,
                                                               q=1))
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(other)
    with pytest.raises(ValueError, match="leaves on disk"):
        ck.restore({"a": gp.X, "b": gp.Y})
