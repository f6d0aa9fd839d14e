"""The port's ``GPFleetEngine`` on the CPU, against per-tenant
``GPServeEngine`` s.

A mixed stream (mean / var / acq / ascend queries, inserts and an evict,
fenced per tenant) through one fleet engine over three tenants, with a
sliding window on one and a capacity tier that two of them outgrow, equals
the same stream through three standalone port engines bit for bit:
results, versions, counts and capacity tiers, and every tenant's final
posterior. The engine takes a checkpointer, and configs a fleet once
refused serve.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import GPConfig, fit, with_capacity
from repro_torch.core import fleet as fl
from repro_torch.streaming import GPFleetEngine, GPServeEngine
from torch_port_inputs import OMEGA, points

torch.set_num_threads(2)

T, D, CAP, ITERS = 3, 2, 8, 24
CFG = GPConfig(q=1, solver="pcg", solver_iters=ITERS)
BOUNDS = np.array([[0.0, 4.0]] * D)
WINDOWS = [None, 9, None]


def _gps():
    rng = np.random.default_rng(0)
    gps = []
    for t in range(T):
        X = points(rng, 6 + t, D)
        Y = np.cos(2 * X).sum(-1)
        gps.append(fit(CFG, X, Y, np.full(D, OMEGA), 0.25, device="cpu"))
    return gps


def _stream():
    rng = np.random.default_rng(1)
    ops = []
    for r in range(4):
        for t in range(T):
            ops.append(("q", t, rng.uniform(0.0, 4.0, D),
                        ("acq", "mean", "ascend", "var")[(r + t) % 4]))
            if (r + t) % 2 == 0:
                ops.append(("i", t, rng.uniform(0.0, 4.0, D),
                            float(rng.standard_normal())))
            if r == 3 and t == 2:
                ops.append(("e", t))
    return ops


def test_fleet_engine_matches_per_tenant_engines():
    gps = _gps()
    kw = dict(batch_slots=4, capacity=CAP, insert_iters=ITERS)
    fe = GPFleetEngine(gps, BOUNDS, window=WINDOWS, **kw)
    ses = [GPServeEngine(g, BOUNDS, window=w, **kw)
           for g, w in zip(gps, WINDOWS)]
    fq, sq = [], []
    for i, op in enumerate(_stream()):
        if op[0] == "q":
            fq.append(fe.submit(op[1], op[2], kind=op[3], steps=2))
            sq.append(ses[op[1]].submit(op[2], kind=op[3], steps=2))
        elif op[0] == "i":
            fe.insert(op[1], op[2], op[3])
            ses[op[1]].insert(op[2], op[3])
        else:
            fe.evict(op[1])
            ses[op[1]].evict()
        if i % 3 == 2:
            fe.step()
            for s in ses:
                s.step()
    fe.run_until_done()
    for s in ses:
        s.run_until_done()
    for a, b in zip(fq, sq):
        assert a.done and b.done
        for k in ("mean", "var", "value", "version"):
            assert a.result[k] == b.result[k], k
        assert np.array_equal(a.result["grad"], b.result["grad"])
        assert np.array_equal(a.result["x"], b.result["x"])
    assert list(fe.counts()) == [s.num_points for s in ses]
    assert list(fe.versions()) == [s.version for s in ses]
    assert list(fe.capacities()) == [s.capacity for s in ses]
    assert sorted(fe.groups) == [8, 16]  # two tenants outgrew the tier
    for t in range(T):
        g, s = fe.tenant_gp(t), ses[t].gp
        for a, b in ((g.u_sy, s.u_sy), (g.bY, s.bY), (g.X, s.X),
                     (g.Gband.data, s.Gband.data), (g.n_active, s.n_active)):
            assert torch.equal(a, b), t
    assert fe.health_stats() == {"repairs": 0, "resyncs": 0,
                                 "quarantines": 0, "events": []}


def test_fleet_engine_refuses_unported_settings(tmp_path):
    gps = _gps()
    # checkpointer=, refused before the health ladder was ported, keeps the
    # group's stack after every checkpoint_every healthy rounds
    ck = Checkpointer(str(tmp_path))
    fe = GPFleetEngine(gps, BOUNDS, capacity=CAP, insert_iters=ITERS,
                       checkpointer=ck, checkpoint_every=1)
    fe.insert(0, np.full(D, 1.5), 0.5)
    fe.run_until_done()
    ck.wait()
    assert fe.health_stats()["repairs"] == 0 and ck.latest_step() == 1
    stack = fe.groups[CAP].stack
    assert torch.equal(ck.restore(stack)[0].u_sy, stack.u_sy)
    # a relaxation solver, refused before the fleet took it, now serves:
    # the engine's lanes and a one-tenant stack are the GP, bit for bit
    X = points(np.random.default_rng(3), 8, D)
    g = fit(GPConfig(q=1, solver="jacobi"), X, np.cos(X).sum(-1),
            np.full(D, OMEGA), 0.25, device="cpu")
    eng = GPFleetEngine([g, g], BOUNDS)
    want = with_capacity(g, eng.capacities()[0])
    for t in range(2):
        assert torch.equal(eng.tenant_gp(t).u_sy, want.u_sy)
    assert torch.equal(fl.stack_gps([g]).tenant(0).u_sy, g.u_sy)
