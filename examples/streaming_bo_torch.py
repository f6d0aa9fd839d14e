"""Streaming Bayesian optimisation through the PyTorch port's serving engine
(the twin of ``examples/streaming_bo.py``).

PYTHONPATH=src python examples/streaming_bo_torch.py [--rounds 8]
                                                     [--device cpu]

A ``GPServeEngine`` holds the posterior; each round interleaves a batch of
concurrent acquisition-ascent requests with posterior-mean probe queries
(served by the same batched ticks), evaluates the winning proposal, and
streams the new observation in with an in-place O(q)-window ``insert``
instead of a refit. ``window=64`` bounds memory: past 64 points each insert
first evicts the oldest, so the capacity stays pinned. Per-round propose
and insert times are printed; each probe query carries the version of the
posterior that served it. Runs on CUDA unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import GPConfig, fit
from repro_torch.core.bayesopt import BOConfig
from repro_torch.streaming import GPServeEngine, propose_via_engine


def main(rounds: int = 8, dim: int = 3, n_init: int = 24, device=None,
         window: int = 64):
    """Run the loop; returns ``(engine, history)``, the history one dict a
    round: the proposal, its value, the probe queries and the engine's
    version when they were submitted."""
    D = dim
    bounds = np.array([[-2.0, 2.0]] * D)

    def objective(x):  # additive, max 1.0 per dim at x = 0
        return float(np.sum(np.cos(x) * np.exp(-0.2 * x ** 2)))

    rng = np.random.default_rng(0)
    X = rng.uniform(-2.0, 2.0, (n_init, D))
    Y = np.array([objective(x) for x in X])
    cfg = GPConfig(q=0, solver="pcg", solver_iters=40)
    bo = BOConfig(kind="ucb", beta=2.0, ascent_steps=15, n_starts=12)
    gp = fit(cfg, X, Y, np.ones(D), 0.1, device=device)
    engine = GPServeEngine(gp, bounds, batch_slots=bo.n_starts, kind=bo.kind,
                           beta=bo.beta, lr=bo.lr, window=window)
    gen = torch.Generator().manual_seed(0)
    probes = rng.uniform(-2.0, 2.0, (4, D))
    history = []
    for t in range(rounds):
        # concurrent posterior probes ride along with the ascent batch
        version = engine.version
        probe_qs = [engine.submit(p, kind="mean") for p in probes]
        t0 = time.time()
        x_new = propose_via_engine(engine, gen, bo, engine.best_y)
        t_prop = time.time() - t0
        y_new = objective(x_new)
        t0 = time.time()
        engine.insert(x_new, y_new)  # staged at the version fence
        engine.run_until_done()  # drains the fence; applies the insert
        t_ins = time.time() - t0
        vers = sorted({q.result["version"] for q in probe_qs})
        history.append(dict(x=x_new, y=y_new, probes=probe_qs,
                            version=version))
        print(f"round {t + 1:2d}  y={y_new:+.4f}  best={engine.best_y:+.4f}  "
              f"n={engine.num_points}/{engine.capacity}  version="
              f"{engine.version}  propose={t_prop * 1e3:7.1f}ms  insert="
              f"{t_ins * 1e3:7.1f}ms  probe_versions={vers}")
    print(f"done: best {engine.best_y:+.4f} (optimum {float(D):+.4f}) after "
          f"{engine.num_points} observations")
    return engine, history


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--n-init", type=int, default=24)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(a.rounds, a.dim, a.n_init, a.device, a.window)
