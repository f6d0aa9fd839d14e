"""Hold the single-GP paths' outputs of one checkout against another's, bit
for bit, on an NVIDIA GPU.

A change that gives the port a tenant axis must leave every single-GP path
where it was. This script drives, from one checkout's ``src``, the paths
``chip_smoke.py`` drives for one GP (the serving path at n = 30000, D = 10
with pcg "whole" and "on", the default kmg config, both relaxation solvers
"whole" and "on", the likelihood and its gradients, q = 1, 2, 3 on jittered
grids, Bayesian optimisation's acquisition, mean gradient and proposal,
capacity padding, inserts and evicts with pcg, kmg and q = 3, the serving
engine and the streaming BO loop) and records a SHA-256 digest of every
output; ``compare`` says which differ::

    python scripts/single_bits.py run SRC OUT.json
    python scripts/single_bits.py compare A.json B.json

Run ``run`` once per checkout in one call (its kernels are built beside
it, under its own ``build/``), then ``compare``; it exits 1 when any output
differs. ``single_bits_ref.json`` beside this script holds the digests of
the tree before the tenant axis (``run`` on an H100 80GB HBM3, 700 W);
``chip_smoke.py`` holds its checkout's digests to it (:func:`digests`).
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np


def _digest(t) -> str:
    a = np.ascontiguousarray(np.asarray(
        t.detach().cpu() if hasattr(t, "detach") else t, dtype=np.float64))
    return hashlib.sha256(a.tobytes()).hexdigest()[:24]


def _schwefel(n, D, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-500.0, 500.0, (n, D))
    Y = (418.9829 * D - (X * np.sin(np.sqrt(np.abs(X)))).sum(1)) / 100.0
    return X, Y + 0.1 * rng.standard_normal(n)


def _jittered(rng, n, D, spacing=0.1):
    """Shuffled jittered grid per dimension at omega * spacing = 0.4."""
    g = (np.arange(n) + 0.5 + 0.3 * rng.uniform(-1, 1, (D, n))) * spacing
    return np.stack([rng.permutation(c) for c in g], axis=1), n * spacing


def digests(src: str, quiet: bool = False) -> dict:
    """``{output: digest}`` of every single-GP output, driven from the
    checkout ``src``."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    from repro_torch import streaming as st
    from repro_torch.core import (GPConfig, fit, log_likelihood,
                                  mll_gradients, posterior_mean,
                                  posterior_mean_grad, posterior_var)
    from repro_torch.core import bayesopt as bo

    dev = torch.device("cuda")
    rec = {}

    def put(name, *ts):
        for i, t in enumerate(ts):
            rec[f"{name}/{i}"] = _digest(t)
            if not quiet:
                print(f"{name}/{i} {rec[f'{name}/{i}']}", flush=True)

    D, n = 10, 30000
    X, Y = _schwefel(n, D, 0)
    om, sg = np.full(D, 8.0 / 1000.0), 1.0
    rq = np.random.default_rng(100)
    Xq = rq.uniform(-500.0, 500.0, (100, D))
    cfg = GPConfig(q=0, precond="none")
    gp = fit(cfg, X, Y, om, sg)
    put("pcg.fit", gp.u_sy, gp.bY, gp.Gband.data)
    put("pcg.query", posterior_mean(gp, Xq), posterior_var(gp, Xq[:32]))
    put("pcg.learn", log_likelihood(gp, torch.Generator().manual_seed(3)),
        *mll_gradients(gp, torch.Generator().manual_seed(4)))
    put("bo.acq", *bo.acquisition_stats(gp, Xq[:32], 2.0, 1.0, kind="ucb"),
        *bo.acquisition_stats(gp, Xq[:32], 2.0, 1.0, kind="ei"),
        posterior_mean_grad(gp, Xq))
    bounds = np.array([[-500.0, 500.0]] * D)
    put("bo.propose", bo.propose_next(
        gp, bounds, torch.Generator(device=dev).manual_seed(5),
        bo.BOConfig(n_starts=8, ascent_steps=5, incremental=False,
                    use_engine=False), float(Y.max())))
    for solver in ("pcg", "gauss_seidel", "jacobi"):
        for fused in ("whole", "on") if solver != "pcg" else ("on",):
            g = fit(GPConfig(q=0, solver=solver, solver_iters=40,
                             precond="none", fused=fused), X, Y, om, sg)
            put(f"{solver}.{fused}", g.u_sy, posterior_mean(g, Xq),
                posterior_var(g, Xq[:32]))
    gk = fit(GPConfig(q=0), X, Y, om, sg)
    put("kmg", gk.u_sy, posterior_mean(gk, Xq), posterior_var(gk, Xq[:32]))
    # streaming: padded fit, 4 inserts + 4 evicts (pcg), 2 + 2 (kmg)
    rs = np.random.default_rng(11)
    Xn = rs.uniform(-500.0, 500.0, (4, D))
    Yn = rs.standard_normal(4)
    for tag, scfg, k in (("pcg", cfg, 4), ("kmg", GPConfig(q=0), 2)):
        g = fit(scfg, X, Y, om, sg, capacity=32768)
        put(f"stream.{tag}.padded", g.u_sy, g.bY)
        c = n
        for i in range(k):
            g = st.insert(g, Xn[i], Yn[i], count=c)
            c += 1
        for _ in range(k):
            g = st.evict(g, count=c)
            c -= 1
        put(f"stream.{tag}", g.u_sy, g.Gband.data, posterior_mean(g, Xq),
            posterior_var(g, Xq[:32]))
    eng = st.GPServeEngine(gp, bounds, batch_slots=8, capacity=32768)
    qs = [eng.submit(x, kind="acq") for x in Xq[:6]]
    qs.append(eng.submit(Xq[6], kind="ascend", steps=3))
    eng.insert(Xn[0], Yn[0])
    qs.append(eng.submit(Xq[7], kind="var"))
    eng.run_until_done()
    put("engine", np.array([[q.result[k] for k in ("mean", "var", "value")]
                            for q in qs]))
    del gp, gk, eng, g
    # q = 1, 2, 3 on jittered grids (omega = 4)
    rj = np.random.default_rng(2)
    Xj, span = _jittered(rj, 4000, D)
    Yj = np.sin(Xj * 6.0 * np.pi / span).sum(1) + 0.1 * rj.standard_normal(
        4000)
    Xqj = rj.uniform(0.0, span, (40, D))
    for q, fused in ((1, "auto"), (2, "auto"), (3, "off"), (3, "whole"),
                     (3, "on")):
        g = fit(GPConfig(q=q, solver_iters=40, precond="none", fused=fused),
                Xj, Yj, np.full(D, 4.0), 1.0)
        put(f"q{q}.{fused}", g.u_sy, posterior_mean(g, Xqj),
            posterior_var(g, Xqj[:16]))
    g = fit(GPConfig(q=3, solver="gauss_seidel", solver_iters=40,
                     precond="none"), Xj, Yj, np.full(D, 4.0), 1.0)
    put("q3.gauss_seidel", g.u_sy, posterior_var(g, Xqj[:16]))
    g = fit(GPConfig(q=3, solver_iters=40, precond="none"), Xj, Yj,
            np.full(D, 4.0), 1.0, capacity=4096)
    c = 4000
    for i in range(2):
        g = st.insert(g, Xqj[i], float(Yj[i]), count=c)
        c += 1
    g = st.evict(g, count=c)
    put("stream.q3", g.u_sy, g.Gband.data, posterior_var(g, Xqj[:16]))
    # the streaming BO loop (the default BOConfig), small
    f = (lambda x: float(-(x * np.sin(np.sqrt(np.abs(x)))).sum() / 100.0))
    res = bo.bayes_opt_loop(f, bounds[:4], 2, GPConfig(q=0, precond="none"),
                            bo.BOConfig(n_starts=8, ascent_steps=4,
                                        refit_every=0),
                            torch.Generator(device=dev).manual_seed(9),
                            n_init=500)
    put("bo.loop", res[1], res[2])
    return rec


def run(src: str, out: str) -> None:
    Path(out).write_text(json.dumps(digests(src), indent=1))


def compare(a: str, b: str) -> int:
    A, B = (json.loads(Path(p).read_text()) for p in (a, b))
    bad = sorted(k for k in A.keys() | B.keys() if A.get(k) != B.get(k))
    for k in bad:
        print(f"differs: {k} {A.get(k)} {B.get(k)}")
    print(f"{len(A)} outputs, {len(bad)} differ: all bitwise "
          f"{not bad and len(A) == len(B)}")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
