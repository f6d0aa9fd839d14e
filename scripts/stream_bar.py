"""The JAX package's own insert-vs-fresh-fit gaps, on the CPU.

    JAX_PLATFORMS=cpu python scripts/stream_bar.py pcg|kmg

Fits the Schwefel draw of ``chip_smoke.py``'s card-vs-CPU size (n = 4000,
D = 10, omega = 8 / span, sigma = 1) in capacity 4096 with the reference
(``repro``, its "jax" backend), inserts 32 extra points with ``count=`` at
the default warm iterations (pcg 40 -> 10, kmg 50 -> 12), and prints the
max |mean| (100 queries) and |variance| (32 queries) gaps against a fresh
fit of the grown data, before and after the drift sentinel
(``maybe_resync``). ``chip_smoke.py``'s streaming phase holds the port's
gaps on the card at n = 30000 against these. Imports the JAX package: run
it on a CPU, never on the card's machine.
"""
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)
sys.path.insert(0, "src")
from repro import streaming as S  # noqa: E402
from repro.core import GPConfig, fit, posterior_mean, posterior_var  # noqa
from repro_torch.data import sample_test_function  # noqa: E402


def main(which: str) -> None:
    n, D, m = 4000, 10, 32
    X, Y, f, bounds = sample_test_function("schwefel", n, D, seed=0)
    rng = np.random.default_rng(11)
    Xn = rng.uniform(bounds[:, 0], bounds[:, 1], (m, D))
    Yn = f(Xn) + rng.standard_normal(m)
    om = jnp.asarray(8.0 / (bounds[:, 1] - bounds[:, 0]))
    Xq = jnp.asarray(np.random.default_rng(100).uniform(
        bounds[:, 0], bounds[:, 1], (100, D)))
    cfg = (GPConfig(q=0, solver_iters=40, precond="none", backend="jax")
           if which == "pcg" else GPConfig(q=0, precond="kmg", backend="jax"))
    t0 = time.time()
    g = fit(cfg, jnp.asarray(X), jnp.asarray(Y), om, 1.0, capacity=4096)
    for i in range(m):
        g = S.insert(g, jnp.asarray(Xn[i]), Yn[i], count=n + i)
    ref = fit(cfg, jnp.asarray(np.concatenate([X, Xn])),
              jnp.asarray(np.concatenate([Y, Yn])), om, 1.0)
    vr = np.asarray(posterior_var(ref, Xq[:32]))
    out = dict(which=which, iters=max(8, cfg.solver_iters // 4),
               drift=float(g.health.drift),
               mean_gap=float(np.abs(np.asarray(posterior_mean(g, Xq))
                                     - np.asarray(posterior_mean(ref, Xq)))
                              .max()),
               var_gap=float(np.abs(np.asarray(posterior_var(g, Xq[:32]))
                                    - vr).max()))
    g, did = S.maybe_resync(g)
    out.update(resynced=bool(did), var_gap_after_sentinel=float(np.abs(
        np.asarray(posterior_var(g, Xq[:32])) - vr).max()))
    g = S.resync_gband(g)
    out.update(var_gap_after_resync=float(np.abs(
        np.asarray(posterior_var(g, Xq[:32])) - vr).max()),
        seconds=time.time() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
