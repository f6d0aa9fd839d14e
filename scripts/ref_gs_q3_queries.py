"""The JAX package's q = 3 Gauss-Seidel "whole" posterior variance by
query count, on the port tests' q = 3 data (``tests/torch_port_jax_ref.
_data(37, 140)``, sigma 0.5, omega 4, 30 sweeps), beside its unfused
loop's: the largest |variance| at 1, 2, 4, 5, 8, 16, 32 and 40 queries.
CPU only (the JAX package, Pallas in interpret mode).

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python scripts/ref_gs_q3_queries.py
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core import GPConfig, fit, posterior_var
from torch_port_jax_ref import SIGMA, _data

jax.config.update("jax_enable_x64", True)


def main():
    X, Y, Xq = _data(37, 140)
    kw = dict(q=3, solver="gauss_seidel", solver_iters=30, precond="none")
    gps = {f: fit(GPConfig(backend=b, fused=f, **kw), jnp.asarray(X),
                  jnp.asarray(Y), jnp.full(X.shape[1], 4.0), SIGMA)
           for f, b in (("whole", "pallas"), ("off", "jax"))}
    for m in (1, 2, 4, 5, 8, 16, 32, 40):
        out = {f: float(np.abs(np.asarray(posterior_var(
            g, jnp.asarray(Xq[:m])))).max()) for f, g in gps.items()}
        print(f"{m} queries: max |var| whole {out['whole']:.6e}, off "
              f"{out['off']:.6e}", flush=True)


if __name__ == "__main__":
    main()
