"""``examples/quickstart_torch.py`` against the JAX package's quickstart, on
the CPU, at the quickstart's own size (Schwefel, n = 4000, D = 10, q = 0,
pcg with 40 iterations, 100 queries).

The port runs the example's ``main(device="cpu")`` (the kernels' plain
versions); the JAX side repeats ``examples/quickstart.py``'s computation
(its default backend, the Pallas kernels in interpret mode here). The mean
and the variance agree within 1e-7 relative, the queries' bar of
``test_torch_gp.py``: each side fits its own factors and runs its own 40
PCG iterations. The JAX side runs on a second thread beside the port's
(both spend their time in native code that releases the interpreter
lock), so the test takes the longer of the two, not their sum.
"""
from __future__ import annotations

import importlib.util
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import GPConfig, fit, posterior_mean, posterior_var
from repro.data import sample_test_function
from torch_port_jax_ref import fresh_jax_caches  # noqa: F401

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "quickstart_torch.py"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _jax_quickstart():
    """``examples/quickstart.py``'s mean and variance."""
    n, D = 4000, 10
    X, Y, _, bounds = sample_test_function("schwefel", n, D, seed=0)
    omega = jnp.asarray(8.0 / (bounds[:, 1] - bounds[:, 0]))
    gp = fit(GPConfig(q=0, solver="pcg", solver_iters=40), jnp.asarray(X),
             jnp.asarray(Y), omega, sigma=1.0)
    Xq = np.random.default_rng(1).uniform(bounds[:, 0], bounds[:, 1], (100, D))
    return (np.asarray(posterior_mean(gp, jnp.asarray(Xq))),
            np.asarray(posterior_var(gp, jnp.asarray(Xq))))


def test_quickstart_twin_matches_jax(capsys):
    spec = importlib.util.spec_from_file_location("quickstart_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with ThreadPoolExecutor(max_workers=1) as pool:
        jax_side = pool.submit(_jax_quickstart)
        mu, var = mod.main(device="cpu")
        want_mu, want_var = jax_side.result()
    line = capsys.readouterr().out
    assert line.startswith("n=4000 D=10  RMSE=") and "mean posterior sd=" \
        in line
    assert mu.shape == var.shape == (100,)
    assert _rel(mu.numpy(), want_mu) < 1e-7
    assert _rel(var.numpy(), want_var) < 1e-7
