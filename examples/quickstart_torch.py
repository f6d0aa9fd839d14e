"""Quickstart of the PyTorch port: sparse additive-GP regression with
Kernel Packets on the GPU (the twin of ``examples/quickstart.py``).

PYTHONPATH=src python examples/quickstart_torch.py

Runs on CUDA and raises without a GPU; ``main(device="cpu")`` runs the
same computation on the CPU through the kernels' plain versions. At
n = 4000 (< 4096) the default preconditioner is "none", so every solve is
one launch of the whole-solve PCG kernel.
"""
import numpy as np
import torch

from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
from repro_torch.data import sample_test_function


def main(device=None):
    """Fit, then the posterior mean and variance at 100 queries; prints the
    JAX quickstart's line and returns (mean, variance)."""
    n, D = 4000, 10
    X, Y, f, bounds = sample_test_function("schwefel", n, D, seed=0)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])

    cfg = GPConfig(q=0, solver="pcg", solver_iters=40)  # Matérn-1/2
    gp = fit(cfg, X, Y, omega, sigma=1.0, device=device)

    Xq = np.random.default_rng(1).uniform(bounds[:, 0], bounds[:, 1], (100, D))
    mu = posterior_mean(gp, Xq, device=device)  # O(log n) per query
    var = posterior_var(gp, Xq, device=device)  # one batched Mhat solve
    mu_np = mu.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mu_np - f(Xq)) ** 2)))
    print(f"n={n} D={D}  RMSE={rmse:.4f}  mean posterior sd="
          f"{float(torch.sqrt(var).mean()):.4f}")
    assert np.isfinite(rmse)
    return mu, var


if __name__ == "__main__":
    main()
