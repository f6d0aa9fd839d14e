"""Bayesian optimization of the 5-D Schwefel function with sparse GP-UCB
through the PyTorch port (the paper's Sec. 6/7.2 end-to-end run; the twin of
``examples/bayesopt_schwefel.py``).

PYTHONPATH=src python examples/bayesopt_schwefel_torch.py [--budget 30]
                                                          [--dim 5]
                                                          [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import GPConfig
from repro_torch.core.bayesopt import BOConfig, bayes_opt_loop
from repro_torch.data import schwefel


def main(argv=None):
    """Run the loop; returns ``bayes_opt_loop``'s ``(gp, X, Y, hist)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=30)
    ap.add_argument("--dim", type=int, default=5)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    D = args.dim
    bounds = np.asarray([[-500.0, 500.0]] * D, np.float64)

    def objective(x):  # maximize -f  (minimize Schwefel)
        return -float(schwefel(np.asarray(x)[None])[0])

    cfg = GPConfig(q=0, solver="pcg", solver_iters=40)
    bo = BOConfig(kind="ucb", beta=2.0, ascent_steps=25, n_starts=24,
                  refit_every=10, hyper_steps=5)
    gp, X, Y, hist = bayes_opt_loop(
        objective, bounds, args.budget, cfg, bo,
        torch.Generator().manual_seed(0), n_init=20,
        omega0=np.full(D, 8.0 / 1000.0), sigma0=1.0, verbose=True,
        device=args.device,
    )
    best_idx = int(torch.argmax(Y))
    print(f"best f = {-hist['best'][-1]:.3f} at x = "
          f"{X[best_idx].cpu().numpy()}")
    print("(global minimum 0 at x_d = 420.9687)")
    return gp, X, Y, hist


if __name__ == "__main__":
    main()
