"""Synthetic test functions of the paper (Sec. 7), numpy only.

The port keeps its own copy of ``repro.data.synthetic``'s samplers so that
it imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = ["schwefel", "rastrigin", "sample_test_function"]


def schwefel(x: np.ndarray) -> np.ndarray:
    """f(x) = 418.9829 - (1/D) sum_d x_d sin(sqrt|x_d|), x in (-500, 500)^D."""
    x = np.atleast_2d(x)
    D = x.shape[-1]
    return 418.9829 - np.sum(x * np.sin(np.sqrt(np.abs(x))), axis=-1) / D


def rastrigin(x: np.ndarray) -> np.ndarray:
    """f(x) = 10 - (1/D) sum_d (x_d^2 - 10 cos(2 pi x_d)), x in (-5.12, 5.12)^D."""
    x = np.atleast_2d(x)
    D = x.shape[-1]
    return 10.0 - np.sum(x**2 - 10.0 * np.cos(2 * np.pi * x), axis=-1) / D


_DOMAINS = {"schwefel": 500.0, "rastrigin": 5.12}
_FUNCS = {"schwefel": schwefel, "rastrigin": rastrigin}


def sample_test_function(name: str, n: int, D: int, seed: int = 0,
                         noise_std: float = 1.0):
    """(X, Y, f, bounds) with X ~ Unif(-l, l)^D and Y = f(X) + N(0, noise)."""
    rng = np.random.default_rng(seed)
    l = _DOMAINS[name]
    X = rng.uniform(-l, l, size=(n, D))
    f = _FUNCS[name]
    Y = f(X) + noise_std * rng.standard_normal(n)
    bounds = np.stack([np.full(D, -l), np.full(D, l)], axis=1)
    return X, Y, f, bounds
