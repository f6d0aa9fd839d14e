"""Synthetic data sources, numpy only.

* Paper test functions (Sec. 7): Schwefel and Rastrigin ("Rastr"), with the
  paper's 1/D normalization, plus uniform samplers with N(0,1) noise.
* Deterministic synthetic token streams for LM training (zipfian unigrams +
  induction-head bigram structure so the loss actually decreases).

The port keeps its own copy of ``repro.data.synthetic`` so that it imports
nothing of the JAX package; the same numpy generator calls give the same
values.
"""
from __future__ import annotations

import numpy as np

__all__ = ["schwefel", "rastrigin", "sample_test_function", "token_stream"]


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


def token_stream(vocab: int, seq_len: int, batch: int, seed: int):
    """Infinite deterministic batch generator of (tokens, labels).

    Zipf unigrams + a planted bigram rule (token t -> (t * 31 + 7) % vocab with
    p=0.5) gives a learnable next-token structure.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq_len), p=probs)
        follow = (toks * 31 + 7) % vocab
        use = rng.random((batch, seq_len)) < 0.5
        toks[:, 1:] = np.where(use[:, 1:], follow[:, :-1], toks[:, 1:])
        labels = np.concatenate(
            [toks[:, 1:], np.full((batch, 1), -1, toks.dtype)], axis=1
        )
        yield toks.astype(np.int32), labels.astype(np.int32)
