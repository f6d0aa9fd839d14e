"""Dense O(n^3) oracle for additive Matérn GPs (paper Eqs. (1)-(2)).

Counterpart of ``repro.core.exact``: the correctness oracle of the sparse
likelihood and gradients, and the "Full GP" baseline. Plain PyTorch on
whatever device its inputs live on; the gradients come from
``torch.autograd`` through the dense marginal likelihood.
"""
from __future__ import annotations

import math

import torch

from . import matern as mk

__all__ = ["additive_gram", "posterior_mean_var", "log_marginal_likelihood",
           "mll_grads"]


def _f64(x, like=None):
    device = None if like is None else like.device
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def additive_gram(q: int, omega, X, X2=None):
    """K_sum[i, j] = sum_d k_d(X[i, d], X2[j, d] | omega_d)."""
    if X2 is None:
        X2 = X
    k = mk.matern(q, omega[None, None, :], X[:, None, :], X2[None, :, :])
    return k.sum(dim=-1)


def _cov(q, omega, sigma, X):
    n = X.shape[0]
    return additive_gram(q, omega, X) + sigma ** 2 * torch.eye(
        n, dtype=X.dtype, device=X.device)


def posterior_mean_var(q: int, omega, sigma, X, Y, Xq):
    """Dense posterior mean/variance at query points Xq (m, D)."""
    X = _f64(X)
    Y, Xq, omega, sigma = (_f64(a, X) for a in (Y, Xq, omega, sigma))
    L = torch.linalg.cholesky(_cov(q, omega, sigma, X))
    kq = additive_gram(q, omega, X, Xq)  # (n, m)
    alpha = torch.cholesky_solve(Y[:, None], L)[:, 0]
    mean = kq.T @ alpha
    v = torch.cholesky_solve(kq, L)
    prior = torch.full((Xq.shape[0],), float(X.shape[1]), dtype=X.dtype,
                       device=X.device)  # sum_d k_d(x, x) = D
    return mean, prior - (kq * v).sum(dim=0)


def log_marginal_likelihood(q: int, omega, sigma, X, Y):
    """Exact MLL: -0.5 [ Y^T Sigma^{-1} Y + log|Sigma| + n log 2pi ]."""
    X = _f64(X)
    Y, omega, sigma = (_f64(a, X) for a in (Y, omega, sigma))
    n = X.shape[0]
    L = torch.linalg.cholesky(_cov(q, omega, sigma, X))
    alpha = torch.cholesky_solve(Y[:, None], L)[:, 0]
    logdet = 2.0 * torch.log(torch.abs(torch.diagonal(L))).sum()
    return -0.5 * (Y @ alpha + logdet + n * math.log(2.0 * math.pi))


def mll_grads(q: int, omega, sigma, X, Y):
    """(d MLL / d omega, d MLL / d sigma) by autodiff through the dense MLL."""
    X = _f64(X)
    om = _f64(omega, X).detach().clone().requires_grad_(True)
    sg = _f64(sigma, X).detach().clone().requires_grad_(True)
    ll = log_marginal_likelihood(q, om, sg, X, _f64(Y, X))
    g_om, g_sg = torch.autograd.grad(ll, (om, sg))
    return g_om, g_sg
