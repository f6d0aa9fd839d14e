"""Bayesian optimisation with sparse additive-GP posteriors (paper Sec. 6).

Counterpart of ``repro.core.bayesopt``. The acquisition functions (GP-UCB,
EI) and their gradients come from the sparse KP windows: the mean and its
gradient are O(1) gathers per query given the fitted caches, and the
variance term costs one batched Mhat solve per query batch (the
"operator" path, through the same kernels as ``posterior_var``: Phi's solve,
the backfitting solve and, for the gradient, one Phi^T solve) or O(1) with
the dense ``M-tilde`` cache (the paper's "given the posterior" path, O(n^2)
memory, small n only). The gradient formulas follow Eq. (29)-(30), with the
calculus-derived factor 2 on the band term, as in the reference.

Devices and draws: queries follow ``posterior_mean``'s device rule (CUDA
unless the caller passes ``device="cpu"``; the GP must live there). Where
the reference takes a ``jax.random`` key, :func:`propose_next` and
:func:`bayes_opt_loop` take a ``torch.Generator``, and every uniform draw
(the initial design, the ascent's starts) goes through
:func:`uniform_rows`, the one draw function. The objective ``f`` of
:func:`bayes_opt_loop` is a black box on the host: it takes one point as a
float64 numpy array (D,) and returns a number.

:func:`bayes_opt_loop` runs both of the reference's loops: the streaming
one (the default ``BOConfig()``: each round's point is inserted in place,
``repro_torch.streaming``, and with ``use_engine`` the ascent is served by
the slot-batched ``GPServeEngine``) and the refit one
(``BOConfig(incremental=False, use_engine=False)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from .additive_gp import (AdditiveGP, GPConfig, _as_f64, _ein, _g_entries,
                          _per_query, _phi_windows, _query, _var_chunks,
                          _window_gather, fit, fit_hyperparams, prior_var,
                          resolve_device)
from ..masking import mask_rows
from .backfitting import solve_mhat
from .banded import solve, transpose

__all__ = ["BOConfig", "acquisition_value_and_grad", "acquisition_stats",
           "ascent_step", "propose_next", "bayes_opt_loop", "LocalAcqCache",
           "build_local_cache", "acq_local", "uniform_rows"]


@dataclasses.dataclass(frozen=True)
class BOConfig:
    """The reference's fields and defaults."""

    kind: str = "ucb"  # "ucb" | "ei"
    beta: float = 2.0
    ascent_steps: int = 40
    lr: float = 0.05
    n_starts: int = 32
    refit_every: int = 10  # hyperparameter re-learning cadence (0 = never)
    hyper_steps: int = 10
    hyper_lr: float = 0.05
    incremental: bool = True
    use_engine: bool = True
    insert_iters: int = 0  # warm backfitting iters per insert (0 = auto)


def uniform_rows(generator: torch.Generator, shape: tuple[int, ...],
                 dtype=torch.float64, device=None) -> torch.Tensor:
    """Uniform [0, 1) draw of ``shape`` from ``generator`` (on its device),
    moved to ``device``: the initial design and the ascent's starts."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u.to(device=device)


def _acq_core(gp: AdditiveGP, Xq, beta, best_y, kind: str):
    """Shared acquisition math: (value, grad, mean, variance) for Xq (m, D)
    on the GP's device; on a fleet's stack Xq (T, m, D), ``beta`` and
    ``best_y`` broadcasting against (T, m)."""
    m = Xq.shape[-2]
    rows, vals, _ = _phi_windows(gp, Xq)  # (D, m, W)
    _, dvals, _ = _phi_windows(gp, Xq, grad=True)  # same rows

    # mean + mean gradient (sparse gathers on bY)
    bwin = _window_gather(gp.bY, rows)
    mu = (vals * bwin).sum(dim=(-3, -1))
    dmu = (dvals * bwin).sum(dim=-1).transpose(-1, -2)  # (m, D)

    # variance pieces: the band term, and w^T Mhat^{-1} w with, for the
    # gradient, y = Phi^{-T} P z gathered over each query's window
    g_phi = torch.einsum(_ein(gp, "dmab,dmb->dma"), _g_entries(gp, rows),
                         vals)
    term2 = torch.einsum(_ein(gp, "dma,dma->m"), vals, g_phi)
    c = gp.config
    term3, ywin = [], []
    for rc, w, z in _var_chunks(gp, rows, vals):
        term3.append((w * z).sum(dim=(-3, -2)))
        y_s = solve(transpose(gp.ops.Phi), gp.ops.to_sorted(z),
                    pivot=c.pivot, backend=c.backend, alg=c.solve_alg)
        # ywin[d, j, a] = y_s[d, rc[d, j, a], j]
        ywin.append(torch.gather(y_s, -2, rc.transpose(-1, -2))
                    .transpose(-1, -2))
        del w, z, y_s
    term3 = torch.cat(term3, dim=-1)[..., :m]
    ywin = torch.cat(ywin, dim=-2)[..., :m, :]
    var = torch.clamp(_per_query(prior_var(gp, Xq.dtype)) - term2 + term3,
                      min=1e-12)
    # dvar/dx_d = -2 dphi^T (G phi) + 2 dphi^T Phi^{-T} z
    dvar = (-2.0 * torch.einsum(_ein(gp, "dma,dma->dm"), dvals, g_phi)
            + 2.0 * torch.einsum(_ein(gp, "dma,dma->dm"), dvals, ywin)
            ).transpose(-1, -2)  # (m, D)
    val, grad = _acquire(kind, mu, dmu, var, dvar, beta, best_y)
    return val, grad, mu, var


def _acquire(kind: str, mu, dmu, var, dvar, beta, best_y):
    """(A, grad A) from the mean, the variance and their gradients; the
    variance's gradient ``dvar`` has the mean's layout ``dmu`` (a trailing
    axis over D)."""
    sqrt_s = torch.sqrt(var)
    if kind == "ucb":
        return (mu + beta * sqrt_s,
                dmu + (beta / (2.0 * sqrt_s))[..., None] * dvar)
    if kind == "ei":
        imp = mu - best_y
        zz = imp / sqrt_s
        pdf = torch.exp(-0.5 * zz ** 2) / math.sqrt(2.0 * math.pi)
        cdf = 0.5 * (1.0 + torch.special.erf(zz / math.sqrt(2.0)))
        val = imp * cdf + sqrt_s * pdf
        return val, (cdf[..., None] * dmu
                     + (pdf / (2.0 * sqrt_s))[..., None] * dvar)
    raise ValueError(kind)


def acquisition_value_and_grad(gp: AdditiveGP, Xq, beta, best_y,
                               kind: str = "ucb", device=None):
    """(A(x*), grad A(x*)) for a batch Xq (m, D) — Eq. (28)-(29)."""
    val, grad, _, _ = _acq_core(gp, _query(gp, Xq, device), beta, best_y,
                                kind)
    return val, grad


def acquisition_stats(gp: AdditiveGP, Xq, beta, best_y, kind: str = "ucb",
                      device=None):
    """(value, grad, mean, variance) in one pass."""
    return _acq_core(gp, _query(gp, Xq, device), beta, best_y, kind)


def ascent_step(X, grad, lo, hi, step_len):
    """One normalized projected-gradient ascent update (X, grad (..., m,
    D))."""
    gn = torch.linalg.norm(grad, dim=-1, keepdim=True)
    return torch.clamp(X + step_len * grad / torch.clamp(gn, min=1e-12),
                       min=lo, max=hi)


def propose_next(gp: AdditiveGP, bounds, generator: torch.Generator,
                 cfg: BOConfig, best_y, device=None):
    """Multi-start projected gradient ascent on the acquisition (Sec. 6):
    ``cfg.n_starts`` starts drawn through :func:`uniform_rows` in
    ``bounds`` (D, 2), ``cfg.ascent_steps`` steps; returns the best point
    (D,) on the GP's device."""
    bounds = _query(gp, bounds, device)
    lo, hi = bounds[:, 0], bounds[:, 1]
    span = hi - lo
    starts = uniform_rows(generator, (cfg.n_starts, gp.D), dtype=bounds.dtype,
                          device=gp.device)
    X = lo + starts * span
    for _ in range(cfg.ascent_steps):
        _, g, _, _ = _acq_core(gp, X, cfg.beta, best_y, cfg.kind)
        X = ascent_step(X, g, lo, hi, cfg.lr * span)
    val, _, _, _ = _acq_core(gp, X, cfg.beta, best_y, cfg.kind)
    return X[torch.argmax(val)]


def bayes_opt_loop(f: Callable[[np.ndarray], float], bounds, budget: int,
                   gp_config: GPConfig, bo_config: BOConfig,
                   generator: torch.Generator, n_init: int = 20,
                   omega0=None, sigma0: float = 0.5, verbose: bool = False,
                   device=None):
    """Algorithm 1 with sparse posteriors; maximizes ``f``. Returns
    ``(gp, X, Y, hist)``.

    The streaming loop (Sec. 6, the default): between hyperparameter refits
    the posterior grows by ``streaming.insert`` (O(q)-window factor updates
    and a warm-started solve) instead of a refit, and with ``use_engine``
    the ascent is served by the slot-batched ``GPServeEngine`` (the insert
    goes behind its fence). ``incremental=False`` refits every round. Every
    ``refit_every`` rounds (after the first) the hyperparameters are
    re-learned from the previously learned ``(omega, sigma)``
    (``fit_hyperparams``, its probes drawn from ``generator``). ``hist``
    holds numpy / Python copies of each round's point, value, best value,
    omega and sigma.
    """
    device = resolve_device(device)
    bounds = _as_f64(bounds, device)
    D = bounds.shape[0]
    lo, hi = bounds[:, 0], bounds[:, 1]
    X = lo + uniform_rows(generator, (n_init, D), dtype=bounds.dtype,
                          device=device) * (hi - lo)

    Y = torch.tensor([float(f(x)) for x in X.cpu().numpy()],
                     dtype=bounds.dtype, device=device)
    omega = (4.0 / (hi - lo) if omega0 is None
             else _as_f64(omega0, device))
    sigma = torch.tensor(sigma0, dtype=bounds.dtype, device=device)
    hist = {"x": [], "y": [], "best": [], "omega": [], "sigma": []}
    gp = fit(gp_config, X, Y, omega, sigma, device=device)
    engine = None
    if bo_config.use_engine or bo_config.incremental:
        from ..streaming import GPServeEngine, propose_via_engine
        from ..streaming import insert as stream_insert
    if bo_config.use_engine:
        engine = GPServeEngine(gp, bounds.cpu().numpy(),
                               batch_slots=bo_config.n_starts,
                               kind=bo_config.kind, beta=bo_config.beta,
                               lr=bo_config.lr,
                               insert_iters=bo_config.insert_iters or None)
    for t in range(budget):
        if bo_config.refit_every and t % bo_config.refit_every == 0 and t > 0:
            gp, (omega, sigma), _ = fit_hyperparams(
                gp_config, X, Y, omega, sigma, generator,
                steps=bo_config.hyper_steps, lr=bo_config.hyper_lr,
                device=device)
            if engine is not None:
                engine.set_posterior(gp)
        best_y = torch.max(Y)
        if engine is not None:
            x_new = torch.as_tensor(propose_via_engine(
                engine, generator, bo_config, best_y), device=device)
        else:
            x_new = propose_next(gp, bounds, generator, bo_config, best_y,
                                 device=device)
        y_new = float(f(x_new.cpu().numpy()))
        X = torch.cat([X, x_new[None]], dim=0)
        Y = torch.cat([Y, torch.tensor([y_new], dtype=Y.dtype,
                                       device=device)])
        if bo_config.incremental:
            if engine is not None:
                # the insert behind the engine's fence, applied by a tick
                engine.insert(x_new.cpu().numpy(), y_new)
                engine.step()
                gp = engine.gp
            else:
                gp = stream_insert(gp, x_new, y_new,
                                   iters=bo_config.insert_iters or None)
        else:
            gp = fit(gp_config, X, Y, omega, sigma, device=device)
            if engine is not None:
                engine.set_posterior(gp)
        hist["x"].append(x_new.cpu().numpy())
        hist["y"].append(y_new)
        hist["best"].append(float(torch.max(Y)))
        hist["omega"].append(omega.cpu().numpy())
        hist["sigma"].append(float(sigma))
        if verbose and (t + 1) % 10 == 0:
            print(f"  BO iter {t+1}/{budget} best={hist['best'][-1]:.4f}")
    return gp, X, Y, hist

# ---------------------------------------------------------------------------
# The paper's O(1)-per-evaluation path: the dense M-tilde cache ("given the
# posterior")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalAcqCache:
    """Dense M~ = Phi^{-T} P^T Mhat^{-1} P Phi^{-1}, laid out (D, n, D, n)."""

    M_tilde: torch.Tensor


def build_local_cache(gp: AdditiveGP) -> LocalAcqCache:
    """Operation 2 of Sec. 5.1.1: O(n^2) time and memory, small n only.

    ``M_tilde[d_row, i_row, d_col, i_col]`` in sorted indices on both sides,
    float64: 8 D^2 n^2 bytes (52 MB at n = 512, D = 5), and D solves of n
    right-hand sides each (Phi, Mhat, Phi^T; the Mhat solve of more than
    ``MAX_B`` = 256 columns runs in column chunks). ``Mhat`` is SPD, so
    ``M~`` equals its ``(d, i) <-> (e, j)`` transpose. Under capacity
    padding the e_i right-hand sides are masked to the active prefix: the
    tail rows and columns are zeros and the active block is the unpadded
    cache's.
    """
    D, n = gp.D, gp.n
    c = gp.config
    eye = mask_rows(torch.eye(n, dtype=gp.Y.dtype, device=gp.device),
                    gp.n_active, axis=0)
    cols = []
    for d in range(D):
        rhs = torch.zeros((D, n, n), dtype=gp.Y.dtype, device=gp.device)
        rhs[d] = eye  # Phi^{-1} e_i batch
        ws = gp.ops.phi_solve(rhs, pivot=c.pivot, backend=c.backend,
                              alg=c.solve_alg)
        w = gp.ops.from_sorted(ws)
        z = solve_mhat(gp.ops, w, c.solve_cfg(), hier=gp.hier)
        y = solve(transpose(gp.ops.Phi), gp.ops.to_sorted(z), pivot=c.pivot,
                  backend=c.backend, alg=c.solve_alg)
        cols.append(y)  # (D, n, n): row block d', columns of dim d
    return LocalAcqCache(M_tilde=torch.stack(cols, dim=2))


def acq_local(gp: AdditiveGP, cache: LocalAcqCache, xq, beta, best_y,
              kind: str = "ucb", device=None):
    """O(1) acquisition value and gradient at one point xq (D,) given the
    dense cache."""
    xq = _query(gp, xq, device)
    rows, vals, _ = _phi_windows(gp, xq[None, :])  # (D, 1, W)
    _, dvals, _ = _phi_windows(gp, xq[None, :], grad=True)
    g_phi = torch.einsum("dab,db->da", _g_entries(gp, rows)[:, 0],
                         vals[:, 0])
    rows, vals, dvals = rows[:, 0], vals[:, 0], dvals[:, 0]  # (D, W)
    D = gp.D
    dev = rows.device

    bwin = torch.gather(gp.bY, 1, rows)
    mu = (vals * bwin).sum()
    dmu = (dvals * bwin).sum(dim=1)
    term2 = torch.einsum("da,da->", vals, g_phi)
    # the M~ window block: (D, W, D, W) gather
    ar = torch.arange(D, device=dev)
    mwin = cache.M_tilde[ar[:, None, None, None], rows[:, :, None, None],
                         ar[None, None, :, None], rows[None, None, :, :]]
    term3 = torch.einsum("da,daeb,eb->", vals, mwin, vals)
    var = torch.clamp(prior_var(gp, xq.dtype) - term2 + term3, min=1e-12)
    dvar = (-2.0 * torch.einsum("da,da->d", dvals, g_phi)
            + 2.0 * torch.einsum("da,daeb,eb->d", dvals, mwin, vals))
    return _acquire(kind, mu, dmu, var, dvar, beta, best_y)
