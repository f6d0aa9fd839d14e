"""The port's windowed variance-band maintenance (``core.gband_update``)
against the exact recompute, on the CPU.

After every insert and evict the windowed band agrees with
``variance_band`` of the same factors within 1e-10 relative (the
reference's bar, ``tests/test_gband.py``), both when the Woodbury patch
covers the capacity and when it is truncated (capacity beyond
``patch_size``, quasi-uniform data); ``Hband`` is recomputed from the
factors and equals the recompute's bit for bit. The windowed path never
runs the full recompute; ``gband="full"`` does, with a zero drift
estimate. On densely oversampled data the truncation's drift estimate
crosses ``DRIFT_TOL`` and ``maybe_resync`` restores the exact band. The
patch solves at q = 2, 3 run the block CR at w = 6-8: its plain factor and
apply there equal ``block_cr_plain`` bit for bit. (The same mutations
against the JAX package: ``tests/test_torch_streaming.py``.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import streaming as st
from repro_torch.core import GPConfig, fit
from repro_torch.core.band_inverse import variance_band
from repro_torch.core.banded import Banded, to_dense
from repro_torch.core.gband_update import patch_size
from repro_torch.health import verdict as hv
from repro_torch.kernels import block_cr as bcr
from repro_torch.streaming import updates
from torch_port_inputs import OMEGA, band, points

torch.set_num_threads(2)

D, SIGMA = 2, 0.4


def _data(n, seed, span=4.0):
    rng = np.random.default_rng(seed)
    X = points(rng, n + 4, D, span=span)
    Y = np.sin(2.0 * X).sum(1) + 0.1 * rng.standard_normal(n + 4)
    return X, Y


def _check(gp, tol=1e-10):
    k = gp.num_points()
    G, H = variance_band(gp.ops.A, gp.ops.Phi, return_h=True)
    want = G.data[:, :k]
    err = float((gp.Gband.canonical().data[:, :k] - want).abs().max()
                / want.abs().max())
    assert err <= tol, err
    assert torch.equal(gp.Hband.canonical().data[:, :k], H.data[:, :k])


def _stream(gp, X, Y, n, iters, check=_check):
    for i in range(3):
        gp = st.insert(gp, X[n + i], Y[n + i], iters=iters, count=n + i)
        check(gp)
    for i in range(2):
        gp = st.evict(gp, iters=iters, count=n + 3 - i)
        check(gp)
    return gp


@pytest.mark.parametrize("q", [0, 1, 2])
def test_windowed_matches_full_recompute(q):
    n = 24
    X, Y = _data(n, 30 + q)
    gp = fit(GPConfig(q=q, solver_iters=40, precond="none"), X[:n], Y[:n],
             np.full(D, OMEGA), SIGMA, device="cpu", capacity=32)
    assert gp.config.gband == "windowed"
    assert patch_size(q, 32) == 32  # the patch covers the capacity
    gp = _stream(gp, X, Y, n, 40)
    assert float(gp.health.drift) == 0.0 and int(gp.health.muts) == 5


def test_patch_truncation_matches_full_at_large_capacity():
    """Capacity beyond the patch, quasi-uniform data (omega * gap = 2):
    the dropped out-of-patch terms sit at the decay floor."""
    n = 400
    X, Y = _data(n, 33, span=n / 2.0)
    gp = fit(GPConfig(q=0, solver_iters=30, precond="none"), X[:n], Y[:n],
             np.full(D, OMEGA), SIGMA, device="cpu", capacity=n + 8)
    assert patch_size(0, n + 8) < n  # truncation is active
    gp = _stream(gp, X, Y, n, 30)
    assert float(gp.health.drift) <= hv.DRIFT_TOL


def test_windowed_mutations_skip_full_recompute_and_full_config_runs_it(
        monkeypatch):
    n = 14
    X, Y = _data(n, 34)
    cfg = GPConfig(q=0, solver_iters=30, precond="none")
    gp = fit(cfg, X[:n], Y[:n], np.full(D, OMEGA), SIGMA, device="cpu",
             capacity=20)
    full = fit(dataclasses.replace(cfg, gband="full"), X[:n], Y[:n],
               np.full(D, OMEGA), SIGMA, device="cpu", capacity=20)
    calls = []
    real = updates.variance_band

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(updates, "variance_band", counted)
    g = st.evict(st.insert(gp, X[n], Y[n], count=n), count=n + 1)
    assert calls == [] and g.num_points() == n
    f = st.evict(st.insert(full, X[n], Y[n], count=n), count=n + 1)
    assert len(calls) == 2 and float(f.health.drift) == 0.0
    G = real(f.ops.A, f.ops.Phi)
    assert torch.equal(f.Gband.data, G.data)
    _check(g)


def test_drift_sentinel_resyncs_dense_data():
    """A densely oversampled stream (the reference's
    ``health.inject.dense_cluster_stream``: 260 points within 1e-7, so
    omega * gap ~ 4e-10) has no decay across the truncated patch: the drift
    estimate crosses DRIFT_TOL, and ``maybe_resync`` (also run by an insert
    without ``count``) brings back the exact band and zeroes the
    accumulators."""
    rng = np.random.default_rng(0)
    n, m, cap = 250, 254, 288
    X = 0.5 + 1e-7 * rng.random((m, 1))
    Y = np.sin(2.0 * np.pi * (X[:, 0] - 0.5) / 1e-7)
    g = fit(GPConfig(q=0, solver_iters=40, precond="none"), X[:n], Y[:n],
            np.ones(1), 0.25, device="cpu", capacity=cap)
    assert n > patch_size(0, cap)
    for i in range(n, m - 1):
        g = st.insert(g, X[i], Y[i], iters=40, count=i)
    assert float(g.health.drift) > hv.DRIFT_TOL and int(g.health.muts) == 3
    r, did = st.maybe_resync(g)
    assert did and float(r.health.drift) == 0.0 and int(r.health.muts) == 0
    assert torch.equal(r.Gband.data, variance_band(r.ops.A, r.ops.Phi).data)
    assert st.maybe_resync(r) == (r, False)
    # an insert without count runs the sentinel on the incoming GP first
    g2 = st.insert(g, X[m - 1], Y[m - 1], iters=40)
    assert int(g2.health.muts) == 1


@pytest.mark.parametrize("w", [6, 7, 8])
def test_block_cr_plain_factor_apply_at_wide_widths(w):
    """The patch solves' widths at q = 2, 3: factor + apply ==
    block_cr_plain bit for bit, pivoted and not."""
    rng = np.random.default_rng(40 + w)
    n = 10 * w + 3
    A = torch.as_tensor(band(rng, 2, n, w, w))
    R = torch.as_tensor(rng.standard_normal((2, n, 5)))
    for pivot in (False, True):
        x, ld = bcr.block_cr_plain(A, R, w, pivot=pivot)
        Ap = bcr.pad_band(A, w)
        fac, ldf = bcr.block_cr_factor_plain(Ap, w, pivot=pivot, logdet=True)
        xf = bcr.block_cr_apply_plain(fac, bcr.pad_rows(R, Ap.shape[1]), w,
                                      pivot=pivot)[:, :n]
        assert torch.equal(xf, x) and torch.equal(ldf, ld)
        dense = to_dense(Banded(A, w, w))
        assert float((dense @ x - R).abs().max()) <= 1e-10
