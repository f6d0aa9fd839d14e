"""Find the steps of a fit and of the posterior queries whose results
depend on the batch they run in, on an NVIDIA GPU.

A fleet lane's queries can part from its standalone GP's although every
kernel of the repo gives each lane its own launch's bits: some library
calls (cuBLAS, cuSOLVER, torch's reductions) pick their algorithm, or run
their iterations, by the whole batch. This script runs each step of the
path twice, on one GP's tensors and on a stack of T tenants whose lane 0
holds the same tensors, and prints for each whether lane 0 equals the
one-GP result bit for bit (and its max relative gap):

1. the query windows (``additive_gp._phi_windows``), and their
   contraction ``einsum("...rs,...rs->...r")`` alone, against the same
   contraction written as a product and a sum over the last axis;
2. the mean's sum over dimensions and window rows, from the one GP's
   windows; then ``posterior_mean`` whole;
3. the variance: the band's window entries, the quadratic term's einsum,
   one 32-column chunk of the Mhat solves (w, z and their product's sum),
   from the one GP's windows; then ``posterior_var`` whole;
4. at q = 3, the KP factors (``kp_factors``: A from batched SVDs of the
   windows, Phi = A K's band by an einsum) of one tenant alone and inside
   a stack with another tenant, and the SVD alone on the same matrices:
   the batch of one tenant against that batch twice over (same size, same
   content) and beside another tenant's matrices.

The stack's other lanes are copies of lane 0 (``core.fleet.replicate_gp``)
for 1-3, so only the batch's size differs; in 4 they hold another tenant.
The GP is the main path's (Schwefel, n = 30000 in capacity 32768, D = 10,
q = 0, precond "none"); q = 3 runs on a jittered grid at n = 2000::

    python scripts/lane_gap.py [T]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def report(name, one, stacked):
    lane = stacked[0]
    print(f"{name}: lane 0 == one GP bitwise {torch.equal(lane, one)}, max "
          f"rel {_gap(lane, one):.3e}", flush=True)


def _stack(t, T):
    return t[None].expand((T,) + t.shape).contiguous()


def _jittered(rng, n, D, spacing=0.2):
    g = (np.arange(n) + 0.5 + 0.3 * rng.uniform(-1, 1, (D, n))) * spacing
    return np.stack([rng.permutation(c) for c in g], axis=1)


def main(T: int = 4, dev: str = "cuda", n: int = 30000, cap: int = 32768,
         n3: int = 2000) -> None:
    import repro_torch.core.additive_gp as agp
    import repro_torch.core.kernel_packets as kpm
    from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
    from repro_torch.core import fleet as fl
    from repro_torch.data import sample_test_function

    dev = torch.device(dev)
    D, m = 10, 100
    X, Y, _, bounds = sample_test_function("schwefel", n, D, seed=600)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    g = fit(GPConfig(q=0, precond="none"), X, Y, omega, 1.0, capacity=cap,
            device=dev)
    st = fl.replicate_gp(g, T)
    Xq = torch.as_tensor(np.random.default_rng(601).uniform(
        bounds[:, 0], bounds[:, 1], (m, D)), device=dev)
    Xqt = _stack(Xq, T)
    print(f"q = 0, n = {n}, D = {D}, {m} queries, T = {T}", flush=True)
    # 1. windows, and their contraction alone
    rows1, vals1, _ = agp._phi_windows(g, Xq)
    _, valsT, _ = agp._phi_windows(st, Xqt)
    report("query windows (vals)", vals1, valsT)
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.standard_normal(tuple(vals1.shape) + (3,)),
                        device=dev)
    b = torch.as_tensor(rng.standard_normal(a.shape), device=dev)
    eq = "...rs,...rs->...r"
    report("window contraction einsum", torch.einsum(eq, a, b),
           torch.einsum(eq, _stack(a, T), _stack(b, T)))
    report("window contraction product + sum(-1)", (a * b).sum(-1),
           (_stack(a, T) * _stack(b, T)).sum(-1))
    # 2. the mean
    gat = agp._window_gather(g.bY, rows1)
    report("mean's sum over (D, W)", (vals1 * gat).sum(dim=(-3, -1)),
           (_stack(vals1, T) * _stack(gat, T)).sum(dim=(-3, -1)))
    report("posterior_mean", posterior_mean(g, Xq, device=dev),
           posterior_mean(st, Xqt, device=dev))
    # 3. the variance
    rowsT, vT = _stack(rows1, T), _stack(vals1, T)
    ge1, geT = agp._g_entries(g, rows1), agp._g_entries(st, rowsT)
    report("variance band window entries", ge1, geT)
    report("quadratic term einsum",
           torch.einsum("dma,dmab,dmb->m", vals1, ge1, vals1),
           torch.einsum("...dma,...dmab,...dmb->...m", vT, geT, vT))
    (_, w1, z1), = agp._var_chunks(g, rows1[:, :32], vals1[:, :32])
    (_, wT, zT), = agp._var_chunks(st, rowsT[:, :, :32], vT[:, :, :32])
    report("chunk w = P^T Phi^-1 phi", w1, wT)
    report("chunk z = Mhat^-1 w", z1, zT)
    report("chunk sum(w z)", (w1 * z1).sum(dim=(-3, -2)),
           (wT * zT).sum(dim=(-3, -2)))
    report("posterior_var", posterior_var(g, Xq[:32], device=dev),
           posterior_var(st, Xqt[:, :32], device=dev))
    del g, st
    # 4. q = 3: the KP factors' batched SVDs
    rj = np.random.default_rng(602)
    xs = [torch.sort(torch.as_tensor(_jittered(rj, n3, D), device=dev).T,
                     dim=1).values for _ in range(2)]
    om = torch.full((D,), 4.0, dtype=torch.float64, device=dev)
    seen = []
    svd = torch.linalg.svd

    def spy(E, *args, **kw):
        seen.append(E.detach().clone())
        return svd(E, *args, **kw)

    kpm.torch.linalg.svd = spy
    try:
        A1, P1 = kpm.kp_factors(3, om, xs[0])
        A2, P2 = kpm.kp_factors(3, om[None].expand(2, D), torch.stack(xs))
        kpm.kp_factors(3, om, xs[1])
    finally:
        kpm.torch.linalg.svd = svd
    print(f"q = 3, n = {n3}, D = {D}, two tenants", flush=True)
    report("KP factor A, tenant alone vs in a stack of 2", A1.data,
           A2.data)
    report("KP factor Phi (A K's band, an einsum), the same", P1.data,
           P2.data)
    E0, E1 = seen[0], seen[2]
    v0 = svd(E0, full_matrices=True)[2]
    report("SVD of the tenant's windows, batch twice over (same content)",
           v0, svd(torch.stack([E0, E0]), full_matrices=True)[2])
    report("SVD of the tenant's windows, beside another tenant's", v0,
           svd(torch.stack([E0, E1]), full_matrices=True)[2])


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
