"""Hold the whole-PCG, Gauss-Seidel or Jacobi kernel of one checkout
against another's, bit for bit.

A refactor of code that ``csrc/mega_pcg.cu``, ``csrc/gauss_seidel.cu`` or
``csrc/jacobi.cu`` compiles (``sweep.cuh``, ``cr.cuh``, ``common.cuh``)
should leave its numbers unchanged. Run this once per checkout on an NVIDIA GPU, with the
same operands file; the first run writes the operands (q = 0 at n = 30000
and q = 1 at n = 4000, D = 10, on a jittered grid), later runs load them,
so both sides solve identical systems. Then compare the two output files::

    python scripts/mega_pcg_bitwise.py run  SRC OUT OPERANDS [pcg|gs|jacobi]
    python scripts/mega_pcg_bitwise.py diff OUT_A OUT_B

``pcg`` (the default) runs the whole PCG solve, cold and warm, with and
without the tol exit. ``gs`` runs Gauss-Seidel in both pivot modes: the
whole solve (40 sweeps from x0; fused="whole") and one sweep with k
(fused="on"), each (x, k); where the checkout takes ``cols``, it also
reports whether every chunk width 1, 2, 4, 8 gives the default's bits.
``jacobi`` runs damped Jacobi (alpha = 1/D) the same way: the whole solve
(40 sweeps) from x0 warm and from zero, and one sweep with k carried and
from a warm start, each (x, k), in both pivot modes and at every width.

``SRC`` is the ``src`` directory of the checkout to run (its kernels are
built beside it, under its own ``build/``).

A checkout can only match another where each is consistent with itself.
``selfcheck`` asks one checkout whether its preconditioner solve gives the
same bits in the seed and in an iteration: the cold seed solves z = M^{-1} v,
then one carried iteration from (x, r = v, p = 0) solves the same r again
(with p = 0 the update leaves r as it is and the new p is that z)::

    python scripts/mega_pcg_bitwise.py selfcheck SRC OPERANDS
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

CASES = ((0, 30000, 10, 32), (1, 4000, 10, 16), (1, 4000, 10, 1))


def _operands(path, dev):
    from repro_torch.core.banded import add, scale
    from repro_torch.core.kernel_packets import kp_factors
    from repro_torch.kernels.fused_sweep import FusedSweep

    ops = {}
    for q, n, D, B in CASES:
        rng = np.random.default_rng(7 + q + B)
        X = torch.as_tensor(rng.uniform(0, 0.1 * n / 4, (n, D)), device=dev)
        sort_idx = torch.argsort(X.T, dim=1, stable=True)
        xs = torch.gather(X.T, 1, sort_idx)
        om = torch.full((D,), 4.0, dtype=torch.float64, device=dev)
        A, Phi = kp_factors(q, om, xs)
        SAPhi = add(scale(A, 0.49), Phi)
        fs = FusedSweep(Phi.data, SAPhi.data, sort_idx,
                        torch.argsort(sort_idx, dim=1), 0.49, w_p=Phi.lo,
                        w_s=SAPhi.lo, a=A.data, w_a=A.lo)
        v = rng.standard_normal((D, n, B))
        x0 = 0.1 * rng.standard_normal((D, n, B))
        ops[(q, n, B)] = dict(
            t=[t.cpu() for t in (fs.a, fs.phi, fs.saphi, fs.sort_idx,
                                 fs.rank_idx, fs.sigma2)]
            + [fs.pad_state(torch.as_tensor(a, device=dev)).cpu()
               for a in (v, x0)],
            w=(fs.w_a, fs.w_p, fs.w_s))
    torch.save(ops, path)


def _run_gs(opfile, dev):
    """Gauss-Seidel (x, k, 0) per (q, n, B, pivot, mode); the chunk widths'
    agreement is printed."""
    import inspect

    from repro_torch.kernels.fused_sweep import fused_gauss_seidel_iter
    from repro_torch.kernels.mega_solve import mega_gauss_seidel_solve

    widths = "cols" in inspect.signature(mega_gauss_seidel_solve).parameters
    res = {}
    for key, o in torch.load(opfile).items():
        _, phi, saphi, si, ri, s2, v, x0 = (t.to(dev) for t in o["t"])
        ops = (phi, saphi, si, ri, s2, v, x0)
        _, w_p, w_s = o["w"]
        for pivot in (False, True):
            kw = dict(w_p=w_p, w_s=w_s, pivot=pivot)
            calls = {
                "whole": lambda **c: mega_gauss_seidel_solve(
                    *ops, iters=40, **kw, **c),
                "on": lambda **c: fused_gauss_seidel_iter(
                    *ops, want_resid=True, **kw, **c)}
            for mode, call in calls.items():
                x, k = call()
                res[key + (pivot, mode)] = (x.cpu(), k.cpu(), 0)
                if widths:
                    same = all(
                        all(torch.equal(a, b) for a, b in
                            zip(call(cols=c), (x, k))) for c in (1, 2, 4, 8))
                    print(f"gs (q, n, B) = {key} pivot={pivot} {mode}: "
                          f"chunk widths 1, 2, 4, 8 bitwise {same}",
                          flush=True)
    return res


def _run_jacobi(opfile, dev):
    """Jacobi (x, k, 0) per (q, n, B, pivot, mode); the chunk widths'
    agreement is printed."""
    import inspect

    from repro_torch.kernels.fused_sweep import fused_jacobi_iter
    from repro_torch.kernels.mega_solve import mega_jacobi_solve

    widths = "cols" in inspect.signature(mega_jacobi_solve).parameters
    res = {}
    for key, o in torch.load(opfile).items():
        _, phi, saphi, si, ri, s2, v, x0 = (t.to(dev) for t in o["t"])
        ops = (phi, saphi, si, ri, s2, v)
        _, w_p, w_s = o["w"]
        for pivot in (False, True):
            kw = dict(w_p=w_p, w_s=w_s, pivot=pivot, alpha=1.0 / v.shape[0])
            calls = {
                "whole": lambda **c: mega_jacobi_solve(
                    *ops, x0, iters=40, warm=True, **kw, **c),
                "whole cold": lambda **c: mega_jacobi_solve(
                    *ops, torch.zeros_like(v), iters=40, **kw, **c),
                "on": lambda **c: fused_jacobi_iter(*ops, x0, v, **kw, **c),
                "on warm": lambda **c: fused_jacobi_iter(
                    *ops, x0, warm=True, **kw, **c)}
            for mode, call in calls.items():
                x, k = call()
                res[key + (pivot, mode)] = (x.cpu(), k.cpu(), 0)
                if widths:
                    same = all(
                        all(torch.equal(a, b) for a, b in
                            zip(call(cols=c), (x, k))) for c in (1, 2, 4, 8))
                    print(f"jacobi (q, n, B) = {key} pivot={pivot} {mode}: "
                          f"chunk widths 1, 2, 4, 8 bitwise {same}",
                          flush=True)
    return res


def run(src, out, opfile, solver="pcg"):
    sys.path.insert(0, src)
    from repro_torch.kernels.mega_solve import mega_pcg_solve

    dev = torch.device("cuda")
    if not os.path.exists(opfile):
        _operands(opfile, dev)
    if solver in ("gs", "jacobi"):
        torch.save((_run_gs if solver == "gs" else _run_jacobi)(opfile, dev),
                   out)
        return
    res = {}
    for key, o in torch.load(opfile).items():
        a, phi, saphi, si, ri, s2, v, x0 = (t.to(dev) for t in o["t"])
        w_a, w_p, w_s = o["w"]
        for warm in (False, True):
            for tol in (0.0, 1e-9):
                x, r, it = mega_pcg_solve(
                    a, phi, saphi, si, ri, s2, v,
                    x0 if warm else torch.zeros_like(v), w_a=w_a, w_p=w_p,
                    w_s=w_s, iters=40, tol=tol, warm=warm)
                res[key + (warm, tol)] = (x.cpu(), r.cpu(), int(it))
    torch.save(res, out)


def selfcheck(src, opfile):
    sys.path.insert(0, src)
    from repro_torch.kernels.fused_sweep import fused_pcg_iter, pcg_seed

    dev = torch.device("cuda")
    if not os.path.exists(opfile):
        _operands(opfile, dev)
    for key, o in torch.load(opfile).items():
        a, phi, saphi, si, ri, s2, v, _ = (t.to(dev) for t in o["t"])
        ops = (a, phi, saphi, si, ri, s2)
        kw = dict(zip(("w_a", "w_p", "w_s"), o["w"]))
        x, r, z, rz = pcg_seed(*ops, v, torch.zeros_like(v), warm=False,
                               **kw)
        _, r1, z1, rz1 = fused_pcg_iter(*ops, x, r, torch.zeros_like(z), rz,
                                        **kw)
        print(f"{src} (q, n, B) = {key}: r kept {torch.equal(r1, r)}; "
              f"z in the seed == z in an iteration: {torch.equal(z1, z)} "
              f"(max difference {float((z1 - z).abs().max()):.3e}, "
              f"max |z| {float(z.abs().max()):.3e})")


def diff(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    same_all = True
    for k in a:
        same = (torch.equal(a[k][0], b[k][0]) and torch.equal(a[k][1], b[k][1])
                and a[k][2] == b[k][2])
        rel = [float((a[k][i] - b[k][i]).abs().max() / a[k][i].abs().max())
               for i in (0, 1)]
        same_all &= same
        print(f"(q, n, B, ...) = {k}: bitwise {same}, x max rel "
              f"{rel[0]:.3e}, r (pcg) or k max rel {rel[1]:.3e}, "
              f"iterations {a[k][2]} / {b[k][2]}")
    print(f"all bitwise: {same_all}")


if __name__ == "__main__":
    cmd, *args = sys.argv[1:]
    {"run": run, "diff": diff, "selfcheck": selfcheck}[cmd](*args)
