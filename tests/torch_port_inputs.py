"""Seeded numpy inputs shared by the torch-port tests (imports no JAX).

Points are jittered grids, which keep every Kernel Packet window well
conditioned: on clustered points the KP null-space problem at q >= 1 is
ill-conditioned, and two LAPACK builds then agree only to ~1e-6 (see
ROADMAP Queue 3), which would mask what the tests check.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.banded import add, scale
from repro_torch.core.kernel_packets import kp_factors

OMEGA = 4.0  # KP decay rate per dimension for the test inputs


def band(rng, G, n, lo, hi):
    """Diagonally dominant (G, n, lo+hi+1) band with zero out-of-range entries."""
    data = rng.standard_normal((G, n, lo + hi + 1))
    i = np.arange(n)[:, None]
    j = i + np.arange(-lo, hi + 1)[None, :]
    data = np.where((j >= 0) & (j < n), data, 0.0)
    off = np.abs(data).sum(-1) - np.abs(data[..., lo])
    data[..., lo] = np.sign(data[..., lo] + 0.5) * (off + 1.0)
    return data


def points(rng, n, D, span=4.0):
    """(n, D) points, each column a shuffled jittered grid on [0, span]."""
    cols = []
    for _ in range(D):
        g = (np.arange(n) + 0.5 + 0.3 * rng.uniform(-1, 1, n)) * span / n
        cols.append(rng.permutation(g))
    return np.stack(cols, axis=1)


def solve_operands(rng, n, D, q, sigma=0.7):
    """Unpadded (A, Phi, SAPhi) band data, sort/rank permutations and sigma^2
    of an additive-GP system, as numpy arrays."""
    X = torch.as_tensor(points(rng, n, D))
    sort_idx = torch.argsort(X.T, dim=1, stable=True)
    xs = torch.gather(X.T, 1, sort_idx)
    A, Phi = kp_factors(q, torch.full((D,), OMEGA, dtype=torch.float64), xs)
    SAPhi = add(scale(A, sigma ** 2), Phi)
    rank_idx = torch.argsort(sort_idx, dim=1)
    return dict(A=A.data.numpy(), Phi=Phi.data.numpy(),
                SAPhi=SAPhi.data.numpy(), w_a=A.lo, w_p=Phi.lo, w_s=SAPhi.lo,
                sort_idx=sort_idx.numpy(), rank_idx=rank_idx.numpy(),
                sigma2=sigma ** 2)


def padded_operands(ops, device, B, rng):
    """The port's padded whole-solve operands plus a (D, n, B) RHS and warm
    start, as torch tensors on ``device``."""
    from repro_torch.kernels.fused_sweep import FusedSweep

    dev = torch.device(device)
    t = lambda k: torch.as_tensor(ops[k]).to(dev)
    fs = FusedSweep(t("Phi"), t("SAPhi"), t("sort_idx"), t("rank_idx"),
                    ops["sigma2"], w_p=ops["w_p"], w_s=ops["w_s"], a=t("A"),
                    w_a=ops["w_a"])
    D, n = ops["sort_idx"].shape
    v = rng.standard_normal((D, n, B))
    x0 = 0.1 * rng.standard_normal((D, n, B))
    return fs, v, x0


def fleet_operands(rng, T, n, D, q, device, B):
    """A tenant stack of T ``solve_operands`` systems (sigma 0.7 ... 0.9),
    as the port's padded ``FusedSweep`` (leading T axis), plus (T, D, n, B)
    right-hand sides and warm starts and the per-tenant operand dicts."""
    from repro_torch.kernels.fused_sweep import FusedSweep

    dev = torch.device(device)
    opss = [solve_operands(rng, n, D, q, sigma=0.7 + 0.2 * t / max(T - 1, 1))
            for t in range(T)]
    st = lambda k: torch.as_tensor(np.stack([o[k] for o in opss])).to(dev)
    o = opss[0]
    fs = FusedSweep(st("Phi"), st("SAPhi"), st("sort_idx"), st("rank_idx"),
                    torch.tensor([x["sigma2"] for x in opss],
                                 dtype=torch.float64, device=dev),
                    w_p=o["w_p"], w_s=o["w_s"], a=st("A"), w_a=o["w_a"])
    v = rng.standard_normal((T, D, n, B))
    x0 = 0.1 * rng.standard_normal((T, D, n, B))
    return fs, v, x0, opss


def dim_ops(ops, device):
    """The port's ``DimOps`` of ``solve_operands`` on ``device``."""
    from repro_torch.core.backfitting import DimOps
    from repro_torch.core.banded import Banded

    t = lambda k: torch.as_tensor(ops[k]).to(torch.device(device))
    return DimOps(A=Banded(t("A"), ops["w_a"], ops["w_a"]),
                  Phi=Banded(t("Phi"), ops["w_p"], ops["w_p"]),
                  SAPhi=Banded(t("SAPhi"), ops["w_s"], ops["w_s"]),
                  sort_idx=t("sort_idx"), rank_idx=t("rank_idx"),
                  sigma2=torch.tensor(ops["sigma2"], dtype=torch.float64,
                                      device=torch.device(device)))


__all__ = ["OMEGA", "band", "points", "solve_operands", "padded_operands",
           "fleet_operands",
           "dim_ops"]
