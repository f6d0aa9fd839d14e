"""Where a fleet's fit and variance spend their device time, on an NVIDIA
GPU: ``fleet_fit`` of T = 64 Schwefel tenants (n = 1500, D = 10, q = 0,
capacity 2048; warm, at T = 8 and 64) against 64 standalone fits, then one
``torch.profiler`` trace each of ``fleet_fit`` and of
``fleet_posterior_var`` (32 queries a tenant) on the stack of the
tenants' own fits: the kernels' device time by name, and the host ops'.

    python scripts/fleet_profile.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import GPConfig, fit  # noqa: E402
from repro_torch.core import fleet as fl  # noqa: E402
from repro_torch.data import sample_test_function  # noqa: E402


def _ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("fleet_profile: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    T, n, D, cap = 64, 1500, 10, 2048
    data = [sample_test_function("schwefel", n, D, seed=t) for t in range(T)]
    X = np.stack([d[0] for d in data])
    Y = np.stack([d[1] for d in data])
    b = data[0][3]
    om = 8.0 / (b[:, 1] - b[:, 0])
    cfg = GPConfig()
    for T_ in (8, T):
        fl.fleet_fit(cfg, X[:T_], Y[:T_], om, 1.0, cap)
        _, ms = _ms(lambda: fl.fleet_fit(cfg, X[:T_], Y[:T_], om, 1.0, cap))
        print(f"fleet_fit T={T_} n={n} D={D} (warm): {ms:.1f} ms", flush=True)
    fit(cfg, X[0], Y[0], om, 1.0, capacity=cap)
    gps, ms = _ms(lambda: [fit(cfg, X[t], Y[t], om, 1.0, capacity=cap)
                           for t in range(T)])
    print(f"{T} standalone fits: {ms:.1f} ms", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fl.fleet_fit(cfg, X, Y, om, 1.0, cap)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))
    fleet = fl.stack_gps(gps)
    Xq = torch.as_tensor(np.random.default_rng(1).uniform(
        b[:, 0], b[:, 1], (T, 32, D)), device=dev)
    fl.fleet_posterior_var(fleet, Xq)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fl.fleet_posterior_var(fleet, Xq)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))


if __name__ == "__main__":
    main()
