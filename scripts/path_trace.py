"""Trace the default configuration's path of one checkout on an NVIDIA GPU,
and compare the outputs of two checkouts bit for bit.

    python scripts/path_trace.py run SRC OUT_DIR TAG
    python scripts/path_trace.py compare OUT_DIR TAG_A TAG_B [TAG_C ...]

``run`` imports the port from ``SRC`` (the ``src`` directory of the checkout;
its kernels are built under that checkout's ``build/``) and drives the
reference's default ``GPConfig(q=0)`` (precond "auto" -> kmg, 50
iterations, unfused) at ``chip_smoke.py``'s main point: Schwefel data,
n = 30000, D = 10. It writes ``OUT_DIR/TAG.json`` and ``OUT_DIR/TAG.pt``:

1. ``fit`` five times, host clock around each call ending in a
   synchronise, split into its stages (the KP and generalized-KP factor
   assembly, the kmg hierarchy, the mean solve, the RGF variance band,
   the rest) by timing the stage functions of ``core.additive_gp`` the
   same way;
2. a ``torch.profiler`` trace of each of ``fit``, ``posterior_var`` on 32
   queries (one variance chunk) and ``mll_gradients``: the device time of
   every kernel by name, summed into groups (the block-CR kernels, the
   other hand kernels by name, PyTorch's own kernels: gathers and
   scatters, elementwise, reductions, copies, linear algebra, other), the
   launch counts, the wall time of the traced call and the idle share
   ``1 - device time / wall`` (one stream: kernels do not overlap); and
   the same call's wall time untraced;
3. the outputs of ``fit``, ``posterior_mean(100)``, ``posterior_var(100)``,
   ``log_likelihood`` and ``mll_gradients`` from fixed generator seeds,
   saved to the ``.pt`` file and as SHA-256 digests of their bytes in the
   JSON, with the peak device memory of that pass.

``compare`` prints the JSON files' numbers side by side and whether each
output of the later tags equals the first tag's bit for bit (by digest,
so runs of separate calls compare; where both ``.pt`` files are at hand,
also the largest difference). To
compare a parent with a change in one call, unpack the parent with ``git
archive`` into a git-ignored directory and run parent, change, change,
parent.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

D, N = 10, 30000
FIT_REPS = 5
STAGES = ("kp_factors", "gkp_factors", "build_gp_hier", "mean_caches",
          "variance_band")

# kernel-name groups of the trace, first match wins: the port's hand kernels
# by the names of their __global__ functions, then PyTorch's own kernels
GROUPS = (
    ("block_cr (solve, factor, apply)", ("block_cr_kernel",
                                         "cr_factor_kernel",
                                         "cr_apply_kernel")),
    ("banded_lu", ("diag_kernel", "banded_lu")),
    ("banded_matvec", ("banded_matvec",)),
    ("band_matmul", ("band_matmul",)),
    ("rgf", ("rgf_kernel",)),
    ("torch gather/scatter/index", ("gather", "scatter", "index", "Index")),
    ("torch reduction", ("reduce", "Reduce", "sum", "norm")),
    ("torch copy/fill", ("copy", "Copy", "fill", "Fill", "Memcpy",
                         "Memset", "cat", "Cat")),
    ("torch linear algebra", ("gemm", "Gemm", "gemv", "syevj", "svd",
                              "potrf", "getrf", "geqrf", "cusolver",
                              "magma", "sm90_", "cutlass", "Kernel2",
                              "dot_kernel")),
    ("torch elementwise", ("elementwise", "Elementwise", "vectorized",
                           "unrolled")),
)


def _group(name):
    for g, keys in GROUPS:
        if any(k in name for k in keys):
            return g
    return "other"


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def trace_call(fn):
    """Device ms by kernel name and by group, launches by group, the traced
    wall time, the idle share; and the untraced wall time of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, plain_ms = _sync_time(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, groups, launches = {}, {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or "Activity Buffer" in ev.key:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if t <= 0:
            continue
        by_name[ev.key[:90]] = [t, ev.count]
        g = _group(ev.key)
        groups[g] = groups.get(g, 0.0) + t
        launches[g] = launches.get(g, 0) + ev.count
    busy = sum(groups.values())
    return dict(wall_ms=plain_ms, traced_wall_ms=wall, device_ms=busy,
                idle_share=1.0 - busy / wall, groups=groups,
                launches=launches,
                top=dict(sorted(by_name.items(), key=lambda kv: -kv[1][0])
                         [:25]))


def _fit_stages(P, fit):
    """fit's wall time and its stages' (each stage a sync-timed call)."""
    agp = P["agp"]
    spent = {k: 0.0 for k in STAGES}
    saved = {k: getattr(agp, k) for k in STAGES}

    def timed(name, fn):
        def call(*a, **k):
            out, ms = _sync_time(lambda: fn(*a, **k))
            spent[name] += ms
            return out
        return call

    for k in STAGES:
        setattr(agp, k, timed(k, saved[k]))
    try:
        gp, total = _sync_time(fit)
    finally:
        for k, fn in saved.items():
            setattr(agp, k, fn)
    # mean_caches runs inside posterior_caches, which also calls
    # variance_band: both are timed where they are called
    spent["rest"] = total - sum(spent.values())
    return gp, total, spent


def run(src, out_dir, tag):
    sys.path.insert(0, src)
    import repro_torch.core.additive_gp as agp
    from repro_torch.core import (GPConfig, fit, log_likelihood,
                                  mll_gradients, posterior_mean,
                                  posterior_var)
    from repro_torch.data import sample_test_function
    from repro_torch.kernels import _build

    P = dict(agp=agp)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{tag} ({src}): {smi}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    res = dict(src=src, tag=tag, card=smi,
               build_s=time.perf_counter() - t0)

    X, Y, _, bounds = sample_test_function("schwefel", N, D, seed=0)
    span = bounds[:, 1] - bounds[:, 0]
    omega, sigma = 8.0 / span, 1.0
    Xq = np.random.default_rng(100).uniform(bounds[:, 0], bounds[:, 1],
                                            size=(100, D))
    cfg = GPConfig(q=0)
    do_fit = lambda: fit(cfg, X, Y, omega, sigma)  # noqa: E731

    # 1. fit, repeated, with its stages
    fits = []
    for i in range(FIT_REPS):
        gp, total, spent = _fit_stages(P, do_fit)
        fits.append(dict(total_ms=total, **spent))
        print(f"{tag} fit {i}: {total:.1f} ms, stages "
              + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()),
              flush=True)
    res["fits"] = fits

    # 2. traces
    gen = torch.Generator().manual_seed(3)
    traces = {}
    for name, fn in (("fit", do_fit),
                     ("posterior_var(32)", lambda: posterior_var(gp, Xq[:32])),
                     ("mll_gradients", lambda: mll_gradients(gp, gen))):
        _build.reset_launch_counts()
        traces[name] = trace_call(fn)
        # the port's launch counts per call (trace_call calls fn twice)
        traces[name]["port_launches"] = {
            k: v // 2 for k, v in _build.launch_counts().items() if v}
        t = traces[name]
        print(f"{tag} trace {name}: wall {t['wall_ms']:.1f} ms (traced "
              f"{t['traced_wall_ms']:.1f}), device {t['device_ms']:.1f} ms, "
              f"idle {t['idle_share']:.3f}; groups "
              + ", ".join(f"{k} {v:.1f} ms/{t['launches'][k]}"
                          for k, v in sorted(t["groups"].items(),
                                             key=lambda kv: -kv[1])),
              flush=True)
    res["traces"] = traces

    # 3. outputs, bit for bit, and the peak memory of the pass
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g = do_fit()
    outs = dict(u_sy=g.u_sy, bY=g.bY, Gband=g.Gband.data,
                mean=posterior_mean(g, Xq), var=posterior_var(g, Xq))
    outs["log_likelihood"] = log_likelihood(
        g, torch.Generator().manual_seed(0))
    go, gs = mll_gradients(g, torch.Generator().manual_seed(1))
    outs["grad_omega"], outs["grad_sigma"] = go, gs
    torch.cuda.synchronize()
    res["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    res["launches_outputs_pass"] = {k: v for k, v in
                                    _build.launch_counts().items() if v}
    outs = {k: v.detach().cpu().contiguous() for k, v in outs.items()}
    res["sha256"] = {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                     for k, v in outs.items()}
    torch.save(outs, out_dir / f"{tag}.pt")
    print(f"{tag} outputs pass: peak {res['peak_mib']:.1f} MiB above the "
          f"data; log_likelihood {float(outs['log_likelihood']):.10f}",
          flush=True)
    with open(out_dir / f"{tag}.json", "w") as f:
        json.dump(res, f, indent=1)


def compare(out_dir, *tags):
    out_dir = Path(out_dir)
    runs = [json.load(open(out_dir / f"{t}.json")) for t in tags]
    print("card:", runs[0]["card"])
    print("columns:", " | ".join(tags))

    def line(name, vals):
        print(f"{name:52s} " + " | ".join(
            "-" if v is None else f"{v:.4f}" for v in vals))

    for i in range(FIT_REPS):
        line(f"fit {i} total ms", [r["fits"][i]["total_ms"] for r in runs])
    for s in STAGES + ("rest",):
        line(f"fit stage {s} ms (median)",
             [float(np.median([f[s] for f in r["fits"]])) for r in runs])
    for name in runs[0]["traces"]:
        for k in ("wall_ms", "traced_wall_ms", "device_ms", "idle_share"):
            line(f"{name} {k}", [r["traces"][name][k] for r in runs])
        groups = sorted({g for r in runs for g in r["traces"][name]["groups"]})
        for g in groups:
            line(f"{name} {g} ms",
                 [r["traces"][name]["groups"].get(g) for r in runs])
    line("peak MiB (outputs pass)", [r["peak_mib"] for r in runs])
    ref = runs[0]["sha256"]
    for t, r in zip(tags[1:], runs[1:]):
        same = {k: r["sha256"][k] == ref[k] for k in ref}
        diff = {}
        if not all(same.values()) and all(
                (out_dir / f"{u}.pt").exists() for u in (tags[0], t)):
            a, b = (torch.load(out_dir / f"{u}.pt") for u in (tags[0], t))
            diff = {k: float((a[k] - b[k]).abs().max()) for k in a
                    if not same[k]}
        print(f"{t} == {tags[0]} bit for bit: {all(same.values())} "
              f"{same}{' max abs diff ' + str(diff) if diff else ''}")


if __name__ == "__main__":
    cmd, *args = sys.argv[1:]
    {"run": run, "compare": compare}[cmd](*args)
