"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
one process per source), then:

1. kernel phase: each kernel on seeded float64 inputs at the serving path's
   shapes (n = 30000, D = 10, q = 0) and at q = 1 widths, held against its
   plain PyTorch version on the same CUDA tensors; errors, times, bounds;
2. main path: Schwefel data, n = 30000, D = 10 (the paper's Fig. 5 point),
   ``fit`` -> ``posterior_mean`` -> ``posterior_var`` on 100 queries, with
   every kernel's launch count over that run;
3. consistency: the same path at n = 4000, D = 10 on the card and with
   ``device="cpu"`` (plain versions); mean and variance agree to 1e-7.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failed check raises, so the
exit code is non-zero and no result line is printed. Needs one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the serving path's shape (the Fig. 5 --full point), the q = 1 check size,
# and the card-vs-CPU consistency size (the quickstart's)
D_PATH, N_PATH, B_PATH, N_Q1, N_CHECK = 10, 30000, 32, 4000, 4000
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS = 34e12  # H100 SXM FP64 outside the tensor cores (data sheet)


def _require_gpu():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)


def _import_port():
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
    from repro_torch.core.band_inverse import _to_blocks
    from repro_torch.core.banded import add, scale
    from repro_torch.core.kernel_packets import gkp_factors, kp_factors
    from repro_torch.data import sample_test_function
    from repro_torch.health.verdict import verdict_name
    from repro_torch.kernels import _build
    from repro_torch.kernels.band_matmul import band_matmul, band_matmul_plain
    from repro_torch.kernels.banded_lu import banded_lu, banded_lu_plain
    from repro_torch.kernels.fused_sweep import FusedSweep
    from repro_torch.kernels.mega_solve import mega_pcg_plain, mega_pcg_solve
    from repro_torch.kernels.rgf import rgf_blocks, rgf_blocks_plain
    return dict(locals())


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_ms(fn, reps=3, warmup=1):
    """Mean ms per call on the card (CUDA events); returns (ms, last out)."""
    out = None
    for _ in range(warmup):
        out = fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def _band(rng, G, n, lo, hi, dev):
    """Diagonally dominant band (G, n, lo+hi+1), zero out-of-range entries."""
    data = rng.standard_normal((G, n, lo + hi + 1))
    i = np.arange(n)[:, None]
    j = i + np.arange(-lo, hi + 1)[None, :]
    data = np.where((j >= 0) & (j < n), data, 0.0)
    off = np.abs(data).sum(-1) - np.abs(data[..., lo])
    data[..., lo] = np.sign(data[..., lo] + 0.5) * (off + 1.0)
    return torch.as_tensor(data, device=dev)


def _errs(k, p):
    d = float((k - p).abs().max())
    return d, d / max(float(p.abs().max()), 1e-300)


def _bound(nbytes, ops):
    tb, to = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP64_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _solve_ops(w, B):
    """Flops per (row, column) of one banded solve: a division at w = 0;
    block CR at w >= 1 (forward and back substitution on the right-hand
    side, 8 w^2, plus the block elimination shared by the B columns)."""
    return 1.0 if w == 0 else 8.0 * w * w + 12.0 * w ** 3 / B


def _mega_cost(D, npad, B, w_a, w_p, w_s, iters):
    N = D * npad * B
    nbytes = 8 * D * npad * (2 * w_a + 2 * w_p + 2 * w_s + 3) \
        + 4 * 2 * D * npad + 8 * (4 * N + 1)
    per_iter = (2 * (2 * w_a + 1) + 2 * (2 * w_p + 1) + _solve_ops(w_p, B)
                + _solve_ops(w_s, B) + 14)
    return nbytes, iters * N * per_iter


def kernel_phase(P, rng, dev, shapes, ops_path, ops_q1):
    """Each kernel vs its plain version at the path's and q = 1 shapes."""
    D, n, B = shapes
    rows = []

    def report(name, tag, err, rel, tol, ms, plain_ms):
        print(f"kernel {name:12s} {tag:26s} max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol {tol:.0e}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}", flush=True)
        if not rel <= tol:
            raise RuntimeError(f"{name} {tag}: error {rel:.3e} > {tol:.0e}")

    # --- banded_lu: Phi solves at lo = hi = 0 (B = 32 variance chunk) ----
    for tag, (G, nn, lo, hi, Bc) in (("path lo=hi=0 B=32", (D, n, 0, 0, B)),
                                     ("path lo=hi=0 B=1", (D, n, 0, 0, 1)),
                                     ("q1 lo=hi=1 B=32", (D, N_Q1, 1, 1, B))):
        bd = _band(rng, G, nn, lo, hi, dev)
        rhs = torch.as_tensor(rng.standard_normal((G, nn, Bc)), device=dev)
        ms, (x, ld) = _event_ms(lambda: P["banded_lu"](bd, rhs, lo, hi),
                                reps=20)
        pms, (xp, ldp) = _event_ms(
            lambda: P["banded_lu_plain"](bd, rhs, lo, hi), reps=1, warmup=0)
        err, rel = _errs(torch.cat([x.flatten(), ld]),
                         torch.cat([xp.flatten(), ldp]))
        report("banded_lu", tag, err, rel, 1e-12, ms, pms)
        if tag.startswith("path lo=hi=0 B=32"):
            lib_ms, _ = _event_ms(lambda: rhs / bd, reps=20)
            nbytes = 8 * (G * nn + 2 * G * nn * Bc + G)
            b_ms, b_by = _bound(nbytes, G * nn * Bc + 2 * G * nn)
            rows.append(dict(name="banded_lu", route="cuda",
                             source="src/repro_torch/csrc/banded_lu.cu",
                             replaces="src/repro/kernels/banded_lu.py:93",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms))

    # --- band_matmul: H = A Phi^T -----------------------------------------
    for tag, (nn, w) in (("path (1,1)x(0,0)", (n, (1, 1, 0, 0))),
                         ("q1 (2,2)x(1,1)", (N_Q1, (2, 2, 1, 1)))):
        a = _band(rng, D, nn, w[0], w[1], dev)
        b = _band(rng, D, nn, w[2], w[3], dev)
        ms, c = _event_ms(lambda: P["band_matmul"](a, b, *w), reps=20)
        pms, cp = _event_ms(lambda: P["band_matmul_plain"](a, b, *w),
                            reps=1, warmup=0)
        err, rel = _errs(c, cp)
        report("band_matmul", tag, err, rel, 1e-13, ms, pms)
        if tag.startswith("path"):
            wa, wb = w[0] + w[1] + 1, w[2] + w[3] + 1
            b_ms, b_by = _bound(8 * D * nn * (wa + wb + wa + wb - 1),
                                2 * D * nn * wa * wb)
            rows.append(dict(name="band_matmul", route="cuda",
                             source="src/repro_torch/csrc/band_matmul.cu",
                             replaces="src/repro/kernels/band_matmul.py:52",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))

    # --- rgf: the variance band's block recurrences -----------------------
    for tag, (nn, w) in (("path w=1", (n, 1)), ("q1 w=3", (N_Q1, 3))):
        h = _band(rng, D, nn, w, w, dev)
        blocks = [t.contiguous() for t in P["_to_blocks"](h, w, w, w)]
        ms, out = _event_ms(lambda: P["rgf_blocks"](*blocks), reps=3)
        pms, outp = _event_ms(lambda: P["rgf_blocks_plain"](*blocks),
                              reps=1, warmup=0)
        err, rel = _errs(torch.stack(out), torch.stack(outp))
        report("rgf_blocks", tag, err, rel, 1e-10, ms, pms)
        if tag.startswith("path"):
            T = blocks[0].shape[1]
            b_ms, b_by = _bound(8 * 6 * D * T * w * w,
                                D * T * (23 * w ** 3 + 2 * w * w))
            rows.append(dict(name="rgf_blocks", route="cuda",
                             source="src/repro_torch/csrc/rgf.cu",
                             replaces="src/repro/kernels/rgf.py:90",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))

    # --- mega_pcg: the whole Mhat solve on the GP's own operands ----------
    for tag, fs in (("path q=0 B=32 40 iters", ops_path),
                    ("q1 (2,1,2) B=32 40 iters", ops_q1)):
        v = fs.pad_state(torch.as_tensor(
            rng.standard_normal((fs.D, fs.n, B)), device=dev))
        x0 = torch.zeros_like(v)
        args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2,
                v, x0)
        kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=40)
        ms, (x, r, it) = _event_ms(lambda: P["mega_pcg_solve"](*args, **kw),
                                   reps=3)
        pms, (xp, rp, itp) = _event_ms(
            lambda: P["mega_pcg_plain"](*args, **kw), reps=1, warmup=0)
        err, rel = _errs(x, xp)
        # r is updated recursively, r -= alpha A p, with |alpha A p| far
        # above the converged |r|: its rounding scales with the RHS, and the
        # two versions' summation orders leave ~1e-9 of |v| there
        r_err = float((r - rp).abs().max()) / float(v.abs().max())
        if int(it) != int(itp) or not r_err < 1e-7:
            raise RuntimeError(f"mega_pcg {tag}: iters {int(it)} vs "
                               f"{int(itp)}, r error {r_err:.3e}")
        # 40 CG steps amplify the two versions' different summation orders
        # (per-block partial sums vs one reduction) by the system's
        # condition number; 1e-7 is the serving path's own bar
        report("mega_pcg", tag, err, rel, 1e-7, ms, pms)
        if tag.startswith("path"):
            nbytes, ops = _mega_cost(fs.D, fs.npad, B, fs.w_a, fs.w_p,
                                     fs.w_s, int(it))
            b_ms, b_by = _bound(nbytes, ops)
            rows.append(dict(name="mega_pcg", route="cuda",
                             source="src/repro_torch/csrc/mega_pcg.cu",
                             replaces="src/repro/kernels/mega_solve.py:268",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))
    return rows


def _operands(P, X, omega, sigma, q, dev):
    """The whole-solve operands a fit builds, from data on the card."""
    Xt = torch.as_tensor(X, device=dev)
    sort_idx = torch.argsort(Xt.T, dim=1, stable=True)
    xs = torch.gather(Xt.T, 1, sort_idx)
    om = torch.as_tensor(omega, device=dev)
    A, Phi = P["kp_factors"](q, om, xs)
    SAPhi = P["add"](P["scale"](A, sigma ** 2), Phi)
    rank_idx = torch.argsort(sort_idx, dim=1)
    return P["FusedSweep"](Phi.data, SAPhi.data, sort_idx, rank_idx,
                           sigma ** 2, w_p=Phi.lo, w_s=SAPhi.lo, a=A.data,
                           w_a=A.lo)


def main():
    _require_gpu()
    P = _import_port()
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "-i", str(dev.index),
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build = P["_build"]
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc in parallel, "
          f"{len(_build.SOURCES)} sources)", flush=True)

    D, n, B = D_PATH, N_PATH, B_PATH
    X, Y, f, bounds = P["sample_test_function"]("schwefel", n, D, seed=0)
    span = bounds[:, 1] - bounds[:, 0]
    omega, sigma = 8.0 / span, 1.0
    Xq = np.random.default_rng(100).uniform(bounds[:, 0], bounds[:, 1],
                                            size=(100, D))

    # the KP factor assembly (batched tiny SVDs) stays plain torch: time it
    xs = torch.sort(torch.as_tensor(X, device=dev).T, dim=1).values
    om = torch.as_tensor(omega, device=dev)
    _, kp_s = _sync_time(lambda: (P["kp_factors"](0, om, xs),
                                  P["gkp_factors"](0, om, xs)))
    print(f"kp factor assembly (plain torch, SVD batch) n={n} D={D}: "
          f"{kp_s * 1e3:.1f} ms", flush=True)

    rng = np.random.default_rng(0)
    ops_path = _operands(P, X, omega, sigma, 0, dev)
    # q = 1 operands on a jittered grid with omega * spacing ~ 0.1: at
    # q >= 1 the KP systems of clustered points are ill-conditioned enough
    # that PCG amplifies rounding chaotically (see ROADMAP Queue 3)
    span_q1 = 0.1 * N_Q1 / 4.0
    Xs = np.stack([rng.permutation((np.arange(N_Q1) + 0.5 + 0.3 * rng.uniform(
        -1, 1, N_Q1)) * span_q1 / N_Q1) for _ in range(D)], axis=1)
    ops_q1 = _operands(P, Xs, np.full(D, 4.0), sigma, 1, dev)
    rows = kernel_phase(P, rng, dev, (D, n, B), ops_path, ops_q1)
    del ops_path, ops_q1

    # --- main path at the paper's Fig. 5 point ----------------------------
    cfg = P["GPConfig"](q=0, solver="pcg", solver_iters=40, precond="none")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    gp, t_fit = _sync_time(lambda: P["fit"](cfg, X, Y, omega, sigma))
    mu, t_mean = _sync_time(lambda: P["posterior_mean"](gp, Xq))
    var, t_var = _sync_time(lambda: P["posterior_var"](gp, Xq))
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    mu_np, var_np = mu.cpu().numpy(), var.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mu_np - f(Xq)) ** 2)))
    verdict = P["verdict_name"](gp.health.verdict)
    print(f"main path n={n} D={D} q=0 iters=40: fit {t_fit * 1e3:.1f} ms, "
          f"posterior_mean(100) {t_mean * 1e3:.1f} ms, posterior_var(100) "
          f"{t_var * 1e3:.1f} ms; RMSE {rmse:.4f}; verdict {verdict}; "
          f"peak memory {peak / 2**20:.1f} MiB; launches {counts}",
          flush=True)
    if not (mu_np.shape == (100,) and var_np.shape == (100,)
            and np.isfinite(mu_np).all() and np.isfinite(var_np).all()
            and (var_np > 0).all() and verdict == "OK"):
        raise RuntimeError("main path output is not finite/positive/OK")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    for row in rows:
        row["launches"] = counts[row["name"]]

    # --- consistency: card vs plain CPU at the quickstart's size ----------
    Xc, Yc, _, bc = P["sample_test_function"]("schwefel", N_CHECK, D, seed=0)
    omc = 8.0 / (bc[:, 1] - bc[:, 0])
    Xqc = np.random.default_rng(1).uniform(bc[:, 0], bc[:, 1], (100, D))
    g_card = P["fit"](cfg, Xc, Yc, omc, 1.0)
    g_cpu = P["fit"](cfg, Xc, Yc, omc, 1.0, device="cpu")
    for name, fn in (("mean", P["posterior_mean"]),
                     ("var", P["posterior_var"])):
        a = fn(g_card, Xqc).cpu()
        b = fn(g_cpu, Xqc, device="cpu")
        rel = float((a - b).abs().max() / b.abs().max())
        print(f"consistency n={N_CHECK} D={D} {name}: card vs cpu max rel "
              f"{rel:.3e} (tol 1e-7)", flush=True)
        if not rel < 1e-7:
            raise RuntimeError(f"card vs cpu {name} disagree: {rel:.3e}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
