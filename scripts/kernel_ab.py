"""Time ``banded_lu`` at lo = hi = 0, the PCG kernels, ``block_cr``, the
Gauss-Seidel and Jacobi kernels, the variance band and ``kp_gram`` of one
checkout on an NVIDIA GPU, so two checkouts can be compared in one call.

    python scripts/kernel_ab.py run SRC OUT.json [lu|pcg|cr|gs|jacobi|rgf|kp]
    python scripts/kernel_ab.py table OUT_A.json OUT_B.json ...

``run`` imports the port from ``SRC`` (the ``src`` directory of the checkout
to time; its kernels are built under that checkout's ``build/``) and times,
at the main path's shapes (n = 30000, D = 10, q = 0; the Schwefel operands
of ``chip_smoke.py``):

1. ``banded_lu`` rows at B = 32, 16, 4, 1, first thing after the build
   (CUDA events over 20 calls, as ``chip_smoke.py`` times them);
2. the split of one ``banded_lu`` call: each kernel's device time from
   ``torch.profiler`` (per call, by kernel name), the wrapper's host time
   (enqueue, no synchronisation), one call between CUDA events after a
   synchronise, ``rhs / band`` and the full library equivalent
   ``rhs / band`` plus ``band.abs().log().sum(1)``, and the bound (bytes);
3. ``mega_pcg`` (40 iterations, cold) at B = 32, 160, 16 and 1, and one
   ``fused_pcg_iter`` launch at B = 32; where the checkout has the
   factored block CR, also the factor launch alone, the solve with the
   factors made beforehand, and the solve at each chunk width of
   ``CHUNK_WIDTHS`` (the default width is the kernel's own choice);
4. the ``banded_lu`` rows of 1. again, after the other work;
5. ``block_cr`` on the path's SAPhi (w = 1) at B = 1, 16, 32 and 160: the
   whole call (``block_cr``, uncached), and where the checkout has the
   factored standalone launches also the factor alone (with the
   log-determinant), the apply from a factor made beforehand at the
   kernel's own chunk width (``auto_cols``) and at each width of
   ``CHUNK_WIDTHS``, and the apply's device time from ``torch.profiler``;
6. the Gauss-Seidel kernel on the path's operands at B = 1, 16, 32 and
   160: one sweep with k (``fused_gauss_seidel_iter``, fused="on") and the
   40-sweep whole solve (``mega_gauss_seidel_solve``, fused="whole"), as a
   caller without a factor runs them; where the checkout solves from a held
   SAPhi factor, also both from a factor made beforehand, the kernel's own
   chunk width and grid, and the whole solve at each width of
   ``GS_WIDTHS``; each sweep's device time by kernel from
   ``torch.profiler``;
7. the Jacobi kernel the same way (alpha = 1/D): one sweep with k carried
   (``fused_jacobi_iter``) and the 40-sweep warm whole solve
   (``mega_jacobi_solve``), as a caller without factors runs them; where
   the checkout solves from held factors, also both from
   ``FusedSweep.cr_factors``, the kernel's own chunk width and grid, and
   the whole solve at each width of ``JACOBI_WIDTHS``; the sweep's device
   time by kernel.

8. the variance band (``rgf`` only): ``rgf_blocks`` on the path's own
   H = A Phi^T (w = 1, T = 30000) and on diagonally dominant random bands
   at w = 3, 5, 7 (n = 4000 and 30000 rows), by CUDA events and
   ``torch.profiler`` device time; ``band_matmul`` on the path's A and
   Phi^T split into device time, the wrapper's host time and one call
   between events, with its bound; the whole ``core.band_inverse.
   variance_band`` call split into its stages (``transpose``,
   ``band_band_matmul``, ``mask_band``, ``_to_blocks``, ``rgf_blocks``,
   ``_blocks_to_band``), each by events, and its device time by kernel;
   and SHA-256 digests of ``band_matmul``'s outputs and of the pcg path's
   mean, variance, log-likelihood and gradients, which ``table`` compares
   across the files.

9. ``kp_gram`` (``kp`` only) at n = 30000, q = 0 ... 3 on a jittered grid
   (omega = 4, A from ``kp_factors``): CUDA events over 20 calls, one call
   between events, the wrapper's host time, the device time by kernel
   (``torch.profiler``) and the bound (bytes); the host time split into
   the wrapper's steps, each timed alone with ``perf_counter_ns`` over
   ``HOST_REPS`` calls through the checkout's own helpers (backend
   resolution, the two tensor checks, the coefficients, ``torch.empty``,
   ``load_library``, the stream handle, the data pointers, the ctypes call
   without a launch (n = 0, refused before any CUDA call) and with it, the
   error check and count), beside the whole wrapper, ``ops.kp_gram`` and
   the ctypes floor (``repro_cr_apply_cols``, a host-only entry point);
   the launch floor (a one-element ``add_``: device time by
   ``torch.profiler``, host time); SHA-256 digests of Phi, which ``table``
   compares across the files; and the event and host times of
   ``band_matmul`` (the path's A Phi^T), ``banded_lu`` (w = 0, B = 32) and
   ``banded_matvec`` (A, B = 16), whose wrappers share ``_build``'s
   helpers.

To compare a parent with a change, unpack the parent with ``git archive``
into a git-ignored directory and run parent, change, change, parent in one
call; ``table`` prints the rows of each file side by side. ``lu`` as a
last argument times 1, 2 and 4 only; ``pcg`` times 3 without the chunk
widths; ``cr`` times 5 only; ``gs`` times 6 only; ``jacobi`` 7 only;
``rgf`` 8 only; ``kp`` 9 only.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

D, N, B_PATH = 10, 30000, 32
LU_B = (32, 16, 4, 1)
PCG_B = ((32, 3), (160, 1), (16, 3), (1, 3))  # (columns, timed reps)
CR_B = (1, 16, 32, 160)
CHUNK_WIDTHS = (1, 2, 4, 8, 16)
GS_B = ((1, 3), (16, 3), (32, 3), (160, 1))  # (columns, timed reps)
GS_WIDTHS = (1, 2, 4, 8)
JACOBI_WIDTHS = (1, 2, 4, 8, 16)
RGF_W = (3, 5, 7)
RGF_N = (4000, N)
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
KP_Q = (0, 1, 2, 3)
HOST_REPS = 1000


def _events(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _one_call(fn, tries=5):
    """Median of single calls, each between events after a synchronise."""
    out = []
    for _ in range(tries):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def _host_ms(fn, reps=20):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def _device_split(fn, reps=20):
    """Device ms per call by kernel name, from torch.profiler (events with
    their own device time: the kernels, not the host ops around them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            out[ev.key[:60]] = t / 1e3 / reps
    return out


def lu_rows(P, rng, dev, tag):
    rows = {}
    for B in LU_B:
        band = torch.as_tensor(rng.uniform(1.0, 2.0, (D, N, 1)), device=dev)
        rhs = torch.as_tensor(rng.standard_normal((D, N, B)), device=dev)
        ms = _events(lambda: P["banded_lu"](band, rhs, 0, 0), reps=20)
        rows[f"B={B}"] = ms
        print(f"{tag} banded_lu B={B}: {ms:.4f} ms (20-call events)",
              flush=True)
    return rows


def lu_split(P, rng, dev):
    rows = {}
    for B in LU_B:
        band = torch.as_tensor(rng.uniform(1.0, 2.0, (D, N, 1)), device=dev)
        rhs = torch.as_tensor(rng.standard_normal((D, N, B)), device=dev)
        call = lambda: P["banded_lu"](band, rhs, 0, 0)  # noqa: E731
        r = dict(
            events20_ms=_events(call, reps=20),
            one_call_ms=_one_call(call),
            host_ms=_host_ms(call),
            device_ms=_device_split(call),
            library_div_ms=_events(lambda: rhs / band, reps=20),
            library_div_device_ms=_device_split(lambda: rhs / band),
            library_full_ms=_events(
                lambda: (rhs / band, band.abs().log().sum(1)), reps=20),
            bound_ms=8 * (D * N + 2 * D * N * B + D) / MEM_BYTES_PER_S * 1e3)
        if P["lu_solve_flag"]:
            r["solve_only_ms"] = _events(
                lambda: P["banded_lu"](band, rhs, 0, 0, logdet=False),
                reps=20)
            r["logdet_only_ms"] = _events(
                lambda: P["banded_lu"](band, None, 0, 0, solve=False),
                reps=20)
        rows[f"B={B}"] = r
        print(f"banded_lu split B={B}: {json.dumps(r)}", flush=True)
    return rows


def _operands(P, dev):
    X, _, _, bounds = P["sample_test_function"]("schwefel", N, D, seed=0)
    span = bounds[:, 1] - bounds[:, 0]
    omega, sigma = 8.0 / span, 1.0
    Xt = torch.as_tensor(X, device=dev)
    sort_idx = torch.argsort(Xt.T, dim=1, stable=True)
    xs = torch.gather(Xt.T, 1, sort_idx)
    A, Phi = P["kp_factors"](0, torch.as_tensor(omega, device=dev), xs)
    SAPhi = P["add"](P["scale"](A, sigma ** 2), Phi)
    return P["FusedSweep"](Phi.data, SAPhi.data, sort_idx,
                           torch.argsort(sort_idx, dim=1), sigma ** 2,
                           w_p=Phi.lo, w_s=SAPhi.lo, a=A.data, w_a=A.lo)


def pcg_rows(P, rng, dev, widths=True):
    fs = _operands(P, dev)
    ops = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s)
    new = P["factored"]
    rows = {}
    for B, reps in PCG_B:
        v = fs.pad_state(torch.as_tensor(rng.standard_normal((D, N, B)),
                                         device=dev))
        x0 = torch.zeros_like(v)
        solve = lambda **extra: P["mega_pcg_solve"](  # noqa: E731
            *ops, v, x0, iters=40, **kw, **extra)
        r = {"whole_40_ms": _events(solve, reps=reps)}
        if new:
            r["auto_cols"] = P["pcg_solve_cols"](D, B)
            fac = P["pcg_factors"](fs)
            r["factor_ms"] = _events(lambda: P["pcg_factors"](fs), reps=3)
            r["whole_40_prefactored_ms"] = _events(
                lambda: solve(factors=fac), reps=reps)
            r["chunk_ms"] = {
                str(c): _events(lambda: solve(factors=fac, cols=c),
                                reps=reps)
                for c in CHUNK_WIDTHS if c <= B and widths}
        if B == B_PATH:
            st = P["pcg_seed"](*ops, v, x0, warm=False, **kw)
            r["fused_pcg_iter_ms"] = _events(
                lambda: P["fused_pcg_iter"](*ops, *st, **kw), reps=10)
        rows[f"B={B}"] = r
        print(f"mega_pcg B={B}: {json.dumps(r)}", flush=True)
    return rows


def cr_rows(P, rng, dev):
    fs = _operands(P, dev)
    band = fs.saphi
    rows = {}
    for B in CR_B:
        rhs = torch.as_tensor(rng.standard_normal((D, fs.npad, B)),
                              device=dev)
        r = {"block_cr_ms": _events(lambda: P["block_cr"](band, rhs, 1),
                                    reps=10)}
        if P["cr_apply"]:
            fac = P["block_cr_factor"](band, 1)
            r["factor_logdet_ms"] = _events(
                lambda: P["block_cr_factor"](band, 1, logdet=True), reps=10)
            r["auto_cols"] = P["block_cr_apply_cols"](D, B)
            apply = lambda **k: P["block_cr_apply"](  # noqa: E731
                fac, rhs, 1, **k)
            r["apply_ms"] = _events(apply, reps=20)
            r["apply_device_ms"] = _device_split(apply)
            r["chunk_ms"] = {str(c): _events(lambda: apply(cols=c), reps=20)
                             for c in CHUNK_WIDTHS if c <= B}
        rows[f"B={B}"] = r
        print(f"block_cr B={B}: {json.dumps(r)}", flush=True)
    return rows


def gs_rows(P, rng, dev):
    fs = _operands(P, dev)
    ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s)
    rows = {}
    for B, reps in GS_B:
        v = fs.pad_state(torch.as_tensor(rng.standard_normal((D, N, B)),
                                         device=dev))
        x0 = fs.pad_state(torch.as_tensor(
            0.1 * rng.standard_normal((D, N, B)), device=dev))
        sweep = lambda **extra: P["fused_gauss_seidel_iter"](  # noqa: E731
            *ops, v, x0, want_resid=True, **kw, **extra)
        whole = lambda **extra: P["mega_gauss_seidel_solve"](  # noqa: E731
            *ops, v, x0, iters=40, **kw, **extra)
        r = {"sweep_ms": _events(sweep, reps=10),
             "whole_40_ms": _events(whole, reps=reps)}
        if P["gs_factored"]:
            fac = fs.saphi_factor()
            r["auto_cols"] = P["gauss_seidel_cols"](B)
            r["grid"] = P["gauss_seidel_grid"]()
            r["sweep_prefactored_ms"] = _events(
                lambda: sweep(factors=fac), reps=10)
            r["whole_40_prefactored_ms"] = _events(
                lambda: whole(factors=fac), reps=reps)
            r["chunk_ms"] = {str(c): _events(
                lambda: whole(factors=fac, cols=c), reps=reps)
                for c in GS_WIDTHS if c <= B}
            r["sweep_device_ms"] = _device_split(lambda: sweep(factors=fac))
        else:
            r["sweep_device_ms"] = _device_split(sweep)
        rows[f"B={B}"] = r
        print(f"gauss_seidel B={B}: {json.dumps(r)}", flush=True)
    return rows


def jacobi_rows(P, rng, dev):
    fs = _operands(P, dev)
    ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    kw = dict(w_p=fs.w_p, w_s=fs.w_s, alpha=1.0 / D)
    rows = {}
    for B, reps in GS_B:
        v, x0, k = (fs.pad_state(torch.as_tensor(
            sc * rng.standard_normal((D, N, B)), device=dev))
            for sc in (1.0, 0.1, 0.1))
        sweep = lambda **extra: P["fused_jacobi_iter"](  # noqa: E731
            *ops, v, x0, k, **kw, **extra)
        whole = lambda **extra: P["mega_jacobi_solve"](  # noqa: E731
            *ops, v, x0, iters=40, warm=True, **kw, **extra)
        r = {"sweep_ms": _events(sweep, reps=10),
             "whole_40_ms": _events(whole, reps=reps)}
        if P["jacobi_factored"]:
            fac = fs.cr_factors()
            r["auto_cols"] = P["jacobi_cols"](D, B)
            r["grid"] = P["jacobi_grid"]()
            r["sweep_prefactored_ms"] = _events(
                lambda: sweep(factors=fac), reps=10)
            r["whole_40_prefactored_ms"] = _events(
                lambda: whole(factors=fac), reps=reps)
            r["chunk_ms"] = {str(c): _events(
                lambda: whole(factors=fac, cols=c), reps=reps)
                for c in JACOBI_WIDTHS if c <= B}
            r["sweep_device_ms"] = _device_split(lambda: sweep(factors=fac))
        else:
            r["sweep_device_ms"] = _device_split(sweep)
        rows[f"B={B}"] = r
        print(f"jacobi B={B}: {json.dumps(r)}", flush=True)
    return rows


def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _band(rng, G, n, w, dev):
    """Diagonally dominant (G, n, 2w+1) band, zero out-of-range entries."""
    data = rng.standard_normal((G, n, 2 * w + 1))
    i = np.arange(n)[:, None]
    j = i + np.arange(-w, w + 1)[None, :]
    data = np.where((j >= 0) & (j < n), data, 0.0)
    data[..., w] = np.abs(data).sum(-1) + 1.0
    return torch.as_tensor(data, device=dev)


def rgf_rows(P, rng, dev):
    X, _, _, bounds = P["sample_test_function"]("schwefel", N, D, seed=0)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    Xt = torch.as_tensor(X, device=dev)
    xs = torch.sort(Xt.T, dim=1).values
    A, Phi = P["kp_factors"](0, torch.as_tensor(omega, device=dev), xs)
    rows = {}
    # band_matmul: H = A Phi^T on the path's operands
    PhiT = P["transpose"](Phi)
    a, b = A.data.contiguous(), PhiT.data.contiguous()
    wid = (A.lo, A.hi, PhiT.lo, PhiT.hi)
    call = lambda: P["band_matmul"](a, b, *wid)  # noqa: E731
    wa, wb = a.shape[-1], b.shape[-1]
    r = dict(events20_ms=_events(call, reps=20), one_call_ms=_one_call(call),
             host_ms=_host_ms(call), device_ms=_device_split(call),
             bound_ms=8 * D * N * (wa + wb + wa + wb - 1) / MEM_BYTES_PER_S
             * 1e3, digest=_digest(call()))
    a1, b1 = _band(rng, D, 4000, 2, dev), _band(rng, D, 4000, 1, dev)
    r["q1_events20_ms"] = _events(
        lambda: P["band_matmul"](a1, b1, 2, 2, 1, 1), reps=20)
    r["q1_digest"] = _digest(P["band_matmul"](a1, b1, 2, 2, 1, 1))
    rows["band_matmul"] = r
    print(f"band_matmul: {json.dumps(r)}", flush=True)
    # the whole variance band and its stages
    H = P["mask_band"](P["band_band_matmul"](A, PhiT))
    hw = A.lo + Phi.lo
    w = max(H.lo, H.hi, hw, 1)
    blocks = [t.contiguous() for t in P["_to_blocks"](H.data, H.lo, H.hi, w)]
    G3 = P["rgf_blocks"](*blocks)
    stages = {
        "variance_band": lambda: P["variance_band"](A, Phi),
        "transpose": lambda: P["transpose"](Phi),
        "band_band_matmul": lambda: P["band_band_matmul"](A, PhiT),
        "mask_band": lambda: P["mask_band"](H),
        "_to_blocks": lambda: P["_to_blocks"](H.data, H.lo, H.hi, w),
        "rgf_blocks": lambda: P["rgf_blocks"](*blocks),
        "_blocks_to_band": lambda: P["_blocks_to_band"](*G3, N, hw)}
    r = {k: _events(f, reps=20) for k, f in stages.items()}
    r["variance_band_one_call_ms"] = _one_call(stages["variance_band"])
    r["variance_band_device_ms"] = _device_split(stages["variance_band"])
    rows["variance_band"] = r
    print(f"variance_band: {json.dumps(r)}", flush=True)
    # rgf_blocks: the path's H, then random bands at q = 1, 2, 3 widths
    call = lambda: P["rgf_blocks"](*blocks)  # noqa: E731
    rows["rgf w=1 path T=30000"] = dict(
        events_ms=_events(call, reps=20), one_call_ms=_one_call(call),
        device_ms=_device_split(call), digest=_digest(*call()))
    print(f"rgf path: {json.dumps(rows['rgf w=1 path T=30000'])}",
          flush=True)
    for wq in RGF_W:
        for n in RGF_N:
            h = _band(rng, D, n, wq, dev)
            bl = [t.contiguous() for t in P["_to_blocks"](h, wq, wq, wq)]
            call = lambda: P["rgf_blocks"](*bl)  # noqa: E731
            k = f"rgf w={wq} n={n} T={bl[0].shape[1]}"
            rows[k] = dict(events_ms=_events(call, reps=5),
                           device_ms=_device_split(call, reps=5))
            print(f"{k}: {json.dumps(rows[k])}", flush=True)
    # the pcg path's outputs (those that do not read the variance band
    # must keep their bits)
    Y = torch.as_tensor(P["sample_test_function"]("schwefel", N, D, seed=0)[1])
    cfg = P["GPConfig"](q=0, solver="pcg", solver_iters=40, precond="none")
    gp = P["fit"](cfg, X, Y.numpy(), omega, 1.0)
    Xq = np.random.default_rng(100).uniform(bounds[:, 0], bounds[:, 1],
                                            size=(100, D))
    gen = torch.Generator().manual_seed(0)
    outs = dict(mean=P["posterior_mean"](gp, Xq),
                var=P["posterior_var"](gp, Xq[:32]),
                log_likelihood=P["log_likelihood"](gp, gen),
                mll_gradients=torch.cat([t.reshape(-1) for t in
                                         P["mll_gradients"](gp, gen)]))
    rows["digests"] = {k: _digest(v) for k, v in outs.items()}
    return rows


def _ns_ms(fn, reps=HOST_REPS):
    """Host ms per call of ``fn``: ``perf_counter_ns`` around ``reps``
    calls, no synchronisation inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t = (time.perf_counter_ns() - t0) / reps / 1e6
    torch.cuda.synchronize()
    return t


def _kp_host_split(P, q, xs, a):
    """The kp_gram wrapper's host time, step by step, each step alone over
    HOST_REPS calls through the checkout's own helpers (a checkout that
    caches the coefficients is timed reading its cache)."""
    kpm, b = P["kp_module"], P["_build"]
    n, dev = xs.shape[0], xs.device
    lib = b.load_library()
    fn = lib.repro_kp_gram_f64
    phi = torch.empty((n, 2 * q + 1), dtype=torch.float64, device=dev)
    if hasattr(kpm, "_COEFFS"):
        coeffs = lambda: kpm._COEFFS[q]  # noqa: E731
    else:
        coeffs = lambda: P["poly_coeffs"](q) + [0.0] * (3 - q)  # noqa: E731
    c = list(coeffs())
    ptrs = (xs.data_ptr(), a.data_ptr(), phi.data_ptr())
    s = b.stream_handle(dev)
    steps = {
        "resolve_backend": lambda: P["resolve_backend"](None, xs.device),
        "expect x2": lambda: (
            b.expect(xs, "xs", torch.float64, (n,), dev),
            b.expect(a, "a_band", torch.float64, (n, 2 * q + 3), dev)),
        "coefficients": coeffs,
        "torch.empty": lambda: torch.empty((n, 2 * q + 1),
                                           dtype=torch.float64, device=dev),
        "load_library": b.load_library,
        "stream_handle": lambda: b.stream_handle(dev),
        "data_ptr x3": lambda: (xs.data_ptr(), a.data_ptr(),
                                phi.data_ptr()),
        "ctypes, no launch": lambda: fn(*ptrs, 0, q, 4.0, *c, s),
        "ctypes with launch": lambda: fn(*ptrs, n, q, 4.0, *c, s),
        "check + count": lambda: (b.check(0, "kp_gram"),
                                  b.count_launch("kp_gram")),
    }
    r = {k: _ns_ms(f) for k, f in steps.items()}
    r["sum of steps"] = sum(r.values())
    r["timer pair"] = _ns_ms(lambda: time.perf_counter_ns())
    r["wrapper"] = _ns_ms(lambda: P["kp_gram"](q, 4.0, xs, a))
    r["ops.kp_gram"] = _ns_ms(lambda: P["ops_kp_gram"](q, 4.0, xs, a))
    r["ctypes floor (repro_cr_apply_cols)"] = _ns_ms(
        lambda: lib.repro_cr_apply_cols(D, 16))
    return r


def kp_rows(P, rng, dev):
    """kp_gram at n = 30000, q = 0 ... 3 (item 9 of the docstring), then
    the launch floor and the other host-bound wrappers."""
    span = 0.1 * N / 4.0
    x = (np.arange(N) + 0.5 + 0.3 * rng.uniform(-1, 1, N)) * span / N
    xs = torch.as_tensor(np.sort(x), device=dev)
    om = torch.tensor(4.0, dtype=torch.float64, device=dev)
    rows = {}
    for q in KP_Q:
        A, _ = P["kp_factors"](q, om, xs)
        a = A.data.contiguous()
        call = lambda: P["kp_gram"](q, 4.0, xs, a)  # noqa: E731
        r = dict(events20_ms=_events(call, reps=20),
                 one_call_ms=_one_call(call),
                 host_ms=_ns_ms(call),
                 device_ms=_device_split(call),
                 bound_ms=8 * N * (1 + 2 * q + 3 + 2 * q + 1)
                 / MEM_BYTES_PER_S * 1e3,
                 digest=_digest(call()))
        r["host_split_ms"] = _kp_host_split(P, q, xs, a)
        rows[f"q={q}"] = r
        print(f"kp_gram q={q}: {json.dumps(r)}", flush=True)
    one = torch.zeros(1, dtype=torch.float64, device=dev)
    add = lambda: one.add_(1.0)  # noqa: E731
    rows["launch floor"] = dict(add_device_ms=_device_split(add),
                                add_host_ms=_ns_ms(add),
                                add_events20_ms=_events(add, reps=20))
    print(f"launch floor: {json.dumps(rows['launch floor'])}", flush=True)
    X, _, _, bounds = P["sample_test_function"]("schwefel", N, D, seed=0)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    xs = torch.sort(torch.as_tensor(X, device=dev).T, dim=1).values
    A, Phi = P["kp_factors"](0, torch.as_tensor(omega, device=dev), xs)
    PhiT = P["transpose"](Phi)
    a, b = A.data.contiguous(), PhiT.data.contiguous()
    lu_band = torch.as_tensor(rng.uniform(1.0, 2.0, (D, N, 1)), device=dev)
    lu_rhs = torch.as_tensor(rng.standard_normal((D, N, B_PATH)),
                             device=dev)
    mv_x = torch.as_tensor(rng.standard_normal((D, N, 16)), device=dev)
    others = {
        "band_matmul": lambda: P["band_matmul"](a, b, A.lo, A.hi, PhiT.lo,
                                                PhiT.hi),
        "banded_lu w=0 B=32": lambda: P["banded_lu"](lu_band, lu_rhs, 0, 0),
        "banded_matvec A B=16": lambda: P["banded_matvec"](a, mv_x, A.lo,
                                                           A.hi)}
    for k, f in others.items():
        out = f()
        rows[k] = dict(events20_ms=_events(f, reps=20),
                       host_ms=_ns_ms(f, reps=200),
                       digest=_digest(*(out if isinstance(out, tuple)
                                        else (out,))))
        print(f"{k}: {json.dumps(rows[k])}", flush=True)
    return rows


def run(src, out, parts="all"):
    sys.path.insert(0, src)
    from repro_torch.core import (GPConfig, fit, log_likelihood,
                                  mll_gradients, posterior_mean,
                                  posterior_var)
    from repro_torch.core.band_inverse import (_blocks_to_band, _to_blocks,
                                               variance_band)
    from repro_torch.core.banded import (add, band_band_matmul, mask_band,
                                         scale, transpose)
    from repro_torch.core.kernel_packets import kp_factors
    from repro_torch.kernels.band_matmul import band_matmul
    from repro_torch.kernels.rgf import rgf_blocks
    from repro_torch.data import sample_test_function
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_cr as bcr
    from repro_torch.kernels import fused_sweep as fsm
    from repro_torch.kernels.banded_lu import banded_lu
    from repro_torch.kernels.banded_matvec import banded_matvec
    from repro_torch.core.matern import _poly_coeffs
    from repro_torch.kernels import kp_gram as kpm
    from repro_torch.kernels import ops
    from repro_torch.kernels.mega_solve import (mega_gauss_seidel_solve,
                                                mega_jacobi_solve,
                                                mega_pcg_solve)

    P = dict(add=add, scale=scale, kp_factors=kp_factors,
             sample_test_function=sample_test_function, banded_lu=banded_lu,
             FusedSweep=fsm.FusedSweep, mega_pcg_solve=mega_pcg_solve,
             pcg_seed=fsm.pcg_seed, fused_pcg_iter=fsm.fused_pcg_iter,
             fused_gauss_seidel_iter=fsm.fused_gauss_seidel_iter,
             mega_gauss_seidel_solve=mega_gauss_seidel_solve,
             fused_jacobi_iter=fsm.fused_jacobi_iter,
             mega_jacobi_solve=mega_jacobi_solve, GPConfig=GPConfig,
             fit=fit, posterior_mean=posterior_mean,
             posterior_var=posterior_var, log_likelihood=log_likelihood,
             mll_gradients=mll_gradients, _to_blocks=_to_blocks,
             _blocks_to_band=_blocks_to_band, variance_band=variance_band,
             band_band_matmul=band_band_matmul, mask_band=mask_band,
             transpose=transpose, band_matmul=band_matmul,
             rgf_blocks=rgf_blocks, banded_matvec=banded_matvec,
             _build=_build, kp_module=kpm, kp_gram=kpm.kp_gram,
             ops_kp_gram=ops.kp_gram, resolve_backend=ops.resolve_backend,
             poly_coeffs=_poly_coeffs)
    P["gs_factored"] = hasattr(fsm, "gauss_seidel_cols")
    if P["gs_factored"]:
        P["gauss_seidel_cols"] = fsm.gauss_seidel_cols
        P["gauss_seidel_grid"] = fsm.gauss_seidel_grid
    P["jacobi_factored"] = hasattr(fsm, "jacobi_cols")
    if P["jacobi_factored"]:
        P["jacobi_cols"] = fsm.jacobi_cols
        P["jacobi_grid"] = fsm.jacobi_grid
    P["lu_solve_flag"] = "solve" in inspect.signature(banded_lu).parameters
    P["factored"] = hasattr(fsm, "pcg_factors")
    P["block_cr"] = bcr.block_cr
    P["cr_apply"] = hasattr(bcr, "block_cr_apply")
    if P["cr_apply"]:
        for k in ("block_cr_factor", "block_cr_apply",
                  "block_cr_apply_cols"):
            P[k] = getattr(bcr, k)
    if P["factored"]:
        P["pcg_factors"] = lambda fs: fsm.pcg_factors(
            fs.phi, fs.saphi, w_p=fs.w_p, w_s=fs.w_s)
        P["pcg_solve_cols"] = fsm.pcg_solve_cols
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{src}: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    res = dict(src=src, card=smi, build_s=time.perf_counter() - t0)
    rng = np.random.default_rng(0)
    if parts == "rgf":
        res["rgf"] = rgf_rows(P, rng, dev)
    elif parts == "kp":
        res["kp"] = kp_rows(P, rng, dev)
    elif parts == "cr":
        res["cr"] = cr_rows(P, rng, dev)
    elif parts == "gs":
        res["gs"] = gs_rows(P, rng, dev)
    elif parts == "jacobi":
        res["jacobi"] = jacobi_rows(P, rng, dev)
    else:
        if parts != "pcg":
            res["lu_first"] = lu_rows(P, rng, dev, "first")
            res["lu_split"] = lu_split(P, rng, dev)
        if parts != "lu":
            res["pcg"] = pcg_rows(P, rng, dev, widths=parts != "pcg")
        if parts != "pcg":
            res["lu_again"] = lu_rows(P, rng, dev, "again")
        if parts == "all":
            res["cr"] = cr_rows(P, rng, dev)
            res["gs"] = gs_rows(P, rng, dev)
            res["jacobi"] = jacobi_rows(P, rng, dev)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


def table(*paths):
    runs = [json.load(open(p)) for p in paths]
    print("card:", runs[0]["card"])
    print("columns:", " | ".join(r["src"] for r in runs))

    def line(name, get):
        vals = []
        for r in runs:
            try:
                vals.append(f"{get(r):.4f}")
            except (KeyError, TypeError):
                vals.append("-")
        print(f"{name:42s} " + " | ".join(vals))

    def has(part):
        return any(part in r for r in runs)

    if has("rgf"):
        keys = [k for k in runs[0]["rgf"] if k != "digests"]
        for k in keys:
            for f, v in runs[0]["rgf"][k].items():
                if isinstance(v, float):
                    line(f"{k} {f}", lambda r: r["rgf"][k][f])
            for r in runs:
                for f in ("device_ms", "variance_band_device_ms"):
                    if f in r["rgf"].get(k, {}):
                        print(f"  {k} {f} ({r['src']}): {r['rgf'][k][f]}")
        ref = dict(runs[0]["rgf"]["digests"],
                   band_matmul=runs[0]["rgf"]["band_matmul"]["digest"],
                   band_matmul_q1=runs[0]["rgf"]["band_matmul"]["q1_digest"])
        for r in runs[1:]:
            got = dict(r["rgf"]["digests"],
                       band_matmul=r["rgf"]["band_matmul"]["digest"],
                       band_matmul_q1=r["rgf"]["band_matmul"]["q1_digest"])
            print(f"{r['src']} == {runs[0]['src']} bit for bit: "
                  f"{ {k: got[k] == v for k, v in ref.items()} }")
    if has("kp"):
        for k, v in runs[0]["kp"].items():
            for f, x in v.items():
                if isinstance(x, float):
                    line(f"kp {k} {f}", lambda r: r["kp"][k][f])
                elif f == "host_split_ms":
                    for s in x:
                        line(f"kp {k} host us: {s}",
                             lambda r: 1e3 * r["kp"][k][f][s])
            for r in runs:
                if "device_ms" in v:
                    print(f"  kp {k} device ({r['src']}): "
                          f"{r['kp'][k]['device_ms']}")
        for r in runs[1:]:
            same = {k: r["kp"][k]["digest"] == v["digest"]
                    for k, v in runs[0]["kp"].items() if "digest" in v}
            print(f"{r['src']} == {runs[0]['src']} bit for bit: {same}")
    for part, name, widths in (("jacobi", "jacobi", JACOBI_WIDTHS),
                               ("gs", "gauss_seidel", GS_WIDTHS)):
        for B, _ in GS_B if has(part) else ():
            k = f"B={B}"
            for f in ("sweep_ms", "sweep_prefactored_ms", "whole_40_ms",
                      "whole_40_prefactored_ms", "auto_cols", "grid"):
                line(f"{name} {k} {f}", lambda r: r[part][k][f])
            for c in widths:
                line(f"{name} {k} whole_40 chunk {c}",
                     lambda r: r[part][k]["chunk_ms"][str(c)])
            for r in runs:
                if part in r:
                    print(f"  sweep device {k} ({r['src']}): "
                          f"{r[part][k]['sweep_device_ms']}")
    for B in CR_B if has("cr") else ():
        k = f"B={B}"
        for f in ("block_cr_ms", "factor_logdet_ms", "apply_ms", "auto_cols"):
            line(f"block_cr {k} {f}", lambda r: r["cr"][k][f])
        for c in CHUNK_WIDTHS:
            line(f"block_cr {k} apply chunk {c}",
                 lambda r: r["cr"][k]["chunk_ms"][str(c)])
        for r in runs:
            if "cr" in r and "apply_device_ms" in r["cr"][k]:
                print(f"  apply device {k} ({r['src']}): "
                      f"{r['cr'][k]['apply_device_ms']}")
    for B in LU_B if has("lu_first") else ():
        k = f"B={B}"
        line(f"banded_lu {k} first", lambda r: r["lu_first"][k])
        line(f"banded_lu {k} again", lambda r: r["lu_again"][k])
        for f in ("events20_ms", "one_call_ms", "host_ms", "library_div_ms",
                  "library_full_ms", "solve_only_ms", "logdet_only_ms",
                  "bound_ms"):
            line(f"banded_lu {k} {f}", lambda r: r["lu_split"][k][f])
        for r in runs:
            if "lu_split" in r:
                print(f"  device split {k} ({r['src']}): "
                      f"{r['lu_split'][k]['device_ms']}, rhs / band "
                      f"{r['lu_split'][k].get('library_div_device_ms')}")
    for B, _ in PCG_B if has("pcg") else ():
        k = f"B={B}"
        for f in ("whole_40_ms", "whole_40_prefactored_ms", "factor_ms",
                  "fused_pcg_iter_ms", "auto_cols"):
            line(f"mega_pcg {k} {f}", lambda r: r["pcg"][k][f])
        for c in CHUNK_WIDTHS:
            line(f"mega_pcg {k} chunk {c}",
                 lambda r: r["pcg"][k]["chunk_ms"][str(c)])


if __name__ == "__main__":
    cmd, *args = sys.argv[1:]
    {"run": run, "table": table}[cmd](*args)
