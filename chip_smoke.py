"""Drive the PyTorch port's serving, hyperparameter-learning, relaxation,
default-configuration (kernel multigrid), per-iteration PCG, Bayesian
optimisation, streaming, q = 3, fleet, health, pivoted-LU and substrate
paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
one process per source), then:

1. kernel phase: each kernel on seeded float64 inputs at the main path's
   shapes (n = 30000, D = 10, q = 0) and at q = 1, 2 and 3 widths, held
   against its plain PyTorch version on the same CUDA tensors; errors,
   times, bounds. The block CR runs as its two launches: the factor (with
   the log-determinant) and the apply from a held factor, the apply timed
   at each column-chunk width and required to give the same bits at every
   width and in the whole call. The relaxation kernels (one sweep, and the
   whole solve, of Jacobi and Gauss-Seidel) and the per-iteration PCG
   kernel (its seed and one carried iteration) run on the main path's own
   operands, where the bar follows the systems' conditioning (the sweeps'
   backward error held to the plain version's, ``relax_kernel_phase``),
   and a host loop of single sweeps is held to the whole solve bit for
   bit; the relaxation rows solve from the block-CR factors the operand
   stack holds and print their chunk width, grid and, at the main shape,
   their time bars (``TIME_BARS``); ``kp_gram`` at q = 0 ... 3 against its
   plain version, its plain twin in the kernel's order and the fit's Phi
   band, with its event, device and host times beside the launch floor
   (a one-element ``add_``, a ctypes call that launches nothing).
   ``rgf_blocks`` (block cyclic reduction with selected inversion on the
   card, the RGF order on the CPU) is held against the RGF order's plain
   version (1e-10) and against its plain twin in the card's order
   (1e-12). The half-width-4 instantiations of the backfitting kernels
   (q = 3) are held the same way on a jittered q = 3 grid at the main
   shape (``w4_kernel_phase``); the block CR's wide instantiation (w = 8
   and 7, pivoted) at the q = 3 streaming patch shape (``wide_cr_rows``).
   The rgf, kp_gram and backfitting kernels'
   registers and spill bytes are printed from the build's ptxas report;
2. paths on Schwefel data, n = 30000, D = 10 (the paper's Fig. 5 point):
   the serving path ``fit`` -> ``posterior_mean`` -> ``posterior_var`` on
   100 queries; on its fit's own H = A Phi^T the rgf kernel's error
   against an RGF in extended precision on the host, at most twice the
   float64 RGF's (``variance_band_phase``), and the whole
   ``variance_band`` call's time; then the learning path
   ``log_likelihood`` -> ``mll_gradients`` -> ``fit_hyperparams(steps=3)``,
   then ``fit`` ->
   ``posterior_mean(100)`` -> ``posterior_var(32)`` with
   ``solver="gauss_seidel"`` and ``"jacobi"``, each with ``fused="auto"``
   (the whole-solve kernels) and ``"on"`` (one launch per sweep); the
   kernels layer's ``ops.kp_gram`` over the fit's factors; the reference's
   default ``GPConfig(q=0)`` (precond "auto" -> kmg, 50 iterations) through
   ``fit`` -> mean(100) -> var(100) -> ``log_likelihood`` ->
   ``mll_gradients``, then a ``torch.profiler`` trace of one variance
   chunk (device time by kernel group, idle share);
   ``benchmarks/multigrid.py``'s problem (n = 4096, 16384) against its
   recorded iteration counts; pcg with ``fused="on"`` (``fit``,
   ``posterior_var(32)``) and "on" == "whole" bit for bit; a tol-exit PCG
   over 300 columns (column chunks in lockstep under one exit) against the
   plain PCG over all of them; Bayesian optimisation on the pcg "whole"
   GP (``bo_phase``: the acquisition at m = 32, ``posterior_mean_grad``,
   ``propose_next``, three rounds of ``bayes_opt_loop`` from n_init =
   30000); streaming (Sec. 6): a padded against an unpadded fit on the
   card (``padded_parity``), then ``fit(capacity=32768)`` and 32 inserts
   and 32 evicts with ``count=`` for pcg "whole" and the default kmg, each
   mutation timed with its launches (identical across a kind), host syncs
   and peak memory (flat), the gaps to fresh fits held to the JAX
   package's own (``STREAM_BARS``), the windowed band against the full
   recompute and ``resync_gband`` (``stream_phase``); one insert and
   evict per relaxation solver and fused mode, a jittered q = 3 stream
   (the wide block CR) and a jittered q = 0 one (windowed band within
   1e-10, window rows within 1e-11 of a fresh fit's:
   ``mutation_paths``); ``GPServeEngine`` with 32 slots (fence, versions,
   window mode, a capacity doubling: ``engine_phase``) and
   ``bayes_opt_loop(BOConfig())`` (``bo_default_phase``); q = 3 with pcg
   "off", "whole" and "on" through ``fit`` ->
   mean(100) -> var(32) -> ``log_likelihood``, and Gauss-Seidel and
   Jacobi "whole" and "on" through var(32), "on" equal to "whole" bit for
   bit. Each path with every kernel's launch count over it;
   The fleet (``core.fleet``, ``fleet_phase``): T = 64 tenants (Schwefel,
   1500-2000 points each in capacity 2048, D = 10, q = 0, pcg "whole")
   through ``fleet_fit``, ``fleet_posterior_mean`` / ``_var`` (32 queries
   a tenant), ``fleet_acquisition_stats``, a masked ``fleet_insert`` and
   ``fleet_evict`` (half the lanes) and a ``GPFleetEngine`` tick (two
   capacity tiers x 8 slots), each beside the same work as 64 standalone
   calls, with launches and host syncs required equal at T = 8; the
   tenant-axis PCG launches against their plain versions and the single
   launches they replace (``fleet_kernel_rows``); T = 4 at n = 30000,
   each lane against its standalone GP, a T = 1 fleet equal to the single
   GP, "on" == "whole", q = 3 tenants, card vs CPU (``fleet_lanes``).
   The fleet's other solvers (``fleet_solvers_phase``): ``fleet_fit(
   GPConfig())`` (kmg, unfused) at T = 4, n = 30000 through the queries
   and a masked insert and evict, each op beside the 4 standalone default
   calls and each lane against its standalone GP (1e-7); T = 64 small
   fleets with Jacobi and Gauss-Seidel "whole" and "on" and pcg "off"
   (launches and syncs equal at T = 8) beside 64 standalone calls; q = 3
   relaxation fleets (the "_w4" kernels); the four tenant-axis relaxation
   kernels' rows at T = 64 (npad 2048), T = 4 (n = 30000) and q = 3, each
   lane bit for bit against its one-system launch; card vs CPU at T = 4,
   n = 500 for Jacobi, Gauss-Seidel, "off" and kmg.
   The pivoted LU route (``pivot_lu_phase``): ``GPConfig(pivot=True,
   solve_alg="lu")`` at n = 30000 (kmg, unfused) through ``fit`` ->
   mean(100) -> var(100) -> ``log_likelihood`` -> ``mll_gradients``, with
   ``banded_lu_pivot`` launched and no block-CR or fused kernel; the
   kernel against its plain version on the path's SAPhi, a (2, 2) band,
   an asymmetric band that forces swaps and the q = 3 patch shape
   (``pivot_kernel_rows``).
   The substrate (``substrate_phase``): a one-rank NCCL process group and
   ``elastic_mesh(model=1)``; the T = 64 fleet's data placed on that
   ``DeviceMesh`` by ``fleet_pspecs`` / ``device_put``, fitted and
   queried on the rank's local shards, bit for bit the unplaced fleet
   with the same launches; the fitted fleet checkpointed and moved by
   ``reshard_tree`` onto a fresh ``elastic_mesh(model=1, ranks=[0])``,
   queried bit for bit; ``ServeEngine`` (a greedy stub) and
   ``ShardedBatches`` on the card.
   The health ladder (``health_phase``): faults injected into the pcg
   "whole" GP and a default ``GPConfig()`` (kmg) GP at n = 30000 and
   repaired by ``health.ladder.repair``, each trail held to the rungs the
   CPU tests pin for the same config and each rung timed; the repaired
   queries within 1e-10 of the healthy GP or a clean card fit; a
   ``GPServeEngine``'s fence repair and query quarantine; a
   ``GPFleetEngine`` quarantine of one of the T = 64 tenants, the others
   bit for bit; a checkpoint round trip of the kmg GP.
3. consistency at n = 4000, D = 10, the card against ``device="cpu"``
   (plain versions), all within 1e-7. The CPU side runs in
   ``REF_WORKERS`` spawned worker processes started at the top of
   ``main()`` (one task a section, their probe draws made upfront from
   the one generator), beside the card phases; the comparisons stay
   here. On the quickstart's Schwefel data the
   q = 0 mean, variance and log-likelihood, pcg with ``fused="on"``, kmg,
   and both relaxation solvers in every fused mode; on a jittered grid the
   q = 0 gradients, a q = 1, a q = 2 and a q = 3 fit, mean, variance and
   log-likelihood (at q = 3 the card's fit is redone from the CPU fit's
   KP factors: the two LAPACK builds' q = 3 null vectors differ). The
   same probe blocks are fed to both sides (8 probes
   for the gradients, one variance chunk of 32 queries on the Schwefel
   data, 8 for kmg). On the Schwefel data, whose gradient factor B is
   ill-conditioned, the gradients are compared from the same factors and
   the block-CR kernels' backward error on that B is held against the
   plain version's (``schwefel_same_factors``); the q = 3 gradients are
   gated the same way, and the q = 3 fused solves (pcg "whole" and "on",
   the relaxation solvers' "whole") are held from the same factors. For
   Bayesian optimisation: the acquisition value and gradient (UCB, EI)
   and the mean's gradient on the Schwefel data and at q = 1, the card's
   gradients against central differences of its own mean and variance at
   q = 0 and 1 (1e-4), and the dense local cache against the operator
   path (n = 512, D = 5, q = 1; 1e-8); streaming from one carried padded
   state (pcg 4 + 4 mutations, kmg 1 + 1; ``stream_consistency``); the
   pivoted LU route (``pivot_consistency``: Schwefel mean, variance,
   likelihood and the gradients' B solves from the same factors, kmg at
   n = 1500, jittered q = 0 gradients and q = 1, 4 + 4 mutations of
   ``solve_alg="lu"`` GPs, unpivoted and pivoted). The
   q = 3 and q = 2 card-vs-CPU checks run at n = 2000 and 4000
   (``N_Q3_CHECK``, ``N_Q2_CHECK``).
4. every single-GP output of ``scripts/single_bits.py`` bit for bit
   against the digests of the tree before the fleet's tenant axis
   (``single_bits_phase``).

Prints the card's name and power limit, the elapsed time after each
phase and each worker section's time, one ``{"kernels": [...]}`` line,
and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and no result line is printed. Needs one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# the main path's shape (the Fig. 5 --full point), the q = 1 check size,
# and the card-vs-CPU consistency size (the quickstart's); Q_PATH is the
# probe count of the likelihood path (GPConfig's logdet/trace probes),
# Q_CHECK that of the card-vs-CPU gradients, cut to keep the CPU side's
# plain gradient solves (D Q columns) inside the script's time
D_PATH, N_PATH, B_PATH, N_Q1, N_CHECK = 10, 30000, 32, 4000, 4000
Q_PATH, Q_CHECK = 16, 8
# the q = 3 and q = 2 card-vs-CPU sizes (their CPU side runs in the worker
# processes of section 3, beside the card phases)
N_Q3_CHECK, N_Q2_CHECK = 2000, 4000
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS = 34e12  # H100 SXM FP64 outside the tensor cores (data sheet)
L2_BYTES = 50e6  # H100 SXM L2 cache (NVIDIA data sheet)


def _require_gpu():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)


def _import_port():
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import (GPConfig, fit, fit_hyperparams,
                                  log_likelihood, mll_gradients,
                                  posterior_mean, posterior_mean_grad,
                                  posterior_var)
    from repro_torch.core import bayesopt as bo
    from repro_torch.core import fleet
    import repro_torch.core.additive_gp as agp
    import repro_torch.kernels.fused_sweep as fsm
    from repro_torch.core.additive_gp import (_log_likelihood,
                                              _mll_gradients, _probe_block)
    from repro_torch.core.band_inverse import (_blocks_to_band, _to_blocks,
                                               variance_band)
    from repro_torch.core.convert import BAND_KEYS, gp_from_arrays
    from repro_torch.core.gband_update import patch_size
    from repro_torch import streaming as stream
    from repro_torch.core.stochastic import rademacher_rows
    from repro_torch.core.banded import Banded, add, scale, transpose
    from repro_torch.core.kernel_packets import gkp_factors, kp_factors
    from repro_torch.data import ShardedBatches, sample_test_function
    from repro_torch.distributed.elastic import elastic_mesh, reshard_tree
    from repro_torch.distributed.sharding import (batch_pspecs, device_put,
                                                  fleet_pspecs, mesh_shape)
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch import health
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.health import ladder
    from repro_torch.health.verdict import DRIFT_TOL, verdict_name
    from repro_torch.kernels import _build
    from repro_torch.kernels.band_matmul import band_matmul, band_matmul_plain
    from repro_torch.kernels.banded_lu import (banded_lu, banded_lu_pivot,
                                               banded_lu_pivot_plain,
                                               banded_lu_plain)
    from repro_torch.kernels.banded_matvec import (banded_matvec,
                                                   banded_matvec_plain)
    from repro_torch.kernels.block_cr import (
        block_cr, block_cr_apply, block_cr_apply_cols, block_cr_apply_plain,
        block_cr_factor, block_cr_factor_plain, block_cr_plain,
        cr_factor_size, pad_band)
    from repro_torch.core.backfitting import DimOps, SolveConfig, solve_mhat
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_sweep import (
        FusedSweep, fused_gauss_seidel_iter,
        fused_gauss_seidel_iter_plain, fused_jacobi_iter,
        fused_jacobi_iter_plain, fused_pcg_iter, fused_pcg_iter_plain,
        gauss_seidel_cols, gauss_seidel_grid, jacobi_cols, jacobi_grid,
        pcg_seed, pcg_seed_plain, pcg_solve_cols, sweep_backward_error)
    from repro_torch.kernels.kp_gram import (kp_gram, kp_gram_plain,
                                            kp_gram_table_plain)
    from repro_torch.kernels.mega_solve import (
        MegaSolve, mega_gauss_seidel_plain, mega_gauss_seidel_solve,
        mega_jacobi_plain, mega_jacobi_solve, mega_pcg_plain, mega_pcg_solve)
    from repro_torch.kernels.ref import rgf_band_error, rgf_longdouble_ref
    from repro_torch.kernels.rgf import (rgf_blocks, rgf_blocks_cr_plain,
                                         rgf_blocks_plain)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    from path_trace import trace_call
    return dict(locals())


_T0 = time.perf_counter()


def _stamp(phase):
    """Print the script's elapsed wall time at the end of a phase."""
    print(f"elapsed {time.perf_counter() - _T0:.1f} s after {phase}",
          flush=True)


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


def _device_ms(fn, reps=20, tries=2):
    """Device ms per call of the kernels ``fn`` launches: the kernels' own
    time in a torch.profiler trace over ``reps`` calls (the device events,
    not the host ops that launch them); a trace that shows none is taken
    again (one trace right after another has come back empty), and after
    ``tries`` empty traces one call between CUDA events after a
    synchronise is read instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
                    for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA
                    and "Activity Buffer" not in ev.key)
        if total > 0:
            return total / 1e3 / reps, "profiler"
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), "events, one call"


def _band(rng, G, n, lo, hi, dev):
    """Diagonally dominant band (G, n, lo+hi+1), zero out-of-range entries."""
    data = rng.standard_normal((G, n, lo + hi + 1))
    i = np.arange(n)[:, None]
    j = i + np.arange(-lo, hi + 1)[None, :]
    data = np.where((j >= 0) & (j < n), data, 0.0)
    off = np.abs(data).sum(-1) - np.abs(data[..., lo])
    data[..., lo] = np.sign(data[..., lo] + 0.5) * (off + 1.0)
    return torch.as_tensor(data, device=dev)


SERVING_KERNELS = ("banded_lu", "band_matmul", "rgf_blocks", "mega_pcg",
                   "cr_factor")
LEARNING_KERNELS = SERVING_KERNELS + ("banded_matvec", "cr_apply")


def _require_launched(path, counts, names):
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the {path}: "
                           f"{missing}")


def _check(name, card, cpu, tol=1e-7):
    """Card against plain CPU: max relative difference within ``tol``."""
    a, b = card.detach().cpu().reshape(-1), cpu.detach().reshape(-1)
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"consistency {name}: card vs cpu max rel {rel:.3e} (tol {tol:.0e})",
          flush=True)
    if not (rel < tol and bool(torch.isfinite(a).all())):
        raise RuntimeError(f"card vs cpu {name} disagree: {rel:.3e}")


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


def _state_passes(N, iters, once, per_iter):
    """Passes over (D, npad, B) state arrays of N doubles that a whole solve
    of ``iters`` iterations must make. Where one such array fits the L2, the
    iterations can keep the state on chip (as the TPU kernel keeps it in
    VMEM), and only the solve's inputs and outputs count, each read or
    written once: ``once``. Where it does not (77 MB at n = 30000, D = 10,
    B = 32), every iteration streams what the one before wrote: ``once``
    for the first iteration (whose reads and writes are the solve's inputs
    and outputs), then ``per_iter`` for each later one."""
    if iters <= 1 or 8 * N <= L2_BYTES:
        return once
    return once + (iters - 1) * per_iter


# the whole PCG solve's state passes: once v and x0 read, x and r written;
# per iteration x, r and p (the carried state) each read and written
PCG_STATES, PCG_SWEPT = 4, 6


def _mega_cost(D, npad, B, w_a, w_p, w_s, iters):
    N = D * npad * B
    nbytes = 8 * D * npad * (2 * w_a + 2 * w_p + 2 * w_s + 3) \
        + 4 * 2 * D * npad \
        + 8 * (N * _state_passes(N, iters, PCG_STATES, PCG_SWEPT) + 1)
    per_iter = (2 * (2 * w_a + 1) + 2 * (2 * w_p + 1) + _solve_ops(w_p, B)
                + _solve_ops(w_s, B) + 14)
    return nbytes, iters * N * per_iter


def kernel_phase(P, rng, dev, shapes, ops_path, ops_q1):
    """Each kernel vs its plain version at the path's and q = 1 shapes."""
    D, n, B = shapes
    rows = []

    def report(name, tag, err, rel, tol, ms, plain_ms, extra=""):
        print(f"kernel {name:12s} {tag:26s} max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol {tol:.0e}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}{extra}", flush=True)
        if not rel <= tol:
            raise RuntimeError(f"{name} {tag}: error {rel:.3e} > {tol:.0e}")

    # --- banded_lu: Phi solves at lo = hi = 0 (B = 32 variance chunk; the
    # learning path's B = 16 probes and B = 4 power-method restarts) ------
    for tag, (G, nn, lo, hi, Bc) in (("path lo=hi=0 B=32", (D, n, 0, 0, B)),
                                     ("path lo=hi=0 B=16", (D, n, 0, 0, 16)),
                                     ("path lo=hi=0 B=4", (D, n, 0, 0, 4)),
                                     ("path lo=hi=0 B=1", (D, n, 0, 0, 1)),
                                     ("q1 lo=hi=1 B=32", (D, N_Q1, 1, 1, B))):
        bd = _band(rng, G, nn, lo, hi, dev)
        rhs = torch.as_tensor(rng.standard_normal((G, nn, Bc)), device=dev)
        # three warm-up calls: the first timed row of the script otherwise
        # also times the allocator growing its pool for x (two 77 MB
        # blocks at B = 32 alternate, the last result being held)
        ms, (x, ld) = _event_ms(lambda: P["banded_lu"](bd, rhs, lo, hi),
                                reps=20, warmup=3)
        pms, (xp, ldp) = _event_ms(
            lambda: P["banded_lu_plain"](bd, rhs, lo, hi), reps=1, warmup=0)
        err, rel = _errs(torch.cat([x.flatten(), ld]),
                         torch.cat([xp.flatten(), ldp]))
        extra = ""
        if tag.startswith("path"):
            dev_ms, how = _device_ms(lambda: P["banded_lu"](bd, rhs, lo, hi))
            lib_dev_ms, _ = _device_ms(lambda: rhs / bd)
            lib_ms, _ = _event_ms(lambda: rhs / bd, reps=20)
            full_ms, _ = _event_ms(
                lambda: (rhs / bd, bd.abs().log().sum(1)), reps=20)
            nbytes = 8 * (G * nn + 2 * G * nn * Bc + G)
            b_ms, b_by = _bound(nbytes, G * nn * Bc + 2 * G * nn)
            extra = (f" device_ms={dev_ms:.4f} ({how}) library_ms(rhs / "
                     f"band)={lib_ms:.4f} (device {lib_dev_ms:.4f}) "
                     f"library_ms(solve + log-det)={full_ms:.4f} "
                     f"bound_ms={b_ms:.4f} ({b_by})")
        report("banded_lu", tag, err, rel, 1e-12, ms, pms, extra)
        if tag.startswith("path lo=hi=0 B=32"):
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
        dev_ms, how = _device_ms(lambda: P["band_matmul"](a, b, *w))
        wa, wb = w[0] + w[1] + 1, w[2] + w[3] + 1
        b_ms, b_by = _bound(8 * D * nn * (wa + wb + wa + wb - 1),
                            2 * D * nn * wa * wb)
        report("band_matmul", tag, err, rel, 1e-13, ms, pms,
               f" device_ms={dev_ms:.4f} ({how}) bound_ms={b_ms:.4f} "
               f"({b_by})")
        if tag.startswith("path"):
            rows.append(dict(name="band_matmul", route="cuda",
                             source="src/repro_torch/csrc/band_matmul.cu",
                             replaces="src/repro/kernels/band_matmul.py:52",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))

    # --- rgf: the variance band's block inverse ---------------------------
    for tag, (nn, w) in (("path w=1", (n, 1)), ("q1 w=3", (N_Q1, 3))):
        h = _band(rng, D, nn, w, w, dev)
        blocks = [t.contiguous() for t in P["_to_blocks"](h, w, w, w)]
        ms, pms, err, rel, b_ms, b_by = _rgf_row(P, report, tag, blocks)
        if tag.startswith("path"):
            rows.append(dict(name="rgf_blocks", route="cuda",
                             source="src/repro_torch/csrc/rgf.cu",
                             replaces="src/repro/kernels/rgf.py:90",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))

    # --- mega_pcg: the whole Mhat solve on the GP's own operands: the
    # serving path's B = 32 variance chunks, the gradients' B = D Q = 160
    # and B = Q = 16 trace-probe solves, and q = 1 widths ---------------
    for tag, fs, Bc in (("path q=0 B=32 40 iters", ops_path, B),
                        ("path q=0 B=160 40 iters", ops_path, D * Q_PATH),
                        ("path q=0 B=16 40 iters", ops_path, Q_PATH),
                        ("q1 (2,1,2) B=32 40 iters", ops_q1, B)):
        v = fs.pad_state(torch.as_tensor(
            rng.standard_normal((fs.D, fs.n, Bc)), device=dev))
        x0 = torch.zeros_like(v)
        args = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2,
                v, x0)
        kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=40)
        fac = fs.cr_factors()
        ms, (x, r, it) = _event_ms(
            lambda: P["mega_pcg_solve"](*args, factors=fac, **kw),
            reps=1 if Bc > B else 3)
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
        report("mega_pcg", tag, err, rel, 1e-7, ms, pms,
               f" (factors made once; solve items of "
               f"{P['pcg_solve_cols'](fs.D, Bc)} columns)")
        if tag.startswith("path q=0 B=32"):
            nbytes, ops = _mega_cost(fs.D, fs.npad, B, fs.w_a, fs.w_p,
                                     fs.w_s, int(it))
            b_ms, b_by = _bound(nbytes, ops)
            rows.append(dict(name="mega_pcg", route="cuda",
                             source="src/repro_torch/csrc/mega_pcg.cu",
                             replaces="src/repro/kernels/mega_solve.py:268",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))

    # --- cr_factor: the block-CR factors the PCG kernel solves from (the
    # path's SAPhi at q = 0, pivoted too; SAPhi at q = 1). The factor's
    # reduced blocks are Schur complements, so the kernel's and the plain
    # version's rounding (fused multiply-adds against einsum) part by up to
    # cond(SAPhi) eps there: the bar is max(1e-12, cond eps), as for the
    # relaxation rows, with cond estimated in the run ---------------------
    eps = float(torch.finfo(torch.float64).eps)
    for tag, fs, pivot in (("path SAPhi w=1", ops_path, False),
                           ("path SAPhi w=1 pivot", ops_path, True),
                           ("q1 SAPhi w=2", ops_q1, False)):
        w = fs.w_s
        kappa = _cond_est(P, fs, fs.saphi, w)
        tol = max(1e-12, kappa * eps)
        ms, fac = _event_ms(lambda: P["block_cr_factor"](fs.saphi, w,
                                                         pivot=pivot),
                            reps=10)
        pms, facp = _event_ms(lambda: P["block_cr_factor_plain"](
            fs.saphi, w, pivot=pivot), reps=1, warmup=0)
        err, rel = _errs(fac, facp)
        nb = fs.npad // w
        nbytes = 8 * fs.D * (fs.npad * (2 * w + 1)
                             + P["cr_factor_size"](nb, w))
        # per even row and level: two w x w inversions (cr_coef), the two
        # coefficient products and four block products of the fold
        nev = sum(-(-nb // (2 << k)) for k in range((nb - 1).bit_length()))
        b_ms, b_by = _bound(nbytes, fs.D * nev * 18 * w ** 3)
        report("cr_factor", tag, err, rel, tol, ms, pms,
               f" cond <= {kappa:.3e} bound_ms={b_ms:.4f} ({b_by}) "
               f"library_ms=none")
        if tag == "path SAPhi w=1":
            rows.append(dict(name="cr_factor", route="cuda",
                             source="src/repro_torch/csrc/block_cr.cu",
                             replaces="src/repro/kernels/mega_solve.py:268",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))

    # --- banded_matvec: A u, Phi u (Taylor log-det), Psi v (gradients) ----
    Q = Q_PATH
    for tag, (nn, lo, hi) in (("path (1,1) B=16", (n, 1, 1)),
                              ("path (0,0) B=16", (n, 0, 0)),
                              ("q1 (2,2) B=16", (N_Q1, 2, 2))):
        bd = _band(rng, D, nn, lo, hi, dev)
        x = torch.as_tensor(rng.standard_normal((D, nn, Q)), device=dev)
        ms, y = _event_ms(lambda: P["banded_matvec"](bd, x, lo, hi), reps=20)
        pms, yp = _event_ms(lambda: P["banded_matvec_plain"](bd, x, lo, hi),
                            reps=1, warmup=0)
        err, rel = _errs(y, yp)
        csr, xf = _block_diag_csr(bd, lo, hi), x.reshape(D * nn, Q)
        lib_ms, _ = _event_ms(lambda: torch.sparse.mm(csr, xf), reps=20)
        w = lo + hi + 1
        b_ms, b_by = _bound(8 * D * nn * (w + 2 * Q), 2 * D * nn * w * Q)
        report("banded_matvec", tag, err, rel, 1e-13, ms, pms,
               f" bound_ms={b_ms:.4f} ({b_by}) library_ms={lib_ms:.4f}")
        if tag.startswith("path (1,1)"):
            rows.append(dict(name="banded_matvec", route="cuda",
                             source="src/repro_torch/csrc/banded_matvec.cu",
                             replaces="src/repro/kernels/banded_matvec.py:43",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms))

    # --- block_cr as factor (with the log-determinant) + apply: SAPhi / A /
    # A + Phi/s^2 (w = 1) and B (w = 2) at the path's shapes, the q = 1, 2, 3
    # widths (w = 3, 4, 5). The apply from a held factor against its plain
    # twin on the same factor; the whole call (factor + apply) against
    # block_cr_plain; the apply at each chunk width, bit for bit the same --
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"cr_apply chunk rule: the narrowest power of two c (at most B) "
          f"with G * ceil(B / c) <= {sms} SMs", flush=True)
    for tag, (nn, w, Bc, pivot) in (
            ("path w=1 B=16", (n, 1, Q, False)),
            ("path w=1 B=1", (n, 1, 1, False)),
            ("path w=1 B=32", (n, 1, B, False)),
            ("path w=1 B=160", (n, 1, D * Q, False)),
            ("path w=2 B=16", (n, 2, Q, False)),
            ("pivot w=1 B=16", (n, 1, Q, True)),
            ("q1 w=3 B=16", (N_Q1, 3, Q, False)),
            ("q2 w=4 B=16", (N_Q1, 4, Q, False)),
            ("q3 w=5 B=16", (N_Q1, 5, Q, False))):
        bd = P["pad_band"](_band(rng, D, nn, w, w, dev), w)
        npad = bd.shape[1]
        rhs = torch.as_tensor(rng.standard_normal((D, npad, Bc)), device=dev)
        kw = dict(pivot=pivot)
        fms, (fac, ld) = _event_ms(
            lambda: P["block_cr_factor"](bd, w, logdet=True, **kw), reps=10)
        ms, x = _event_ms(lambda: P["block_cr_apply"](fac, rhs, w, **kw),
                          reps=20)
        whole_ms, (xw, ldw) = _event_ms(
            lambda: P["block_cr"](bd, rhs, w, **kw), reps=10)
        pms, xp = _event_ms(
            lambda: P["block_cr_apply_plain"](fac, rhs, w, **kw), reps=1,
            warmup=0)
        xr, ldr = P["block_cr_plain"](bd, rhs, w, **kw)
        err, rel = _errs(x, xp)
        werr, wrel = _errs(torch.cat([xw.flatten(), ldw]),
                           torch.cat([xr.flatten(), ldr]))
        same = bool(torch.equal(x, xw))
        cols = P["block_cr_apply_cols"](D, Bc)
        widths = {c: _event_ms(lambda: P["block_cr_apply"](
            fac, rhs, w, cols=c, **kw), reps=20) for c in (1, 2, 4, 8, 16)
            if c <= Bc and tag.startswith("path w=1")}
        same &= all(torch.equal(out, x) for _, out in widths.values())
        fsize = P["cr_factor_size"](npad // w, w)
        b_ms, b_by = _bound(8 * D * (fsize + 2 * npad * Bc),
                            D * npad * Bc * 8.0 * w * w)
        wb_ms, wb_by = _bound(8 * (D * npad * (2 * w + 1) + 2 * D * npad * Bc
                                   + D),
                              D * npad * Bc * _solve_ops(w, Bc))
        dev_ms = ""
        if tag == "path w=1 B=16":
            d_ms, how = _device_ms(
                lambda: P["block_cr_apply"](fac, rhs, w, **kw))
            dev_ms = f" device_ms={d_ms:.4f} ({how})"
        report("cr_apply", tag, err, rel, 1e-12, ms, pms,
               f"{dev_ms} cols={cols} bound_ms={b_ms:.4f} ({b_by}) "
               f"library_ms=none; factor+logdet_ms={fms:.4f}; whole call "
               f"(factor + apply) ms={whole_ms:.4f} vs block_cr_plain "
               f"max_rel_err={wrel:.3e} bound_ms={wb_ms:.4f} ({wb_by}); "
               "widths " + " ".join(f"{c}:{t:.4f}" for c, (t, _) in
                                    widths.items())
               + f"; apply == whole call, every width, bitwise {same}")
        if not (wrel <= 1e-12 and same):
            raise RuntimeError(f"block_cr {tag}: whole call {wrel:.3e} or "
                               "the widths' bits differ")
        if tag == "path w=1 B=16":
            rows.append(dict(name="cr_apply", route="cuda",
                             source="src/repro_torch/csrc/block_cr.cu",
                             replaces="src/repro/kernels/block_cr.py:188",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))

    # --- rgf at q = 2 and 3 (H = A Phi^T has w = 5, 7); drawn after the
    # rows above so their inputs stay those of earlier runs ---------------
    for w in (5, 7):
        h = _band(rng, D, N_Q1, w, w, dev)
        blocks = [t.contiguous() for t in P["_to_blocks"](h, w, w, w)]
        _rgf_row(P, report, f"q{(w - 1) // 2} w={w}", blocks)
    return rows


def _rgf_bound(D, T, w):
    """(ms, by) of the block inverse: the three block stacks read and the
    three written once; the work of one block elimination order, ~23 w^3
    flops a block row."""
    return _bound(8 * 6 * D * T * w * w, D * T * (23 * w ** 3 + 2 * w * w))


def _rgf_row(P, report, tag, blocks):
    """One rgf_blocks row: the kernel (block-CR order) against the RGF
    order's plain version (1e-10, the reference's bar) and against its
    plain twin in the same order (1e-12: only the w x w inverses' rounding
    and the card's fused multiply-adds differ); event and device times."""
    ms, out = _event_ms(lambda: P["rgf_blocks"](*blocks), reps=20)
    dev_ms, how = _device_ms(lambda: P["rgf_blocks"](*blocks), reps=5)
    pms, outp = _event_ms(lambda: P["rgf_blocks_plain"](*blocks), reps=1,
                          warmup=0)
    err, rel = _errs(torch.stack(out), torch.stack(outp))
    _, twin = _errs(torch.stack(out),
                    torch.stack(P["rgf_blocks_cr_plain"](*blocks)))
    G, T, w, _ = blocks[0].shape
    b_ms, b_by = _rgf_bound(G, T, w)
    report("rgf_blocks", tag + f" T={T}", err, rel, 1e-10, ms, pms,
           f" device_ms={dev_ms:.4f} ({how}) bound_ms={b_ms:.4f} ({b_by}) "
           f"vs rgf_blocks_cr_plain max_rel_err={twin:.3e} (tol 1e-12)")
    if not twin <= 1e-12:
        raise RuntimeError(f"rgf_blocks {tag}: {twin:.3e} from its twin")
    return ms, pms, err, rel, b_ms, b_by


def _ptxas(_build, source, kernels):
    """(template arguments, kernel, registers, spill stores, spill loads) of
    each instantiation of ``kernels`` in ``source``, from the build's
    ptxas report (``nvcc -Xptxas -v``); the arguments are the integer and
    bool template arguments in order, one alone printed as itself."""
    import re

    log = (_build.BUILD_DIR / f"build_{_build._digest()}.log").read_text()
    sec = log.split(f"== {source}", 1)[1].split("\n== ", 1)[0]
    pat = re.compile(r"Function properties for \S*?(" + kernels + r")"
                     r"_kernelI((?:L[bi]\d+E)+)E\S*\s+(\d+) bytes stack "
                     r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                     r"loads\s+ptxas info\s+: Used (\d+) registers")
    out = []
    for m in pat.finditer(sec):
        args = tuple(int(a) for a in re.findall(r"L[bi](\d+)E", m[2]))
        out.append((args[0] if len(args) == 1 else args, m[1], int(m[6]),
                    int(m[4]), int(m[5])))
    return sorted(out)


def variance_band_phase(P, gp):
    """The path's own H = A Phi^T (the fit's factors, n = 30000, w = 1): the
    kernel's error against an RGF in extended precision on the host, beside
    the float64 RGF's (both over Gd, Gu and Gl together, relative to G's
    largest entry, the worst of the D bands); the kernel's must be at most
    twice the RGF's. The two float64 orders differ there by H's
    conditioning, not by a defect of either. Then the whole variance_band
    call's time."""
    Gb, H = P["variance_band"](gp.ops.A, gp.ops.Phi, return_h=True)
    hw = gp.ops.A.lo + gp.ops.Phi.lo
    w = max(H.lo, H.hi, hw, 1)
    blocks = [t.contiguous() for t in P["_to_blocks"](H.data, H.lo, H.hi, w)]
    ms, out = _event_ms(lambda: P["rgf_blocks"](*blocks), reps=20)
    cpu = [t.cpu() for t in blocks]
    exact = P["rgf_longdouble_ref"](*cpu)
    e_k = P["rgf_band_error"](out, exact)
    e_r = P["rgf_band_error"](P["rgf_blocks_plain"](*cpu), exact)
    e_t = P["rgf_band_error"](P["rgf_blocks_cr_plain"](*cpu), exact)
    same = torch.equal(Gb.data, P["_blocks_to_band"](*out, H.n, hw))
    print(f"kernel rgf_blocks   path H w=1 T={blocks[0].shape[1]} (the "
          f"fit's A Phi^T): error vs long-double RGF: kernel {e_k:.3e}, "
          f"float64 RGF {e_r:.3e}, plain CR twin {e_t:.3e}; kernel / RGF "
          f"{e_k / e_r:.3f} (bar 2); kernel_ms={ms:.4f}; the path's Gband "
          f"from the same call bitwise {same}", flush=True)
    if not (e_k <= 2 * e_r and same):
        raise RuntimeError(f"rgf_blocks on the path's H: {e_k:.3e} against "
                           f"the float64 RGF's {e_r:.3e}, or Gband differs")
    vb = lambda: P["variance_band"](gp.ops.A, gp.ops.Phi)  # noqa: E731
    v_ms, _ = _event_ms(vb, reps=10)
    vd_ms, how = _device_ms(vb, reps=10)
    print(f"variance_band (band_matmul, mask, blocks, rgf, band) n="
          f"{H.n} D={H.data.shape[0]} q=0: {v_ms:.4f} ms (events), device "
          f"{vd_ms:.4f} ms ({how})", flush=True)


def _sweep_cost(D, npad, B, w_p, w_s, iters, states, swept, elem, final=0,
                warm=False):
    """(bytes, flops) of ``iters`` relaxation sweeps: the bands, the
    permutations and the state passes of ``_state_passes`` (``states``
    (D, npad, B) arrays, each input read once and each output written once;
    ``swept`` passes a later sweep makes where the state exceeds the L2);
    per sweep and element the gathered Phi matvec (4 w_p + 1), the SAPhi
    solve and ``elem`` elementwise flops, plus ``final`` once (Gauss-Seidel's
    k, from the last sweep). A warm start adds one SAPhi matvec, one Phi
    solve and 2 flops."""
    N = D * npad * B
    nbytes = 8 * D * npad * (2 * w_p + 2 * w_s + 2) + 4 * 2 * D * npad \
        + 8 * N * _state_passes(N, iters, states, swept) + 8
    ops = iters * N * (4 * w_p + 1 + _solve_ops(w_s, B) + elem) + N * final
    if warm:
        ops += N * (4 * w_s + 1 + _solve_ops(w_p, B) + 2)
    return nbytes, ops


# elementwise flops per element and sweep (the kernels' phases): the total
# (1), r (3), the solve's scale by s^2 (1), then Jacobi's damped update of
# x (3) and of k (5), Gauss-Seidel's running total (2) and, on the final
# sweep only, its k (2)
JACOBI_ELEM, JACOBI_K_ELEM = 8, 5
GS_ELEM, GS_K_FINAL = 7, 2
# state passes (``_sweep_cost``): a Jacobi sweep carrying k reads v, x and
# k and writes x and k (5), and so does every later sweep of the whole
# solve, whose inputs and outputs are v and x0 read, x and k written (4);
# a Gauss-Seidel sweep reads v and x and writes x (3; the r and t1 of one
# dimension, 7.7 MB at the main shape, stay in the L2), its inputs and
# outputs, one sweep or the whole solve, v and x0 read, x and k written (4)
JACOBI_SWEPT, GS_STATES, GS_SWEPT = 5, 4, 3


# time bars of the main rows (n = 30000, D = 10, q = 0, B = 32; ms): the
# redesigned relaxation kernels against the rows they replaced (PERF.md:
# Jacobi 2.718 and 100.36, Gauss-Seidel 6.186 and 233.0 ms, NVIDIA H100
# 80GB HBM3 at 700 W). Printed beside each row, met or not; a card below
# its full power limit may miss them, so they do not fail the run.
TIME_BARS = {"fused_jacobi_iter": 1.6, "mega_jacobi": 60.0,
             "fused_gauss_seidel_iter": 3.1, "mega_gauss_seidel": 116.0}


RELAX_KERNELS = {
    "fused_jacobi_iter": ("src/repro_torch/csrc/jacobi.cu",
                          "src/repro/kernels/fused_sweep.py:187"),
    "fused_gauss_seidel_iter": ("src/repro_torch/csrc/gauss_seidel.cu",
                                "src/repro/kernels/fused_sweep.py:263"),
    "mega_jacobi": ("src/repro_torch/csrc/jacobi.cu",
                    "src/repro/kernels/mega_solve.py:129"),
    "mega_gauss_seidel": ("src/repro_torch/csrc/gauss_seidel.cu",
                          "src/repro/kernels/mega_solve.py:183"),
}


def _cond_est(P, fs, band, w, steps=40):
    """Largest 2-norm condition number over the dimensions of a padded band
    stack (D, npad, 2w+1): power iteration on M^T M and on its inverse, with
    the plain matvec and the block-CR kernel (w >= 1)."""
    bt = P["transpose"](P["Banded"](band, w, w)).data.contiguous()
    g = torch.Generator(device=band.device).manual_seed(0)
    u = torch.randn((fs.D, fs.npad, 1), generator=g, dtype=band.dtype,
                    device=band.device)
    v = u.clone()
    mv = P["banded_matvec_plain"]
    for _ in range(steps):
        u = mv(bt, mv(band, u, w, w), w, w)
        u = u / u.norm(dim=1, keepdim=True)
        v = P["block_cr"](band, P["block_cr"](bt, v, w)[0], w)[0]
        v = v / v.norm(dim=1, keepdim=True)
    smax = mv(band, u, w, w).norm(dim=1)
    smin = 1.0 / P["block_cr"](band, v, w)[0].norm(dim=1)
    return float((smax / smin).max())


def relax_kernel_phase(P, rng, dev, ops_path, ops_q1, iters):
    """The relaxation kernels (one sweep, whole solve) vs their plain
    versions at the main path's q = 0 shapes (B = 1, 32) and at q = 1
    widths; then a host loop of single sweeps against the whole solve, bit
    for bit.

    The bar is max(1e-12, kappa eps), kappa the largest condition number of
    the SAPhi systems the sweeps solve: two correct float64 solves of a
    system differ by up to about kappa eps, and the kernel rounds
    differently from the plain version (fused multiply-adds). On the
    jittered q = 1 grid kappa is ~1e3 and the bar is 1e-12; on the
    Schwefel points of the main path kappa is ~1e8. Since kappa is
    estimated with the block-CR kernel, a second witness does not rest on
    it: one undamped sweep's backward error on the SAPhi solves
    (``sweep_backward_error``) must be within 10x the plain version's."""
    rows = []
    eps = float(torch.finfo(torch.float64).eps)

    def run(name, tag, fn, plain, nbytes, ops, reps):
        ms, out = _event_ms(fn, reps=reps)
        pms, outp = _event_ms(plain, reps=1, warmup=0)
        out = out if isinstance(out, tuple) else (out,)
        outp = outp if isinstance(outp, tuple) else (outp,)
        err, rel = _errs(torch.cat([o.flatten() for o in out]),
                         torch.cat([o.flatten() for o in outp]))
        b_ms, b_by = _bound(nbytes, ops)
        bar = ""
        if tag.startswith("path q=0 B=32"):
            bar = (f" time bar <= {TIME_BARS[name]} ms: "
                   + ("met" if ms <= TIME_BARS[name] else "NOT met"))
        print(f"kernel {name:24s} {tag:22s} max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol {tol:.1e}) kernel_ms={ms:.4f} "
              f"plain_ms={pms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"library_ms=none{bar}", flush=True)
        if not rel <= tol:
            raise RuntimeError(f"{name} {tag}: error {rel:.3e} > {tol:.1e}")
        return dict(name=name, route="cuda", source=RELAX_KERNELS[name][0],
                    replaces=RELAX_KERNELS[name][1], max_abs_err=err,
                    max_rel_err=rel, ms=ms, plain_ms=pms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    kappa = {id(fs): _cond_est(P, fs, fs.saphi, fs.w_s)
             for fs in (ops_path, ops_q1)}
    # the main row at the path's sweep count; the others at 10 sweeps (the
    # plain Gauss-Seidel runs its D single-system solves per sweep one
    # after another, ~0.3 s a sweep at n = 30000)
    for tag, fs, Bc, its in (("path q=0 B=32", ops_path, B_PATH, iters),
                             ("path q=0 B=1", ops_path, 1, 10),
                             ("q1 (1,2) B=32", ops_q1, B_PATH, 10)):
        tol = max(1e-12, kappa[id(fs)] * eps)
        print(f"relaxation rows {tag}: cond(SAPhi) <= "
              f"{kappa[id(fs)]:.3e}, bar {tol:.3e}", flush=True)
        ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
        v = fs.pad_state(torch.as_tensor(
            rng.standard_normal((fs.D, fs.n, Bc)), device=dev))
        x0 = fs.pad_state(torch.as_tensor(
            0.1 * rng.standard_normal((fs.D, fs.n, Bc)), device=dev))
        k = fs.pad_state(torch.as_tensor(
            0.1 * rng.standard_normal((fs.D, fs.n, Bc)), device=dev))
        kw = dict(w_p=fs.w_p, w_s=fs.w_s)
        al = 1.0 / fs.D
        shape = (fs.D, fs.npad, Bc, fs.w_p, fs.w_s)
        main = tag == "path q=0 B=32"
        # the Gauss-Seidel kernel solves from SAPhi's factor, the Jacobi
        # kernel from SAPhi's and (warm, w_p >= 1) Phi's, made once for the
        # operand stack as the paths make them
        gkw = dict(kw, factors=fs.saphi_factor())
        jkw = dict(kw, factors=fs.cr_factors())
        print(f"gauss_seidel rows {tag}: from the held SAPhi factor, solve "
              f"items of {P['gauss_seidel_cols'](Bc)} columns (cooperative "
              f"grid {P['gauss_seidel_grid']()} blocks)", flush=True)
        print(f"jacobi rows {tag}: from the held factors, solve items of "
              f"{P['jacobi_cols'](fs.D, Bc)} columns (cooperative grid "
              f"{P['jacobi_grid']()} blocks)", flush=True)
        got = [
            # reads v, x0, k; writes x, k
            run("fused_jacobi_iter", tag + " k",
                lambda: P["fused_jacobi_iter"](*ops, v, x0, k, alpha=al,
                                               **jkw),
                lambda: P["fused_jacobi_iter_plain"](*ops, v, x0, k, alpha=al,
                                                     **kw),
                *_sweep_cost(*shape, 1, 5, JACOBI_SWEPT,
                             JACOBI_ELEM + JACOBI_K_ELEM),
                reps=10),
            # reads v, x0; writes x, k
            run("fused_gauss_seidel_iter", tag + " k",
                lambda: P["fused_gauss_seidel_iter"](*ops, v, x0,
                                                     want_resid=True, **gkw),
                lambda: P["fused_gauss_seidel_iter_plain"](
                    *ops, v, x0, want_resid=True, **kw),
                *_sweep_cost(*shape, 1, GS_STATES, GS_SWEPT, GS_ELEM,
                             GS_K_FINAL), reps=3),
            run("mega_jacobi", tag + f" warm {its} it",
                lambda: P["mega_jacobi_solve"](*ops, v, x0, alpha=al,
                                               iters=its, warm=True, **jkw),
                lambda: P["mega_jacobi_plain"](*ops, v, x0, alpha=al,
                                               iters=its, warm=True, **kw),
                *_sweep_cost(*shape, its, 4, JACOBI_SWEPT,
                             JACOBI_ELEM + JACOBI_K_ELEM, warm=True), reps=3),
            run("mega_gauss_seidel", tag + f" {its} it",
                lambda: P["mega_gauss_seidel_solve"](*ops, v, x0,
                                                     iters=its, **gkw),
                lambda: P["mega_gauss_seidel_plain"](*ops, v, x0,
                                                     iters=its, **kw),
                *_sweep_cost(*shape, its, GS_STATES, GS_SWEPT, GS_ELEM,
                             GS_K_FINAL), reps=1),
        ]
        # second witness to the bar: the SAPhi solves' backward error in one
        # undamped sweep, the kernel's within 10x the plain version's (a
        # stable solve reads a few eps at any conditioning; a wrong one not)
        for name, seq, fn, fkw in (
                ("jacobi", False, lambda f, a: f(*ops, v, x0, alpha=1.0, **a),
                 jkw),
                ("gauss_seidel", True, lambda f, a: f(*ops, v, x0, **a),
                 gkw)):
            kern, plain = (P[f"fused_{name}_iter{sfx}"]
                           for sfx in ("", "_plain"))
            be = [P["sweep_backward_error"](*ops, v, x0, fn(f, a),
                                            sequential=seq, **kw)
                  for f, a in ((kern, fkw), (plain, kw))]
            print(f"backward error {name} sweep {tag}: kernel {be[0]:.3e} "
                  f"plain {be[1]:.3e}", flush=True)
            if not be[0] <= 10 * max(be[1], eps):
                raise RuntimeError(f"{name} sweep {tag}: backward error "
                                   f"{be[0]:.3e} > 10 x {be[1]:.3e}")
        if main:
            rows += got

    # whole == host loop of single sweeps, bit for bit (main path shapes)
    fs = ops_path
    v = torch.as_tensor(rng.standard_normal((fs.D, fs.n, B_PATH)),
                        device=dev)
    x0 = 0.5 * v
    ms_ = P["MegaSolve"](fs)
    for warm in (False, True):
        start = x0 if warm else None
        u = fs.pad_state(x0 if warm else torch.zeros_like(v))
        vp = fs.pad_state(v)
        xw, kwh = ms_.jacobi(v, start, alpha=1.0 / fs.D, iters=5)
        uj, kj = (fs.jacobi_iter(vp, u, 1.0 / fs.D, warm=True) if warm else
                  fs.jacobi_iter(vp, u, 1.0 / fs.D, k=torch.zeros_like(u)))
        for _ in range(4):
            uj, kj = fs.jacobi_iter(vp, uj, 1.0 / fs.D, k=kj)
        xg, kg = ms_.gauss_seidel(v, start, iters=5)
        ug = u
        for _ in range(4):
            ug = fs.gauss_seidel_iter(vp, ug)
        ug, kgi = fs.gauss_seidel_iter(vp, ug, want_resid=True)
        same = all(torch.equal(a, fs.unpad(b)) for a, b in (
            (xw, uj), (kwh, kj), (xg, ug), (kg, kgi)))
        print(f"whole == host loop of sweeps (n={fs.n} D={fs.D} "
              f"B={B_PATH}, 5 sweeps, warm={warm}): bitwise {same} "
              "(jacobi x, k; gauss_seidel x, k)", flush=True)
        if not same:
            raise RuntimeError("whole solve and per-sweep loop differ")
    return rows


W4_KERNELS = {
    "mega_pcg_w4": ("src/repro_torch/csrc/mega_pcg.cu",
                    "src/repro/kernels/mega_solve.py:268"),
    "fused_pcg_iter_w4": ("src/repro_torch/csrc/mega_pcg.cu",
                          "src/repro/kernels/fused_sweep.py:363"),
    **{k + "_w4": v for k, v in RELAX_KERNELS.items()},
}


def w4_kernel_phase(P, dev, iters=80, sweeps=10):
    """The backfitting kernels' half-width-4 instantiations (q = 3: A and
    SAPhi w = 4, Phi w = 3) against their plain versions on the card, at
    n = 30000, D = 10, B = 32, on the operands of a jittered q = 3 grid
    (spacing 0.2 / omega, omega = 4, as the q = 3 consistency grid): the
    whole PCG solve (``iters`` iterations; its bar, iterations and r as
    the q = 0 mega_pcg row's; at 40 iterations this system's relative
    residual is still ~2e-5 and a 1e-14 change of v moves x by 1e-7, so
    two summation orders part there, while at 80 the residual is ~1e-10
    and x moves by 5e-11: plain version on the CPU), the PCG seed and one
    carried iteration,
    one Jacobi sweep with k and one Gauss-Seidel sweep with k, and the
    whole warm Jacobi and Gauss-Seidel solves of ``sweeps`` sweeps (the
    plain Gauss-Seidel solves D systems a sweep one after another). The
    one-iteration and relaxation rows' bar is max(1e-12, kappa eps), kappa
    the conditioning of the systems they solve (``relax_kernel_phase``),
    and one undamped sweep's backward error is held within 10x the plain
    version's. Its own seeds, so the other phases' draws stay as they
    were. Returns the six kernel rows."""
    rng = np.random.default_rng(31)
    D, n, B = D_PATH, N_PATH, B_PATH
    fs = _operands(P, _jittered(rng, n, D, spacing=0.2)[0], np.full(D, 4.0),
                   1.0, 3, dev)
    assert (fs.w_a, fs.w_p, fs.w_s) == (4, 3, 4)
    eps = float(torch.finfo(torch.float64).eps)
    kappa = max(_cond_est(P, fs, fs.saphi, fs.w_s),
                _cond_est(P, fs, fs.phi, fs.w_p))
    tol = max(1e-12, kappa * eps)
    ops = (fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
    pops = (fs.a,) + ops
    kw = dict(w_p=fs.w_p, w_s=fs.w_s)
    pkw = dict(kw, w_a=fs.w_a)
    fac = fs.cr_factors()
    jkw, gkw, fkw = (dict(kw, factors=fac),
                     dict(kw, factors=fs.saphi_factor()),
                     dict(pkw, factors=fac))
    v = fs.pad_state(torch.as_tensor(rng.standard_normal((D, n, B)),
                                     device=dev))
    x0 = fs.pad_state(torch.as_tensor(0.1 * rng.standard_normal((D, n, B)),
                                      device=dev))
    k = fs.pad_state(torch.as_tensor(0.1 * rng.standard_normal((D, n, B)),
                                     device=dev))
    zero = torch.zeros_like(v)
    print(f"W = 4 rows (q = 3, n={n} D={D} B={B}): cond <= {kappa:.3e}, bar "
          f"{tol:.3e}; solve items of pcg {P['pcg_solve_cols'](D, B, maxw=4)}"
          f", jacobi {P['jacobi_cols'](D, B, maxw=4)}, gauss_seidel "
          f"{P['gauss_seidel_cols'](B, maxw=4)} columns (grids "
          f"{P['jacobi_grid'](maxw=4)}, {P['gauss_seidel_grid'](maxw=4)} "
          "blocks)", flush=True)
    rows = []

    def row(name, tag, ms, pms, err, rel, bar, cost):
        b_ms, b_by = _bound(*cost)
        print(f"kernel {name:27s} {tag:22s} max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol {bar:.1e}) kernel_ms={ms:.4f} "
              f"plain_ms={pms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              "library_ms=none", flush=True)
        if not rel <= bar:
            raise RuntimeError(f"{name} {tag}: error {rel:.3e} > {bar:.1e}")
        rows.append(dict(name=name, route="cuda", source=W4_KERNELS[name][0],
                         replaces=W4_KERNELS[name][1], max_abs_err=err,
                         max_rel_err=rel, ms=ms, plain_ms=pms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None))

    # the whole PCG solve
    ms, (x, r, it) = _event_ms(lambda: P["mega_pcg_solve"](
        *pops, v, zero, iters=iters, **fkw), reps=3)
    pms, (xp, rp, itp) = _event_ms(lambda: P["mega_pcg_plain"](
        *pops, v, zero, iters=iters, **pkw), reps=1, warmup=0)
    err, rel = _errs(x, xp)
    r_err = float((r - rp).abs().max()) / float(v.abs().max())
    print(f"mega_pcg_w4 q3: |r| / |v| kernel "
          f"{float(r.abs().max() / v.abs().max()):.3e}, plain "
          f"{float(rp.abs().max() / v.abs().max()):.3e} after {iters} "
          f"iterations; r error at |v| {r_err:.3e}", flush=True)
    if int(it) != int(itp) or not r_err < 1e-7:
        raise RuntimeError(f"mega_pcg_w4: iters {int(it)} vs {int(itp)}, r "
                           f"error {r_err:.3e}")
    row("mega_pcg_w4", f"q3 B={B} {iters} iters", ms, pms, err, rel, 1e-7,
        _mega_cost(D, fs.npad, B, fs.w_a, fs.w_p, fs.w_s, int(it)))
    # the seed (cold, warm) and one carried iteration
    seed_err = 0.0
    for warm in (False, True):
        start = x0 if warm else zero
        got = P["pcg_seed"](*pops, v, start, warm=warm, **fkw)
        want = P["pcg_seed_plain"](*pops, v, start, warm=warm, **pkw)
        seed_err = max(seed_err, _errs(_flat(got), _flat(want))[1])
    ms, out = _event_ms(lambda: P["fused_pcg_iter"](*pops, *got, **fkw),
                        reps=10)
    pms, outp = _event_ms(lambda: P["fused_pcg_iter_plain"](*pops, *got,
                                                            **pkw),
                          reps=1, warmup=0)
    err, rel = _errs(_flat(out[k] for k in (0, 2, 3)),
                     _flat(outp[k] for k in (0, 2, 3)))
    r_err = float((out[1] - outp[1]).abs().max() / got[1].abs().max())
    if not (seed_err <= tol and r_err <= tol):
        raise RuntimeError(f"fused_pcg_iter_w4: seed {seed_err:.3e}, r "
                           f"{r_err:.3e} > {tol:.3e}")
    row("fused_pcg_iter_w4", f"q3 B={B} seed+iteration", ms, pms, err, rel,
        tol, _pcg_iter_cost(D, fs.npad, B, fs.w_a, fs.w_p, fs.w_s))
    # the relaxation kernels
    al = 1.0 / D
    shape = (D, fs.npad, B, fs.w_p, fs.w_s)
    for name, tag, fn, plain, cost, reps in (
            ("fused_jacobi_iter_w4", f"q3 B={B} k",
             lambda: P["fused_jacobi_iter"](*ops, v, x0, k, alpha=al, **jkw),
             lambda: P["fused_jacobi_iter_plain"](*ops, v, x0, k, alpha=al,
                                                  **kw),
             _sweep_cost(*shape, 1, 5, JACOBI_SWEPT,
                         JACOBI_ELEM + JACOBI_K_ELEM), 10),
            ("fused_gauss_seidel_iter_w4", f"q3 B={B} k",
             lambda: P["fused_gauss_seidel_iter"](*ops, v, x0,
                                                  want_resid=True, **gkw),
             lambda: P["fused_gauss_seidel_iter_plain"](*ops, v, x0,
                                                        want_resid=True,
                                                        **kw),
             _sweep_cost(*shape, 1, GS_STATES, GS_SWEPT, GS_ELEM,
                         GS_K_FINAL), 3),
            ("mega_jacobi_w4", f"q3 B={B} warm {sweeps} it",
             lambda: P["mega_jacobi_solve"](*ops, v, x0, alpha=al,
                                            iters=sweeps, warm=True, **jkw),
             lambda: P["mega_jacobi_plain"](*ops, v, x0, alpha=al,
                                            iters=sweeps, warm=True, **kw),
             _sweep_cost(*shape, sweeps, 4, JACOBI_SWEPT,
                         JACOBI_ELEM + JACOBI_K_ELEM, warm=True), 3),
            ("mega_gauss_seidel_w4", f"q3 B={B} {sweeps} it",
             lambda: P["mega_gauss_seidel_solve"](*ops, v, x0, iters=sweeps,
                                                  **gkw),
             lambda: P["mega_gauss_seidel_plain"](*ops, v, x0, iters=sweeps,
                                                  **kw),
             _sweep_cost(*shape, sweeps, GS_STATES, GS_SWEPT, GS_ELEM,
                         GS_K_FINAL), 1)):
        ms, out = _event_ms(fn, reps=reps)
        pms, outp = _event_ms(plain, reps=1, warmup=0)
        row(name, tag, ms, pms, *_errs(_flat(out), _flat(outp)), tol, cost)
    for name, seq, fn, fkw_ in (
            ("jacobi", False, lambda f, a: f(*ops, v, x0, alpha=1.0, **a),
             jkw),
            ("gauss_seidel", True, lambda f, a: f(*ops, v, x0, **a), gkw)):
        kern, plain = (P[f"fused_{name}_iter{sfx}"] for sfx in ("", "_plain"))
        be = [P["sweep_backward_error"](*ops, v, x0, fn(f, a), sequential=seq,
                                        **kw)
              for f, a in ((kern, fkw_), (plain, kw))]
        print(f"backward error {name} sweep q3 (W = 4): kernel {be[0]:.3e} "
              f"plain {be[1]:.3e}", flush=True)
        if not be[0] <= 10 * max(be[1], eps):
            raise RuntimeError(f"{name} sweep q3: backward error "
                               f"{be[0]:.3e} > 10 x {be[1]:.3e}")
    return rows


def _diag_cond(band):
    """Largest condition number over the dimensions of a diagonal band
    stack (D, npad, 1)."""
    d = band[..., 0].abs()
    return float((d.amax(1) / d.amin(1)).max())


def _flat(ts):
    return torch.cat([t.flatten() for t in ts])


def _pcg_iter_cost(D, npad, B, w_a, w_p, w_s):
    """(bytes, flops) of one carried PCG iteration: the bands, the
    permutations, x, r, p read and written, rz read and written; per
    element the Mhat apply, the preconditioner and the updates, as
    ``_mega_cost`` counts one iteration."""
    N = D * npad * B
    nbytes = 8 * D * npad * (2 * w_a + 2 * w_p + 2 * w_s + 3) \
        + 4 * 2 * D * npad + 8 * (6 * N + 2 * B + 1)
    per = (2 * (2 * w_a + 1) + 2 * (2 * w_p + 1) + _solve_ops(w_p, B)
           + _solve_ops(w_s, B) + 14)
    return nbytes, N * per


def pcg_iter_kernel_phase(P, rng, dev, ops_path, ops_q1):
    """The per-iteration PCG kernel: the seed launch (cold and warm) and one
    carried iteration against their plain versions on the same state, at
    n = 30000, D = 10, B = 32 with q = 0 (the Schwefel operands) and q = 1
    (a jittered grid). The bar is max(1e-12, kappa eps), kappa the larger
    condition number of the Phi and SAPhi systems an iteration solves (as
    in ``relax_kernel_phase``); the updated r cancels (|alpha A p| >> |r|)
    and is judged at the scale of the residual it updates. Also the launch
    cost: one iteration per launch against the whole-solve kernel's time
    per iteration on the same operands."""
    rows = []
    eps = float(torch.finfo(torch.float64).eps)
    for tag, fs in (("path q=0 B=32", ops_path),
                    (f"q1 n={ops_q1.n} B=32", ops_q1)):
        kappa = max(_cond_est(P, fs, fs.saphi, fs.w_s),
                    _cond_est(P, fs, fs.phi, fs.w_p) if fs.w_p
                    else _diag_cond(fs.phi))
        tol = max(1e-12, kappa * eps)
        ops = (fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2)
        kw = dict(w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s)
        # the solves' block-CR factors, made once for the operand stack as
        # the paths make them
        fkw = dict(kw, factors=fs.cr_factors())
        v = fs.pad_state(torch.as_tensor(
            rng.standard_normal((fs.D, fs.n, B_PATH)), device=dev))
        x0 = fs.pad_state(torch.as_tensor(
            0.1 * rng.standard_normal((fs.D, fs.n, B_PATH)), device=dev))
        seed_err = 0.0
        for warm in (False, True):
            start = x0 if warm else torch.zeros_like(v)
            got = P["pcg_seed"](*ops, v, start, warm=warm, **fkw)
            want = P["pcg_seed_plain"](*ops, v, start, warm=warm, **kw)
            seed_err = max(seed_err, _errs(_flat(got), _flat(want))[1])
        ms, out = _event_ms(lambda: P["fused_pcg_iter"](*ops, *got, **fkw),
                            reps=10)
        pms, outp = _event_ms(lambda: P["fused_pcg_iter_plain"](*ops, *got,
                                                                **kw),
                              reps=1, warmup=0)
        err, rel = _errs(_flat(out[k] for k in (0, 2, 3)),
                         _flat(outp[k] for k in (0, 2, 3)))
        r_err = float((out[1] - outp[1]).abs().max() / got[1].abs().max())
        whole_ms, _ = _event_ms(lambda: P["mega_pcg_solve"](
            *ops, v, torch.zeros_like(v), iters=40, **fkw), reps=1)
        b_ms, b_by = _bound(*_pcg_iter_cost(fs.D, fs.npad, B_PATH, fs.w_a,
                                            fs.w_p, fs.w_s))
        print(f"kernel fused_pcg_iter {tag}: cond <= {kappa:.3e}, bar "
              f"{tol:.3e}; seed max_rel_err={seed_err:.3e}, iteration "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} r err (at |r|) "
              f"{r_err:.3e} kernel_ms={ms:.4f} plain_ms={pms:.4f} bound_ms="
              f"{b_ms:.4f} ({b_by}) library_ms=none; whole solve "
              f"{whole_ms / 40:.4f} ms an iteration, so one launch costs "
              f"{ms - whole_ms / 40:.4f} ms more", flush=True)
        if not (seed_err <= tol and rel <= tol and r_err <= tol):
            raise RuntimeError(f"fused_pcg_iter {tag}: errors {seed_err:.3e}"
                               f", {rel:.3e}, {r_err:.3e} > {tol:.3e}")
        if tag.startswith("path"):
            rows.append(dict(name="fused_pcg_iter", route="cuda",
                             source="src/repro_torch/csrc/mega_pcg.cu",
                             replaces="src/repro/kernels/fused_sweep.py:363",
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))
    return rows


def _kp_gram_cost(n, q):
    """(bytes, operations) of one kp_gram call: x and A read once, Phi
    written once; per kernel evaluation |x - x'|, omega r, the degree-q
    polynomial (2 q), its scale and the accumulation (7 + 2 q), an exp
    counted as one operation."""
    nbytes = 8 * n * (1 + (2 * q + 3) + (2 * q + 1))
    return nbytes, n * (2 * q + 1) * (2 * q + 3) * (8 + 2 * q)


def _host_ms(fn, reps=1000):
    """Host ms per call of ``fn`` (what the caller waits before it can
    enqueue more): perf_counter_ns around ``reps`` calls, no
    synchronisation inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t = (time.perf_counter_ns() - t0) / reps / 1e6
    torch.cuda.synchronize()
    return t


def launch_floor(P):
    """What the card allows a launch: the device time of a one-element
    ``add_`` (torch.profiler) and its host time, and the host time of a
    ctypes call into the kernel library that launches nothing
    (``repro_cr_apply_cols``)."""
    one = torch.zeros(1, dtype=torch.float64, device="cuda")
    add = lambda: one.add_(1.0)  # noqa: E731
    lib = P["_build"].load_library()
    return dict(add_device_ms=_device_ms(add)[0],
                add_host_ms=_host_ms(add),
                ctypes_ms=_host_ms(lambda: lib.repro_cr_apply_cols(10, 16)))


def kp_gram_phase(P, rng, dev):
    """kp_gram at n = 30000, q = 0, 1, 2, 3 on a jittered grid: the kernel
    against its plain version, its plain twin in the kernel's order
    (``kp_gram_table_plain``) and the Phi band ``kp_factors`` assembles
    (``gram_band_rows``). Phi = A K cancels by design (|Phi| falls to ~1e-6
    of the summed terms at q = 2), so the bars are 1e-12 of the terms'
    scale, max_i sum_t |A[i, t]| (|k| <= 1). Each q's line carries the
    event time (20 calls), the device time (torch.profiler), the wrapper's
    host time and the launch floor beside the bound."""
    rows = []
    xs = torch.as_tensor(np.sort(_jittered(rng, N_PATH, 1)[0][:, 0]),
                         device=dev)
    om = torch.tensor(4.0, dtype=torch.float64, device=dev)
    floor = launch_floor(P)
    for q in (0, 1, 2, 3):
        A, Phi = P["kp_factors"](q, om, xs)
        a = A.data.contiguous()
        call = lambda: P["kp_gram"](q, 4.0, xs, a)  # noqa: E731
        ms, got = _event_ms(call, reps=20)
        dev_ms, how = _device_ms(call)
        host_ms = _host_ms(call)
        pms, want = _event_ms(lambda: P["kp_gram_plain"](q, 4.0, xs, a),
                              reps=1, warmup=0)
        terms = float(a.abs().sum(-1).max())
        err = float((got - want).abs().max())
        twin = float((got - P["kp_gram_table_plain"](q, 4.0, xs, a))
                     .abs().max()) / terms
        fit_err = float((got - Phi.data).abs().max()) / terms
        b_ms, b_by = _bound(*_kp_gram_cost(N_PATH, q))
        print(f"kernel kp_gram q={q} n={N_PATH}: max_abs_err={err:.3e} "
              f"(at the terms' scale {err / terms:.3e}, tol 1e-12), vs its "
              f"twin {twin:.3e}, vs kp_factors' Phi {fit_err:.3e} "
              f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} ({how}) host_ms="
              f"{host_ms:.4f} plain_ms={pms:.4f} bound_ms={b_ms:.5f} "
              f"({b_by}) launch floor: add_ device "
              f"{floor['add_device_ms']:.4f} host "
              f"{floor['add_host_ms']:.4f}, ctypes "
              f"{floor['ctypes_ms']:.4f} library_ms=none",
              flush=True)
        if not max(err / terms, twin, fit_err) <= 1e-12:
            raise RuntimeError(f"kp_gram q={q}: {err / terms:.3e}, "
                               f"{twin:.3e}, {fit_err:.3e} > 1e-12")
        if q == 0:
            rows.append(dict(name="kp_gram", route="cuda",
                             source="src/repro_torch/csrc/kp_gram.cu",
                             replaces="src/repro/kernels/kp_gram.py:60",
                             max_abs_err=err, max_rel_err=err / terms,
                             ms=ms, plain_ms=pms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None))
    return rows


# iteration counts to tol = 1e-8 recorded by benchmarks/multigrid.py
# (benchmarks/BENCH_multigrid.json; the same on its jax and pallas rows):
# n -> (plain PCG, kmg)
MULTIGRID_RECORDED = {4096: (67, 27), 16384: (51, 17)}


def kmg_convergence(P, dev):
    """``benchmarks/multigrid.py``'s problem on the card (D = 4, omega = 2,
    sigma = 0.1, q = 0, tol = 1e-8, seed n, unfused solves): kmg must take
    fewer iterations than plain PCG, and each count must be within 2 of the
    recorded one. The walls are this card's own."""
    for n, (p_rec, k_rec) in MULTIGRID_RECORDED.items():
        D = 4
        rng = np.random.default_rng(n)
        X = rng.random((n, D))
        Y = np.sum(np.sin(3 * X), axis=1) + 0.1 * rng.standard_normal(n)
        gp = P["fit"](P["GPConfig"](q=0, precond="kmg", solver_iters=30), X,
                      Y, np.full(D, 2.0), 0.1)
        v = torch.as_tensor(rng.standard_normal((D, n)), device=dev)
        kmg = P["SolveConfig"](method="pcg", iters=400, tol=1e-8,
                               precond="kmg", fused="off")
        got = {}
        for name, cfg, hier in (("plain", P["SolveConfig"](
                method="pcg", iters=400, tol=1e-8, fused="off"), None),
                                ("kmg", kmg, gp.hier)):
            (_, info), t = _sync_time(lambda: P["solve_mhat"](
                gp.ops, v, cfg, hier=hier, return_info=True))
            got[name] = (int(info.iters), float(info.resid) / float(v.norm()),
                         t)
        print(f"kmg convergence n={n} D={D}: plain {got['plain'][0]} "
              f"iterations (recorded {p_rec}; rel resid "
              f"{got['plain'][1]:.3e}, {got['plain'][2] * 1e3:.1f} ms), kmg "
              f"{got['kmg'][0]} (recorded {k_rec}; rel resid "
              f"{got['kmg'][1]:.3e}, {got['kmg'][2] * 1e3:.1f} ms)",
              flush=True)
        if not (got["kmg"][0] < got["plain"][0]
                and abs(got["plain"][0] - p_rec) <= 2
                and abs(got["kmg"][0] - k_rec) <= 2):
            raise RuntimeError(f"kmg convergence n={n}: {got}")


def _block_diag_csr(band, lo, hi):
    """The (G, n, lo+hi+1) band stack as one block-diagonal CSR matrix (the
    library yardstick of the matvec; built once, outside the timing)."""
    G, n, w = band.shape
    dev = band.device
    i = torch.arange(n, device=dev)[:, None]
    j = i + torch.arange(-lo, hi + 1, device=dev)[None, :]
    keep = ((j >= 0) & (j < n)).expand(G, n, w)
    off = (torch.arange(G, device=dev) * n)[:, None, None]
    rows = (i + off).expand(G, n, w)[keep]
    cols = (j + off).expand(G, n, w)[keep]
    with warnings.catch_warnings():  # sparse CSR's beta-state notices
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), band[keep],
                                      (G * n, G * n))
        return coo.coalesce().to_sparse_csr()


def _gp_arrays(P, gp):
    """The fitted GP's own arrays (``gp_from_arrays``' keys) as numpy."""
    arrays = dict(X=gp.X, Y=gp.Y, omega=gp.omega, sigma=gp.sigma, xs=gp.xs,
                  sort_idx=gp.ops.sort_idx, rank_idx=gp.ops.rank_idx,
                  bY=gp.bY, u_sy=gp.u_sy)
    bands = dict(A=gp.ops.A, Phi=gp.ops.Phi, SAPhi=gp.ops.SAPhi, B=gp.B,
                 Psi=gp.Psi, Gband=gp.Gband, Hband=gp.Hband)
    arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
    if gp.n_active is not None:  # a capacity-padded GP, carried as it is
        arrays["n_active"] = gp.n_active.cpu().numpy()
    for k in P["BAND_KEYS"]:
        arrays[k] = bands[k].data.cpu().numpy()
        arrays[f"{k}_lo"], arrays[f"{k}_hi"] = bands[k].lo, bands[k].hi
    return arrays


def _gp_on(P, gp, dev):
    """The fitted GP's own arrays rebuilt on ``dev`` (``gp_from_arrays``)."""
    return P["gp_from_arrays"](_gp_arrays(P, gp), gp.config, dev)


def _refit_on(P, gp, dev):
    """``gp``'s fit redone on ``dev`` from its own KP factors: the DimOps
    (block-CR factors), the mean solve and the variance band on ``dev``;
    only the factor assembly's SVDs are left out (at q = 3 two LAPACK
    builds' null vectors differ, ROADMAP Queue 3)."""
    def band(b):
        return P["Banded"](b.data.to(dev), b.lo, b.hi)

    o = gp.ops
    ops = P["DimOps"](band(o.A), band(o.Phi), band(o.SAPhi),
                      o.sort_idx.to(dev), o.rank_idx.to(dev),
                      o.sigma2.to(dev), pivot=gp.config.pivot,
                      alg=gp.config.solve_alg)
    u_sy, bY, Gband, Hband = P["agp"].posterior_caches(gp.config, ops,
                                                       gp.Y.to(dev))
    return dataclasses.replace(
        gp, X=gp.X.to(dev), Y=gp.Y.to(dev), omega=gp.omega.to(dev),
        sigma=gp.sigma.to(dev), xs=gp.xs.to(dev), ops=ops, B=band(gp.B),
        Psi=band(gp.Psi), bY=bY, u_sy=u_sy, Gband=Gband, Hband=Hband,
        health=None)


def _backward_err(P, band, x, rhs, w):
    """Normwise backward error |B x - r| / (|B| |x| + |r|), max norms."""
    res = P["banded_matvec_plain"](band, x, w, w) - rhs
    return float(res.abs().max() / (band.abs().sum(-1).max() * x.abs().max()
                                    + rhs.abs().max()))


def _dense_solve(band, rhs):
    """Dense partial-pivot LU solve of the band (G, n, lo + hi + 1) with
    lo = hi: a library call, used only as a third solver in the check."""
    G, n, wb = band.data.shape
    M = band.data.new_zeros(G, n, n)
    for k in range(wb):
        off = k - band.lo
        i = torch.arange(max(0, -off), min(n, n - off), device=M.device)
        M[:, i, i + off] = band.data[:, i, k]
    return torch.stack([torch.linalg.solve(M[g], rhs[g]) for g in range(G)])


def _same_factors_rhs(P, g_cpu, V):
    """Psi P V, the right-hand sides of the gradients' B solves."""
    vs = g_cpu.ops.to_sorted(V[None].expand((g_cpu.D,) + tuple(V.shape)))
    return P["banded_matvec_plain"](g_cpu.Psi.data, vs.contiguous(),
                                    g_cpu.Psi.lo, g_cpu.Psi.hi)


def _grads(P, gp, v):
    go, gs = P["_mll_gradients"](gp, v)
    return torch.cat([go, gs.reshape(1)]).cpu()


def _same_factors_cpu(P, g_cpu, V):
    """The CPU side of :func:`schwefel_same_factors` (a worker's)."""
    xpu, ldpu = P["block_cr_plain"](g_cpu.B.data,
                                    _same_factors_rhs(P, g_cpu, V),
                                    g_cpu.B.lo)
    return dict(xpu=xpu.numpy(), ldpu=ldpu.numpy(),
                grads=_grads(P, g_cpu, V).numpy())


def schwefel_same_factors(P, g_cpu, V, dev, ref):
    """Card vs CPU on the Schwefel data from the SAME factors (the CPU fit's
    arrays rebuilt on the card), with a dense pivoted LU on the card as a
    third solver of the gradients' B systems (w = 2). ``ref`` holds the CPU
    side (:func:`_same_factors_cpu`, computed by a worker).

    cond(B) reaches 1e15..1e18 here (ROADMAP Queue 3), so the B solves, and
    the gradients through them, are fixed only up to the conditioning's
    amplification of rounding: the gradients' gaps are printed, not gated.
    The gate is the block-CR kernel's backward error on this B, which must
    be no larger than its plain version's: the kernel then computes what the
    plain block CR computes, and a gap in the solution is B's conditioning,
    not a fault of the kernel."""
    g_card = _gp_on(P, g_cpu, dev)
    Bc, w = g_cpu.B, g_cpu.B.lo
    rhs = _same_factors_rhs(P, g_cpu, V)
    Bd, rd = g_card.B.data, rhs.to(dev)
    xk, ldk = P["block_cr"](Bd, rd, w)
    xpc, ldpc = P["block_cr_plain"](Bd, rd, w)
    xpu, ldpu = (torch.as_tensor(ref[k]) for k in ("xpu", "ldpu"))
    xs = {"kernel": xk.cpu(), "plain card": xpc.cpu(), "plain cpu": xpu,
          "pivoted kernel": P["block_cr"](Bd, rd, w, pivot=True)[0].cpu(),
          "dense LU card": _dense_solve(g_card.B, rd).cpu()}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    be = {k: _backward_err(P, Bc.data, x, rhs, w) for k, x in xs.items()}
    print(f"Schwefel n={N_CHECK} B (w={w}) solves of Psi P V, max rel vs "
          "plain cpu: " + ", ".join(f"{k} {rel(x, xpu):.3e}"
                                    for k, x in xs.items())
          + f"; logdet kernel vs plain (card) {rel(ldk.cpu(), ldpc.cpu()):.3e}"
          f", plain card vs cpu {rel(ldpc.cpu(), ldpu):.3e}; backward "
          "errors " + ", ".join(f"{k} {v:.3e}" for k, v in be.items()),
          flush=True)
    eps = float(torch.finfo(torch.float64).eps)
    if not be["kernel"] <= 10.0 * max(be["plain card"], be["plain cpu"], eps):
        raise RuntimeError(f"block_cr on the Schwefel B: backward error "
                           f"{be} above the plain version's")

    g_ref = torch.as_tensor(ref["grads"])
    g_kernel = _grads(P, g_card, V.to(dev))
    agp, solve = P["agp"], P["agp"].solve
    agp.solve = lambda b, r, **kw: (_dense_solve(b, r) if b is g_card.B
                                    else solve(b, r, **kw))
    try:
        g_lu = _grads(P, g_card, V.to(dev))
    finally:
        agp.solve = solve
    print(f"Schwefel n={N_CHECK} D={D_PATH} mll_gradients from the same "
          f"factors, max rel vs the CPU (block CR): card (block_cr kernel) "
          f"{rel(g_kernel, g_ref):.3e}, card with dense-LU B solves "
          f"{rel(g_lu, g_ref):.3e} (conditioning; not a gate)", flush=True)
    if not bool(torch.isfinite(torch.cat([g_kernel, g_lu])).all()):
        raise RuntimeError("Schwefel gradients are not finite")


BO_KERNELS = ("banded_lu", "mega_pcg", "cr_factor", "cr_apply")


def _bo_counts(counts, calls=1):
    """The BO kernels' launches per call."""
    return ", ".join(f"{k} {counts[k] / calls:g}" for k in BO_KERNELS)


def bo_phase(P, gp, bounds, Xq, f, dev):
    """Bayesian optimisation (paper Sec. 6) on the main path's fitted GP
    (Schwefel, n = 30000, D = 10, q = 0, pcg "whole", 40 iterations): the
    acquisition value and gradient at m = 32 (UCB, beta = 2, and EI), the
    mean's gradient at the 100 queries, one ``propose_next`` (32 starts, 20
    ascent steps) and the refit loop (``bayes_opt_loop`` on the Schwefel
    function: n_init = 30000 points of its own draw, the path's omega and
    sigma, 3 rounds, hyperparameters re-learned at round 2 in 2 steps),
    each a wall ending in a synchronise with its launches per call.
    Returns the launch counts over the phase."""
    bo = P["bo"]
    _build = P["_build"]
    cfg = dataclasses.replace(gp.config, fused="whole")
    best = float(gp.Y.max())
    total = dict.fromkeys(_build.KERNELS, 0)

    def timed(name, fn, calls=1):
        _build.reset_launch_counts()
        out, t = _sync_time(fn)
        c = _build.launch_counts()
        for k, v in c.items():
            total[k] += v
        print(f"bo {name}: {t * 1e3:.1f} ms; launches per call: "
              f"{_bo_counts(c, calls)}", flush=True)
        return out, c

    m = B_PATH
    for kind in ("ucb", "ei"):
        (val, grad), c = timed(
            f"acquisition_value_and_grad {kind} m={m}",
            lambda: bo.acquisition_value_and_grad(gp, Xq[:m], 2.0, best,
                                                  kind=kind))
        _require_launched(f"acquisition ({kind})", c, ("banded_lu",
                                                       "mega_pcg"))
        if not (val.shape == (m,) and grad.shape == (m, D_PATH) and bool(
                torch.isfinite(torch.cat([val, grad.flatten()])).all())):
            raise RuntimeError(f"acquisition {kind}: not finite")
    dmu, _ = timed("posterior_mean_grad(100)",
                   lambda: P["posterior_mean_grad"](gp, Xq))
    if not (dmu.shape == (100, D_PATH) and bool(torch.isfinite(dmu).all())):
        raise RuntimeError("posterior_mean_grad: not finite")
    bcfg = bo.BOConfig(ascent_steps=20, n_starts=32, refit_every=2,
                       hyper_steps=2, incremental=False, use_engine=False)
    b = torch.as_tensor(bounds, device=dev)
    x, c = timed(f"propose_next ({bcfg.n_starts} starts, "
                 f"{bcfg.ascent_steps} steps)",
                 lambda: bo.propose_next(gp, b, torch.Generator().manual_seed(
                     5), bcfg, best), calls=bcfg.ascent_steps + 1)
    _require_launched("propose_next", c, ("banded_lu", "mega_pcg"))
    if not (x.shape == (D_PATH,) and bool(((x >= b[:, 0]) & (x <= b[:, 1]))
                                          .all())):
        raise RuntimeError(f"propose_next left the bounds: {x}")
    budget = 3
    (lgp, LX, LY, hist), c = timed(
        f"bayes_opt_loop (n_init={N_PATH}, {budget} rounds, refit_every="
        f"{bcfg.refit_every}, hyper_steps={bcfg.hyper_steps})",
        lambda: bo.bayes_opt_loop(f, b, budget, cfg, bcfg,
                                  torch.Generator().manual_seed(6),
                                  n_init=N_PATH, omega0=gp.omega,
                                  sigma0=float(gp.sigma)),
        calls=budget)
    print(f"bo loop: best {hist['best']}, sigma {hist['sigma']}; X "
          f"{tuple(LX.shape)}", flush=True)
    _require_launched("bayes_opt_loop", c, ("banded_lu", "mega_pcg"))
    if not (LX.shape == (N_PATH + budget, D_PATH) and lgp.n == N_PATH + budget
            and np.isfinite(hist["best"]).all()
            and hist["best"][-1] >= hist["best"][0]
            and bool(((LX >= b[:, 0]) & (LX <= b[:, 1])).all())):
        raise RuntimeError("bayes_opt_loop: bad history")
    return total


def _bo_cpu(P, g_cpu, Xq):
    """The CPU side of :func:`bo_consistency` (a worker's): EI's incumbent,
    the acquisition values and gradients, the mean's gradient."""
    bo = P["bo"]
    best = float(P["posterior_mean"](g_cpu, Xq, device="cpu").max())
    out = dict(best=best, pmg=P["posterior_mean_grad"](
        g_cpu, Xq, device="cpu").numpy())
    for kind in ("ucb", "ei"):
        out[kind] = [t.numpy() for t in bo.acquisition_value_and_grad(
            g_cpu, Xq, 2.0, best, kind=kind, device="cpu")]
    return out


def bo_consistency(P, g_card, ref, Xq, tag):
    """Card against the plain CPU port from two fits of the same data: the
    acquisition value and gradient (UCB, EI) and the mean's gradient (the
    CPU side ``ref``, :func:`_bo_cpu`). EI's incumbent is the largest
    posterior mean at the queries, so EI is of the posterior's scale there
    (at the data's best value it underflows to 0 on the Schwefel
    queries)."""
    bo = P["bo"]
    for kind in ("ucb", "ei"):
        got = bo.acquisition_value_and_grad(g_card, Xq, 2.0, ref["best"],
                                            kind=kind)
        for name, a, w in zip(("value", "grad"), got, ref[kind]):
            _check(f"{tag} acquisition {kind} {name}", a, torch.as_tensor(w))
    _check(f"{tag} posterior_mean_grad",
           P["posterior_mean_grad"](g_card, Xq), torch.as_tensor(ref["pmg"]))


def bo_finite_differences(P, cfg, X, Y, Xq, tag, eps=1e-5, bar=1e-4):
    """The card's mean and variance gradients (the variance's from the UCB
    gradient, beta = 2) against central differences of its own
    posterior_mean / posterior_var at ``Xq``, the JAX package's bar, on a
    card fit of (X, Y) (omega = 4, sigma = 1) whose solves run 200
    iterations: the gradient is that of the exact posterior variance, and
    on these grids 40 PCG iterations leave a relative residual of 9e-5
    (q = 0) and 1e-5 (q = 1), 200 below 1e-20 (plain version on the CPU),
    so a central difference of an unconverged variance is no witness."""
    g = P["fit"](dataclasses.replace(cfg, solver_iters=200), X, Y,
                 np.full(X.shape[1], 4.0), 1.0)
    Xq = torch.as_tensor(Xq, device=g.device)
    m, D = Xq.shape
    _, grad, _, var = P["bo"].acquisition_stats(g, Xq, 2.0, 0.0)
    dmu = P["posterior_mean_grad"](g, Xq)
    dvar = (grad - dmu) * torch.sqrt(var)[:, None]  # = 2 sqrt(s) / beta
    e = eps * torch.eye(D, dtype=Xq.dtype, device=Xq.device)
    pts = torch.stack([torch.stack([Xq + s * e[j] for j in range(D)])
                       for s in (1.0, -1.0)]).reshape(-1, D)
    mu_s = P["posterior_mean"](g, pts).reshape(2, D, m)
    var_s = P["posterior_var"](g, pts).reshape(2, D, m)
    fd_m = ((mu_s[0] - mu_s[1]) / (2 * eps)).T
    fd_v = ((var_s[0] - var_s[1]) / (2 * eps)).T
    gaps = (float((dmu - fd_m).abs().max()), float((dvar - fd_v).abs().max()))
    print(f"{tag} gradients vs central differences (eps {eps:g}): dmu "
          f"{gaps[0]:.3e}, dvar {gaps[1]:.3e} (bar {bar:g})", flush=True)
    if not max(gaps) < bar:
        raise RuntimeError(f"{tag}: gradients off their central differences")


def local_cache_check(P, dev, n=512, D=5, q=1):
    """The dense M-tilde cache on the card (jittered grid, omega = 4):
    ``acq_local`` against the operator path within 1e-8."""
    rng = np.random.default_rng(41)
    X, span = _jittered(rng, n, D)
    Y = np.sin(X * 6.0 * np.pi / span).sum(1) + 0.1 * rng.standard_normal(n)
    g = P["fit"](P["GPConfig"](q=q, solver_iters=80, precond="none"), X, Y,
                 np.full(D, 4.0), 1.0)
    bo = P["bo"]
    cache, t = _sync_time(lambda: bo.build_local_cache(g))
    Xq = torch.as_tensor(rng.uniform(0.0, span, (4, D)), device=dev)
    best = float(g.Y.max())
    gap = 0.0
    for kind in ("ucb", "ei"):
        vo, go = bo.acquisition_value_and_grad(g, Xq, 2.0, best, kind=kind)
        for i in range(len(Xq)):
            v, gr = bo.acq_local(g, cache, Xq[i], 2.0, best, kind=kind)
            gap = max(gap, _errs(v, vo[i])[1], _errs(gr, go[i])[1])
    print(f"bo local cache n={n} D={D} q={q}: build {t * 1e3:.1f} ms "
          f"({cache.M_tilde.numel() * 8 / 2**20:.1f} MiB); acq_local vs the "
          f"operator path max rel {gap:.3e} (tol 1e-8)", flush=True)
    if not gap < 1e-8:
        raise RuntimeError(f"acq_local off the operator path: {gap:.3e}")


# --- streaming (paper Sec. 6): capacity padding, insert and evict -------

# the capacity tier of the main path's streaming GP (_next_tier(N_PATH + 1))
# and the mutations of each stream phase
STREAM_CAP, N_MUT = 32768, 32
# the reference's own insert-vs-fresh-fit gaps (max abs) after 32 inserts
# at the phase's warm iterations (pcg 40 -> 10, kmg 50 -> 12): a CPU run of
# the JAX package on the Schwefel data at n = 4000 (scripts/stream_bar.py).
# The card's mean gaps at n = 30000 are held to 10x these; its variance
# gaps once the band is exact again (after the sentinel's or an explicit
# resync) to the card-vs-CPU bar, 1e-7 of the variance's scale; before
# that they carry the windowed band's truncation error on this dense
# data, printed, not gated
STREAM_BARS = {"pcg": dict(mean=1.2698369903318962e-04, var=0.7760257209813513,
                           var_after_resync=3.2664981830521356e-12),
               "kmg": dict(mean=3.0130129289318575e-06, var=0.7760257209813248,
                           var_after_resync=7.359668430240163e-13)}


def _count_syncs(fn):
    """``(fn(), host syncs, their sites)``: the call under
    ``torch.cuda.set_sync_debug_mode("warn")``, each synchronizing CUDA
    operation it made counted, with the file:line that made it."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return out, len(sites), sites


def _mutate(P, fn):
    """One timed mutation: ``(gp, record)``, the record its wall ms (ending
    in a synchronise), launches by kernel, host syncs (and their sites) and
    peak device MiB."""
    _build = P["_build"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    gp, nsync, sites = _count_syncs(fn)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    # the kmg hierarchy's restriction map is as wide as its busiest coarse
    # row, which depends on the points: its buffers (and the peak) follow
    width = gp.hier[0].r_idx.shape[-1] if gp.hier else None
    return gp, dict(ms=ms, launches=counts, syncs=nsync, sites=sites,
                    peak=torch.cuda.max_memory_allocated() / 2**20,
                    width=width)


def _stream_report(tag, op, recs, total):
    """Print one line per mutation, require the launches to be the same for
    every mutation of the kind and the peak memory to stay flat; add the
    launches to ``total``."""
    for i, r in enumerate(recs):
        print(f"stream {tag} {op} {i}: {r['ms']:.1f} ms, syncs {r['syncs']}, "
              f"peak {r['peak']:.1f} MiB", flush=True)
        for k, v in r["launches"].items():
            total[k] += v
    same = all(r["launches"] == recs[0]["launches"] for r in recs)
    peaks = [r["peak"] for r in recs]
    sites = {}
    for s in recs[-1]["sites"]:
        sites[s] = sites.get(s, 0) + 1
    ms = sorted(r["ms"] for r in recs)
    widths = sorted({r["width"] for r in recs if r["width"] is not None})
    # flat: within 1%, or on the kmg path within 10% (the restriction
    # map's data-dependent width, printed)
    slack = 1.10 if widths else 1.01
    wtxt = (f" (kmg restriction-map widths {widths[0]}-{widths[-1]})"
            if widths else "")
    print(f"stream {tag} {op}: {len(recs)} mutations, wall ms min "
          f"{ms[0]:.1f} median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}; "
          f"launches per {op} {recs[0]['launches']} (identical across "
          f"{op}s: {same}); host syncs per {op} "
          f"{sorted(set(r['syncs'] for r in recs))} at {sites}; peak MiB "
          f"{min(peaks):.1f}-{max(peaks):.1f}{wtxt}", flush=True)
    if not same:
        raise RuntimeError(f"stream {tag}: launches differ across {op}s")
    if max(peaks) > slack * min(peaks):
        raise RuntimeError(f"stream {tag}: peak memory not flat across "
                           f"{op}s: {min(peaks):.1f}-{max(peaks):.1f} MiB")


def _gaps(P, gp, ref, Xq):
    """Max |mean| and |variance| gaps of ``gp`` against ``ref`` at the
    queries (mean at all, variance at one chunk), and ``ref``'s largest
    variance."""
    mu = P["posterior_mean"](gp, Xq) - P["posterior_mean"](ref, Xq)
    v_ref = P["posterior_var"](ref, Xq[:B_PATH])
    var = P["posterior_var"](gp, Xq[:B_PATH]) - v_ref
    return (float(mu.abs().max()), float(var.abs().max()),
            float(v_ref.abs().max()))


def _row_gaps(gp, ref):
    """Max |A| and |B| gaps of ``gp``'s active factor rows against a fresh
    fit's of the same points (the window rows come from SVD batches of
    another size)."""
    k = ref.n
    return (float((gp.ops.A.data[:, :k] - ref.ops.A.data).abs().max()),
            float((gp.B.data[:, :k] - ref.B.data).abs().max()))


def _window_gap(P, gp):
    """The windowed Gband against the same device's full recompute on the
    GP's factors, max relative over the active rows."""
    k = gp.num_points()
    G = P["variance_band"](gp.ops.A, gp.ops.Phi).data[:, :k]
    return float((gp.Gband.canonical().data[:, :k] - G).abs().max()
                 / G.abs().max())


def stream_phase(P, tag, cfg, X, Y, Xn, Yn, omega, sigma, Xq, total, bar):
    """The main streaming phase on one configuration: ``fit(capacity=
    STREAM_CAP)``, N_MUT inserts of the staged points (on the card), the
    gaps against a fresh fit of the grown data, N_MUT evicts (the oldest),
    the gaps against a fresh fit of the surviving points, the windowed band
    against the full recompute and ``resync_gband``."""
    st = P["stream"]
    n = X.shape[0]
    gp, t_fit = _sync_time(lambda: P["fit"](cfg, X, Y, omega, sigma,
                                            capacity=STREAM_CAP))
    print(f"stream {tag}: fit(capacity={STREAM_CAP}) of n={n} {t_fit * 1e3:.1f}"
          f" ms; precond {gp.config.precond}, fused {gp.config.fused}, insert "
          f"iterations {max(8, gp.config.solver_iters // 4)}", flush=True)
    Xd = torch.as_tensor(Xn, device=gp.device)
    Yd = torch.as_tensor(Yn, device=gp.device)
    recs = []
    for i in range(N_MUT):
        gp, r = _mutate(P, lambda g=gp, i=i: st.insert(g, Xd[i], Yd[i],
                                                        count=n + i))
        recs.append(r)
    _stream_report(tag, "insert", recs, total)
    ref = P["fit"](cfg, np.concatenate([X, Xn]), np.concatenate([Y, Yn]),
                   omega, sigma)
    rows = _row_gaps(gp, ref)
    gm, gv, vscale = _gaps(P, gp, ref, Xq)
    gaps = {"insert mean": gm, "insert var": gv}
    drift = float(gp.health.drift)
    # the drift sentinel, as an insert without count= runs it
    gp, did = st.maybe_resync(gp)
    gaps["insert var after the sentinel"] = _gaps(P, gp, ref, Xq)[1]
    del ref
    recs = []
    for i in range(N_MUT):
        gp, r = _mutate(P, lambda g=gp, i=i: st.evict(g, count=n + N_MUT - i))
        recs.append(r)
    _stream_report(tag, "evict", recs, total)
    ref = P["fit"](cfg, np.concatenate([X[N_MUT:], Xn]),
                   np.concatenate([Y[N_MUT:], Yn]), omega, sigma)
    gaps.update(zip(("evict mean", "evict var"), _gaps(P, gp, ref, Xq)))
    wgap = _window_gap(P, gp)
    edrift = float(gp.health.drift)
    gp, t_rs = _sync_time(lambda: st.resync_gband(gp))
    gaps["evict var after resync_gband"] = _gaps(P, gp, ref, Xq)[1]
    rgap = _window_gap(P, gp)
    del ref
    print(f"stream {tag}: window rows vs a fresh fit's rows after the inserts"
          f" (the card's SVD batches differ in size; not a gate on these "
          f"clustered points): A {rows[0]:.3e}, B {rows[1]:.3e}", flush=True)
    print(f"stream {tag}: against a fresh fit of the same points (max abs): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (variance scale {vscale:.3e}); drift estimate after the "
          f"inserts {drift:.3e} (the sentinel resynced: {did}); the "
          f"reference's own gaps at n = 4000 on the CPU "
          f"(scripts/stream_bar.py): {bar}", flush=True)
    print(f"stream {tag}: windowed Gband vs the full recompute on the final "
          f"factors max rel {wgap:.3e}, drift estimate {edrift:.3e} "
          f"(DRIFT_TOL {P['DRIFT_TOL']:.0e}); resync_gband {t_rs * 1e3:.1f} "
          f"ms, after it {rgap:.3e}", flush=True)
    # the mean within 10x the reference's own gap; the variance, once the
    # band is exact again, within the card-vs-CPU bar (1e-7 of its scale):
    # what is left there is the solves' rounding and the window rows'
    mean_ok = max(gaps["insert mean"], gaps["evict mean"]) <= 10 * bar["mean"]
    var_ok = max(gaps["insert var after the sentinel"] if did else 0.0,
                 gaps["evict var after resync_gband"]) <= 1e-7 * vscale
    # the windowed band itself is not gated on this dense data: where the
    # patch has no decay to rely on it parts from the full recompute, and
    # the drift estimate (the reference's, bit for bit in the CPU tests)
    # may or may not see it (PERF.md); the jittered q = 0 stream of
    # mutation_paths holds it to 1e-10 where the truncation contract holds
    if not (mean_ok and var_ok and rgap == 0.0
            and all(np.isfinite(list(gaps.values())))):
        raise RuntimeError(f"stream {tag}: gaps {gaps}, resync {rgap:.3e}")
    return gp


def padded_parity(P, cfg, X, Y, omega, sigma, Xq):
    """Padded (capacity STREAM_CAP) against unpadded fit on the card: the
    fit's caches, mean(100), variance(32), log-likelihood and gradients
    with the same probes."""
    g = P["fit"](cfg, X, Y, omega, sigma)
    gp = P["fit"](cfg, X, Y, omega, sigma, capacity=STREAM_CAP)
    n = g.n
    caches = all(torch.equal(a, b) for a, b in (
        (g.bY, gp.bY[:, :n]), (g.u_sy, gp.u_sy[:, :n]),
        (g.Gband.data, gp.Gband.data[:, :n]), (g.ops.A.data,
                                               gp.ops.A.data[:, :n])))
    mean_same = torch.equal(P["posterior_mean"](g, Xq),
                            P["posterior_mean"](gp, Xq))
    va, vb = (P["posterior_var"](h, Xq[:B_PATH]) for h in (g, gp))
    vgap = float((va - vb).abs().max() / vb.abs().max())
    la, lb = (P["log_likelihood"](h, torch.Generator().manual_seed(11))
              for h in (g, gp))
    lgap = float(abs(la - lb) / abs(la))
    (oa, sa), (ob, sb) = (P["mll_gradients"](h, torch.Generator()
                                             .manual_seed(12))
                          for h in (g, gp))
    ggap = float(torch.cat([oa - ob, (sa - sb).reshape(1)]).abs().max()
                 / torch.cat([oa, sa.reshape(1)]).abs().max())
    print(f"padded (capacity {STREAM_CAP}) vs unpadded fit on the card, "
          f"n={n}: fit caches bitwise {caches}, mean(100) bitwise "
          f"{mean_same}, variance({B_PATH}) max rel {vgap:.3e}, "
          f"log_likelihood rel {lgap:.3e}, gradients max rel {ggap:.3e}",
          flush=True)
    if not (caches and mean_same and vgap <= 1e-12 and lgap <= 1e-12
            and ggap <= 1e-11):
        raise RuntimeError("padded and unpadded fits differ on the card")


def mutation_paths(P, X, Y, Xn, Yn, omega, sigma, Xq, dev, total):
    """One insert and one evict with each relaxation solver, "whole" and
    "on"; then a q = 3 jittered grid (pcg "whole", the half-width-4
    kernels) with 2 inserts and 2 evicts, whose Woodbury patch solves run
    the wide block CR (w = 8 inserting, 7 evicting), and a q = 0 jittered
    grid (omega spacing 0.4: the truncation contract holds) with 8 of
    each, its windowed band held to 1e-10 of the full recompute and its
    window rows to 1e-11 of a fresh fit's."""
    st = P["stream"]
    n = X.shape[0]
    for solver in ("gauss_seidel", "jacobi"):
        for fused in ("whole", "on"):
            cfg = P["GPConfig"](q=0, solver=solver, solver_iters=40,
                                precond="none", fused=fused)
            gp = P["fit"](cfg, X, Y, omega, sigma, capacity=STREAM_CAP)
            gp, ri = _mutate(P, lambda g=gp: st.insert(g, Xn[0], Yn[0],
                                                       count=n))
            gp, re = _mutate(P, lambda g=gp: st.evict(g, count=n + 1))
            mu = P["posterior_mean"](gp, Xq)
            sweep = ("mega_" if fused == "whole" else "fused_") + solver + (
                "_iter" if fused == "on" else "")
            print(f"stream {solver} {fused}: insert {ri['ms']:.1f} ms "
                  f"{ri['launches']}, evict {re['ms']:.1f} ms "
                  f"{re['launches']}; syncs {ri['syncs']} / {re['syncs']}; "
                  f"verdict {P['verdict_name'](gp.health.verdict)}",
                  flush=True)
            for r in (ri, re):
                for k, v in r["launches"].items():
                    total[k] += v
            if not (bool(torch.isfinite(mu).all()) and ri["launches"].get(
                    sweep) and re["launches"].get(sweep)):
                raise RuntimeError(f"stream {solver} {fused}: not finite, or "
                                   f"no {sweep} launch")
    for q, spacing, muts in ((3, 0.2, 2), (0, 0.1, 8)):
        r = np.random.default_rng(8 + q)
        Xj, span = _jittered(r, n + muts, D_PATH, spacing=spacing)
        Yj = np.sin(Xj * 6.0 * np.pi / span).sum(1) \
            + 0.1 * r.standard_normal(n + muts)
        cfg = P["GPConfig"](q=q, solver="pcg", solver_iters=40,
                            precond="none")
        gp = P["fit"](cfg, Xj[:n], Yj[:n], np.full(D_PATH, 4.0), sigma,
                      capacity=STREAM_CAP)
        Xd = torch.as_tensor(Xj[n:], device=dev)
        Yd = torch.as_tensor(Yj[n:], device=dev)
        ins, evs = [], []
        for i in range(muts):
            gp, rec = _mutate(P, lambda g=gp, i=i: st.insert(
                g, Xd[i], Yd[i], count=n + i))
            ins.append(rec)
        ref = P["fit"](cfg, Xj, Yj, np.full(D_PATH, 4.0), sigma)
        rows = _row_gaps(gp, ref)
        del ref
        for i in range(muts):
            gp, rec = _mutate(P, lambda g=gp, i=i: st.evict(
                g, count=n + muts - i))
            evs.append(rec)
        tag = f"q={q} jittered (omega spacing {spacing})"
        _stream_report(tag, "insert", ins, total)
        _stream_report(tag, "evict", evs, total)
        wgap = _window_gap(P, gp)
        print(f"stream {tag}: window rows vs a fresh fit's rows after the "
              f"inserts: A {rows[0]:.3e}, B {rows[1]:.3e}"
              f"{' (tol 1e-11)' if q == 0 else ''}; windowed Gband vs the "
              f"full recompute max rel {wgap:.3e}, drift estimate "
              f"{float(gp.health.drift):.3e}", flush=True)
        if q == 3:
            need = ("cr_factor_wide", "cr_apply_wide", "mega_pcg_w4")
            if not all(ins[0]["launches"].get(k) for k in need) or not all(
                    evs[0]["launches"].get(k) for k in need[:2]):
                raise RuntimeError("q = 3 stream: the wide block CR did not "
                                   "launch")
        elif not (wgap <= 1e-10 and max(rows) <= 1e-11):
            raise RuntimeError(f"q = 0 jittered stream: windowed band "
                               f"{wgap:.3e} > 1e-10 or window rows {rows}")


def wide_cr_rows(P, rng, dev):
    """The wide block-CR instantiations at the streaming patch shape of
    q = 3 (2 D = 20 bands of patch_size rows, 12 q + 17 columns): the
    insert's w = 8 and the evict's w = 7, pivoted (as the patch solves
    run), against their plain versions on the same CUDA tensors."""
    rows = []
    q = 3
    Pn = P["patch_size"](q, STREAM_CAP)
    Bc = 12 * q + 17
    out = {}
    for w in (8, 7):
        bd = P["pad_band"](_band(rng, 2 * D_PATH, Pn, w, w, dev), w)
        npad = bd.shape[1]
        rhs = torch.as_tensor(rng.standard_normal((2 * D_PATH, npad, Bc)),
                              device=dev)
        fms, (fac, ld) = _event_ms(lambda: P["block_cr_factor"](
            bd, w, pivot=True, logdet=True), reps=10)
        fpms, (facp, ldp) = _event_ms(lambda: P["block_cr_factor_plain"](
            bd, w, pivot=True, logdet=True), reps=1, warmup=0)
        ams, x = _event_ms(lambda: P["block_cr_apply"](fac, rhs, w,
                                                       pivot=True), reps=10)
        apms, xp = _event_ms(lambda: P["block_cr_apply_plain"](
            fac, rhs, w, pivot=True), reps=1, warmup=0)
        ferr, frel = _errs(torch.cat([fac.flatten(), ld]),
                           torch.cat([facp.flatten(), ldp]))
        aerr, arel = _errs(x, xp)
        nb = npad // w
        fsize = P["cr_factor_size"](nb, w)
        nev = sum(-(-nb // (2 << k)) for k in range((nb - 1).bit_length()))
        G = 2 * D_PATH
        fb = _bound(8 * G * (npad * (2 * w + 1) + fsize), G * nev * 18 * w ** 3)
        ab = _bound(8 * G * (fsize + 2 * npad * Bc), G * npad * Bc * 8.0 * w * w)
        print(f"kernel cr_factor_wide w={w} G={G} npad={npad} pivot: "
              f"max_abs_err={ferr:.3e} max_rel_err={frel:.3e} (tol 1e-12) "
              f"kernel_ms={fms:.4f} plain_ms={fpms:.4f} bound_ms={fb[0]:.4f} "
              f"({fb[1]})", flush=True)
        print(f"kernel cr_apply_wide w={w} G={G} npad={npad} B={Bc} pivot: "
              f"max_abs_err={aerr:.3e} max_rel_err={arel:.3e} (tol 1e-12) "
              f"kernel_ms={ams:.4f} plain_ms={apms:.4f} bound_ms={ab[0]:.4f} "
              f"({ab[1]})", flush=True)
        if not (frel <= 1e-12 and arel <= 1e-12):
            raise RuntimeError(f"wide block CR w={w}: {frel:.3e} / {arel:.3e}")
        out[w] = (ferr, fms, fpms, fb, aerr, ams, apms, ab)
    ferr, fms, fpms, fb, aerr, ams, apms, ab = out[8]
    rows.append(dict(name="cr_factor_wide", route="cuda",
                     source="src/repro_torch/csrc/block_cr.cu",
                     replaces="src/repro/kernels/block_cr.py:188",
                     max_abs_err=ferr, ms=fms, plain_ms=fpms, bound_ms=fb[0],
                     bound_by=fb[1], library_ms=None))
    rows.append(dict(name="cr_apply_wide", route="cuda",
                     source="src/repro_torch/csrc/block_cr.cu",
                     replaces="src/repro/kernels/block_cr.py:188",
                     max_abs_err=aerr, ms=ams, plain_ms=apms, bound_ms=ab[0],
                     bound_by=ab[1], library_ms=None))
    return rows


def engine_phase(P, gp, X, Y, Xn, Yn, bounds, Xq, total):
    """``GPServeEngine`` with 32 slots on the main path's GP: mean, var,
    acq and ascend queries, an insert staged behind the fence while ascents
    run (the version pinned at admission), ``window=`` mode draining an
    engine built above its window, and a capacity doubling."""
    st = P["stream"]
    _build = P["_build"]
    _build.reset_launch_counts()
    n = gp.n
    eng, t_new = _sync_time(lambda: st.GPServeEngine(gp, bounds,
                                                     batch_slots=32))
    kinds = ["mean", "var", "acq", "ascend"] * 8
    qs = [eng.submit(Xq[i], k, steps=5) for i, k in enumerate(kinds)]
    first, t1 = _sync_time(eng.step)
    eng.insert(Xn[0], Yn[0])  # staged: fences admission
    late = eng.submit(Xq[40], "mean")
    done, t_run = _sync_time(eng.run_until_done)
    c = _build.launch_counts()
    for k, v in c.items():
        total[k] += v
    pinned = [q.result["version"] for q in qs]
    want = float(P["posterior_mean"](eng.gp, Xq[40:41])[0])
    print(f"engine (32 slots, n={n}, capacity {eng.capacity}): built "
          f"{t_new * 1e3:.1f} ms; first tick {t1 * 1e3:.1f} ms retired "
          f"{len(first)}; the rest ({len(done)} queries, the staged insert at "
          f"the fence) {t_run * 1e3:.1f} ms; versions of the first 32 "
          f"{sorted(set(pinned))}, of the late query {late.result['version']}"
          f"; late mean vs posterior_mean |diff| "
          f"{abs(late.result['mean'] - want):.3e}; drift-sentinel resyncs at "
          f"the fence {eng.health_stats()['resyncs']}; launches {c}",
          flush=True)
    if not (eng.capacity == STREAM_CAP and set(pinned) == {0}
            and late.result["version"] == 1 and eng.num_points == n + 1
            and abs(late.result["mean"] - want) <= 1e-10 * max(1.0,
                                                                abs(want))
            and all(np.isfinite(q.result["value"]) for q in qs)):
        raise RuntimeError("engine: versions, fence or results wrong")
    # window mode: built above its window, the first insert drains to it
    W = n - 4
    w_eng = st.GPServeEngine(gp, bounds, batch_slots=32, window=W)
    w_eng.insert(Xn[1], Yn[1])
    _, t_w = _sync_time(w_eng.step)
    q = w_eng.submit(Xq[0], "var")
    w_eng.run_until_done()
    print(f"engine window={W}: drained to {w_eng.num_points} points "
          f"(capacity {w_eng.capacity}, version {w_eng.version}) in "
          f"{t_w * 1e3:.1f} ms; a variance query after it {q.result['var']:.6f}"
          f" at version {q.result['version']}", flush=True)
    if not (w_eng.num_points == W and w_eng.version == 6
            and q.result["version"] == 6 and q.result["var"] > 0):
        raise RuntimeError("engine window mode wrong")
    del w_eng
    # capacity doubling: an engine at a full tier grows on the next insert
    d_eng = st.GPServeEngine(gp, bounds, batch_slots=32, capacity=n)
    d_eng.insert(Xn[2], Yn[2])
    _, t_d = _sync_time(d_eng.step)
    print(f"engine capacity doubling: {n} -> {d_eng.capacity} on an insert "
          f"at a full tier, {t_d * 1e3:.1f} ms", flush=True)
    if not (d_eng.capacity == 2 * STREAM_CAP and d_eng.num_points == n + 1):
        raise RuntimeError("engine capacity doubling wrong")
    del d_eng


def bo_default_phase(P, gp, f, bounds, dev, total):
    """``bayes_opt_loop`` with the default BOConfig's streaming branch
    (incremental, engine) and the BO phase's settings (20 ascent steps, 32
    starts, hyperparameters re-learned at round 2 in 2 steps), 3 rounds
    from n_init = N_PATH."""
    bo = P["bo"]
    _build = P["_build"]
    _build.reset_launch_counts()
    bcfg = bo.BOConfig(ascent_steps=20, n_starts=32, refit_every=2,
                       hyper_steps=2)
    budget = 3
    b = torch.as_tensor(bounds, device=dev)
    cfg = dataclasses.replace(gp.config, fused="whole")
    (lgp, LX, LY, hist), t = _sync_time(lambda: bo.bayes_opt_loop(
        f, b, budget, cfg, bcfg, torch.Generator().manual_seed(6),
        n_init=N_PATH, omega0=gp.omega, sigma0=float(gp.sigma)))
    c = _build.launch_counts()
    for k, v in c.items():
        total[k] += v
    # a round's two parts on the main path's GP: a proposal through the
    # engine's slots and the insert behind its fence
    st = P["stream"]
    eng = st.GPServeEngine(gp, bounds, batch_slots=bcfg.n_starts,
                           kind=bcfg.kind, beta=bcfg.beta, lr=bcfg.lr)
    x, t_p = _sync_time(lambda: st.propose_via_engine(
        eng, torch.Generator().manual_seed(7), bcfg, float(gp.Y.max())))
    eng.insert(x, float(f(x)))
    _, t_i = _sync_time(eng.step)
    print(f"bo default loop BOConfig() (incremental, engine; {budget} rounds, "
          f"n_init={N_PATH}, refit_every={bcfg.refit_every}): {t * 1e3:.1f} "
          f"ms, {t * 1e3 / budget:.1f} ms a round (the refit loop: 2782 ms a "
          f"round, PERF.md); one propose_via_engine {t_p * 1e3:.1f} ms, one "
          f"insert at the fence {t_i * 1e3:.1f} ms; best {hist['best']}; "
          f"capacity {lgp.n}, {lgp.num_points()} points; launches {c}",
          flush=True)
    if not (LX.shape == (N_PATH + budget, D_PATH)
            and lgp.num_points() == N_PATH + budget
            and np.isfinite(hist["best"]).all()
            and bool(((LX >= b[:, 0]) & (LX <= b[:, 1])).all())):
        raise RuntimeError("default bayes_opt_loop: bad history")


def _stream_cases(P, lu=False):
    """The streaming consistency cases: the Schwefel data at N_CHECK, the
    mutations' points, the queries, and (tag, config, mutations); with
    ``lu`` the ``solve_alg="lu"`` GPs, unpivoted and pivoted, whose
    Woodbury patch solves take the pivoted banded LU."""
    D = D_PATH
    Xc, Yc, f, bc = P["sample_test_function"]("schwefel", N_CHECK, D, seed=0)
    r = np.random.default_rng(12)
    Xn = r.uniform(bc[:, 0], bc[:, 1], (4, D))
    Yn = f(Xn) + r.standard_normal(4)
    omc = 8.0 / (bc[:, 1] - bc[:, 0])
    Xq = np.random.default_rng(1).uniform(bc[:, 0], bc[:, 1], (100, D))
    cases = (("pcg whole", P["GPConfig"](q=0, solver_iters=40,
                                         precond="none"), 4),
             ("kmg", P["GPConfig"](q=0, precond="kmg"), 1))
    if lu:
        cases = tuple((f"lu pivot={pv}", P["GPConfig"](
            q=0, solver_iters=40, precond="none", pivot=pv, solve_alg="lu"),
            4) for pv in (False, True))
    return (Xc, Yc, omc, Xn, Yn, Xq), cases


def _mutated(P, h, Xn, Yn, muts, d):
    st = P["stream"]
    for i in range(muts):
        h = st.insert(h, torch.as_tensor(Xn[i], device=d), Yn[i],
                      count=N_CHECK + i)
    for i in range(muts):
        h = st.evict(h, count=N_CHECK + muts - i)
    return h


def _stream_cpu(P, lu=False):
    """The CPU side of :func:`stream_consistency` (a worker's): per case the
    padded fit's arrays (the card's starting state) and, after the
    mutations, the mean, variance and windowed band."""
    (Xc, Yc, omc, Xn, Yn, Xq), cases = _stream_cases(P, lu)
    out = {}
    for tag, cfg, muts in cases:
        g = P["fit"](cfg, Xc, Yc, omc, 1.0, device="cpu", capacity=4096)
        start = _gp_arrays(P, g)
        g = _mutated(P, g, Xn, Yn, muts, "cpu")
        k = g.num_points()
        out[tag] = dict(start=start, k=k, mean=P["posterior_mean"](
            g, Xq, device="cpu").numpy(), var=P["posterior_var"](
                g, Xq[:8], device="cpu").numpy(),
            gband=g.Gband.data[:, :k].numpy())
    return out


def stream_consistency(P, dev, ref, lu=False):
    """Card against the plain CPU port at n = N_CHECK from ONE carried
    state (the CPU's padded fit rebuilt on the card): 4 inserts and 4
    evicts with pcg "whole", 1 and 1 with kmg (its plain V-cycles bound
    the CPU side's time), or with ``lu`` 4 and 4 for each of the
    ``solve_alg="lu"`` GPs, on both sides (the CPU's in a worker,
    :func:`_stream_cpu`); mean, variance and the windowed band within
    1e-7."""
    D = D_PATH
    (_, _, _, Xn, Yn, Xq), cases = _stream_cases(P, lu)
    for tag, cfg, muts in cases:
        r = ref[tag]
        g = _mutated(P, P["gp_from_arrays"](r["start"], cfg, dev), Xn, Yn,
                     muts, dev)
        k = r["k"]
        _check(f"stream n={N_CHECK} D={D} {tag} {muts} inserts + {muts} "
               "evicts mean", P["posterior_mean"](g, Xq),
               torch.as_tensor(r["mean"]))
        _check(f"stream n={N_CHECK} D={D} {tag} {muts} inserts + {muts} "
               "evicts var", P["posterior_var"](g, Xq[:8]),
               torch.as_tensor(r["var"]))
        _check(f"stream n={N_CHECK} D={D} {tag} windowed Gband",
               g.Gband.data[:, :k], torch.as_tensor(r["gband"]))


# ---------------------------------------------------------------------------
# the fleet: T GPs stacked on a leading tenant axis (core.fleet)
# ---------------------------------------------------------------------------

FLEET_T, FLEET_CAP, FLEET_M = 64, 2048, 32
FLEET_KERNELS = {
    "mega_pcg_fleet": ("src/repro_torch/csrc/mega_pcg.cu",
                       "src/repro/kernels/mega_solve.py:268"),
    "fused_pcg_iter_fleet": ("src/repro_torch/csrc/mega_pcg.cu",
                             "src/repro/kernels/fused_sweep.py:363"),
    "mega_pcg_fleet_w4": ("src/repro_torch/csrc/mega_pcg.cu",
                          "src/repro/kernels/mega_solve.py:268"),
    "fused_pcg_iter_fleet_w4": ("src/repro_torch/csrc/mega_pcg.cu",
                                "src/repro/kernels/fused_sweep.py:363"),
}


def _fleet_data(P, T, counts, D, seed):
    """Per-tenant Schwefel data (tenant t from seed + t), tenant t with
    ``counts[t]`` points, and 32 queries each (T, m, D)."""
    data = [P["sample_test_function"]("schwefel", int(c), D, seed=seed + t)
            for t, c in enumerate(counts)]
    bounds = data[0][3]
    rq = np.random.default_rng(seed + 1000)
    Xq = rq.uniform(bounds[:, 0], bounds[:, 1], (T, FLEET_M, D))
    return [d[0] for d in data], [d[1] for d in data], Xq, bounds


def _op(P, fn):
    """One timed op: ``(out, record)``, the record its wall ms (ending in a
    synchronise), launches by kernel, host syncs and peak device MiB."""
    _build = P["_build"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out, nsync, _ = _count_syncs(fn)
    torch.cuda.synchronize()
    return out, dict(ms=(time.perf_counter() - t0) * 1e3,
                     launches={k: v for k, v in
                               _build.launch_counts().items() if v},
                     syncs=nsync,
                     peak=torch.cuda.max_memory_allocated() / 2**20)


def _fleet_ops(P, T, dev, D=D_PATH, seed=500):
    """Every fleet op once at T tenants (counts 1500..2000 in capacity 2048,
    a T = 64 serving fleet's shape): ``{op: record}`` and the fleet. The
    fit is ``fleet_fit`` at n = 1500 for every tenant; the ops after it run
    on the stack of the tenants' own fits (``stack_gps``), whose counts
    differ."""
    fl, st = P["fleet"], P["stream"]
    cfg = P["GPConfig"]()
    counts = np.linspace(1500, 2000, T).astype(int)
    Xs, Ys, Xq, bounds = _fleet_data(P, T, counts, D, seed)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    X0 = np.stack([x[:1500] for x in Xs])
    Y0 = np.stack([y[:1500] for y in Ys])
    rec = {}
    fit0, rec["fleet_fit"] = _op(P, lambda: fl.fleet_fit(
        cfg, X0, Y0, omega, 1.0, FLEET_CAP))
    gps = [P["fit"](cfg, x, y, omega, 1.0, capacity=FLEET_CAP)
           for x, y in zip(Xs, Ys)]
    fleet = fl.stack_gps(gps)
    Xqt = torch.as_tensor(Xq, device=dev)
    _, rec["fleet_posterior_mean"] = _op(
        P, lambda: fl.fleet_posterior_mean(fleet, Xqt))
    _, rec["fleet_posterior_var"] = _op(
        P, lambda: fl.fleet_posterior_var(fleet, Xqt))
    best = torch.as_tensor([float(y.max()) for y in Ys], device=dev)
    _, rec["fleet_acquisition_stats"] = _op(
        P, lambda: fl.fleet_acquisition_stats(fleet, Xqt, 2.0, best,
                                              kind="ei"))
    rs = np.random.default_rng(seed + 2000)
    xn = rs.uniform(bounds[:, 0], bounds[:, 1], (T, D))
    yn = rs.standard_normal(T)
    do = np.arange(T) % 2 == 0
    grown, rec["fleet_insert"] = _op(P, lambda: st.fleet_insert(
        fleet, xn, yn, do, counts=counts))
    _, rec["fleet_evict"] = _op(P, lambda: st.fleet_evict(
        grown, do, counts=counts + do))
    # the engine: the tenants in two tiers (2048, 4096) x 8 slots, one
    # acquisition query a slot, one tick
    caps = [FLEET_CAP if t < T // 2 else 2 * FLEET_CAP for t in range(T)]
    eng = st.GPFleetEngine(gps, bounds, batch_slots=8, capacity=caps)
    for t in range(T):
        for i in range(8):
            eng.submit(t, Xq[t, i % FLEET_M], kind="acq")
    done, rec["GPFleetEngine tick"] = _op(P, eng.step)
    if len(done) != 8 * T or len(eng.groups) != 2:
        raise RuntimeError(f"fleet engine: {len(done)} of {8 * T} retired, "
                           f"{len(eng.groups)} tier groups")
    return rec, dict(gps=gps, fleet=fleet, Xs=Xs, Ys=Ys, X0=X0, Y0=Y0,
                     Xq=Xqt, best=best, xn=xn, yn=yn, do=do, counts=counts,
                     bounds=bounds, omega=omega, cfg=cfg, caps=caps)


def _standalone_ops(P, s):
    """The same work as :func:`_fleet_ops`, one standalone single-GP call a
    tenant: ``{op: record}``."""
    st, cfg = P["stream"], s["cfg"]
    gps, T = s["gps"], len(s["gps"])
    rec = {}
    _, rec["fleet_fit"] = _op(P, lambda: [
        P["fit"](cfg, x, y, s["omega"], 1.0, capacity=FLEET_CAP)
        for x, y in zip(s["X0"], s["Y0"])])
    _, rec["fleet_posterior_mean"] = _op(P, lambda: [
        P["posterior_mean"](g, s["Xq"][t]) for t, g in enumerate(gps)])
    _, rec["fleet_posterior_var"] = _op(P, lambda: [
        P["posterior_var"](g, s["Xq"][t]) for t, g in enumerate(gps)])
    _, rec["fleet_acquisition_stats"] = _op(P, lambda: [
        P["bo"].acquisition_stats(g, s["Xq"][t], 2.0, s["best"][t],
                                  kind="ei") for t, g in enumerate(gps)])
    sel = [t for t in range(T) if s["do"][t]]
    grown, rec["fleet_insert"] = _op(P, lambda: [
        st.insert(gps[t], s["xn"][t], s["yn"][t], count=int(s["counts"][t]))
        for t in sel])
    _, rec["fleet_evict"] = _op(P, lambda: [
        st.evict(g, count=int(s["counts"][t]) + 1)
        for g, t in zip(grown, sel)])
    engs = [st.GPServeEngine(g, s["bounds"], batch_slots=8, capacity=c)
            for g, c in zip(gps, s["caps"])]
    for t, e in enumerate(engs):
        for i in range(8):
            e.submit(s["Xq"][t, i % FLEET_M].cpu().numpy(), kind="acq")
    _, rec["GPFleetEngine tick"] = _op(P, lambda: [e.step() for e in engs])
    for op, r in rec.items():
        r["calls"] = len(sel) if op in ("fleet_insert", "fleet_evict") else T
    return rec


def _lane_gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def fleet_lanes(P, dev):
    """The main path's shape, T = 4 tenants at n = 30000 (capacity 32768,
    D = 10, q = 0, precond "none"): each lane against its standalone card
    GP, the fit caches within 1e-12 (bit for bit so far), the mean at 100
    and the variance at 32 queries within the card-vs-CPU bar 1e-7 (their
    einsums run on cuBLAS batched GEMM, whose rounding follows the batch,
    and the variance's terms cancel: ``scripts/lane_gap.py``); the
    standalone GP's own gap with the same queries in a batch 2-4x as large
    is printed beside; a T = 1 fleet against the single GP bit for bit;
    pcg "on" against "whole" bit for bit; a q = 3 fleet on a jittered grid
    (the MAXW = 4 tenant-axis kernels), its lanes' caches within 1e-6 of
    standalone fits; the card against the plain CPU fleet at T = 4,
    n = 500 (jittered grid) within 1e-7. Returns the launch counts."""
    fl = P["fleet"]
    _build = P["_build"]
    total = dict.fromkeys(_build.KERNELS, 0)
    T, n, cap, D = 4, N_PATH, 32768, D_PATH
    cfg = P["GPConfig"](q=0, precond="none")
    Xs, Ys, Xq, bounds = _fleet_data(P, T, [n] * T, D, 600)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    rq = np.random.default_rng(601)
    Xq100 = torch.as_tensor(rq.uniform(bounds[:, 0], bounds[:, 1],
                                       (T, 100, D)), device=dev)
    _build.reset_launch_counts()
    fleet, t_fit = _sync_time(lambda: fl.fleet_fit(
        cfg, np.stack(Xs), np.stack(Ys), omega, 1.0, cap))
    mu, t_mu = _sync_time(lambda: fl.fleet_posterior_mean(fleet, Xq100))
    var, t_var = _sync_time(lambda: fl.fleet_posterior_var(
        fleet, Xq100[:, :B_PATH]))
    c = _build.launch_counts()
    for k, v in c.items():
        total[k] += v
    print(f"fleet T={T} n={n} (capacity {cap}) D={D}: fleet_fit "
          f"{t_fit * 1e3:.1f} ms, mean(100) {t_mu * 1e3:.1f} ms, "
          f"var({B_PATH}) {t_var * 1e3:.1f} ms; launches "
          f"{ {k: v for k, v in c.items() if v} }", flush=True)
    worst = 0.0
    bitwise = {}
    for t in range(T):
        g = P["fit"](cfg, Xs[t], Ys[t], omega, 1.0, capacity=cap)
        lane = fleet.tenant(t)
        caches = [(lane.u_sy, g.u_sy), (lane.bY, g.bY),
                  (lane.Gband.data, g.Gband.data)]
        cgap = max(_lane_gap(a, b) for a, b in caches)
        bitwise.setdefault("caches", []).append(
            all(torch.equal(a, b) for a, b in caches))
        m1 = P["posterior_mean"](g, Xq100[t])
        v1 = P["posterior_var"](g, Xq100[t, :B_PATH])
        # the standalone's own batching gap, printed beside: the same
        # queries inside a batch 2, 3, 4 times as large (other cuBLAS
        # batched-GEMM kernels in the query windows' einsums)
        sm = max(_lane_gap(P["posterior_mean"](
            g, Xq100[t].repeat(k, 1))[:100], m1) for k in (2, 3, 4))
        sv = max(_lane_gap(P["posterior_var"](
            g, Xq100[t, :B_PATH].repeat(k, 1))[:B_PATH], v1)
            for k in (2, 3, 4))
        gm, gv = _lane_gap(mu[t], m1), _lane_gap(var[t], v1)
        bitwise.setdefault("mean", []).append(torch.equal(mu[t], m1))
        bitwise.setdefault("var", []).append(torch.equal(var[t], v1))
        print(f"fleet lane {t} vs its standalone card GP: caches max rel "
              f"{cgap:.3e}, mean(100) {gm:.3e}, var({B_PATH}) {gv:.3e}; "
              f"the standalone against itself in query batches 2-4x as "
              f"large: mean {sm:.3e}, var {sv:.3e}", flush=True)
        if not (cgap <= 1e-12 and gm <= 1e-7 and gv <= 1e-7):
            raise RuntimeError(f"fleet lane {t} parts from its standalone GP")
        worst = max(worst, cgap)
        del g
    print(f"fleet lanes bit for bit with their standalone GPs: "
          f"{ {k: all(v) for k, v in bitwise.items()} }", flush=True)
    # T = 1: the single GP's bits
    one = fl.fleet_fit(cfg, np.stack(Xs[:1]), np.stack(Ys[:1]), omega, 1.0,
                       cap)
    g0 = P["fit"](cfg, Xs[0], Ys[0], omega, 1.0, capacity=cap)
    same = (torch.equal(one.gp.u_sy[0], g0.u_sy)
            and torch.equal(one.gp.Gband.data[0], g0.Gband.data)
            and torch.equal(fl.fleet_posterior_mean(one, Xq100[:1])[0],
                            P["posterior_mean"](g0, Xq100[0]))
            and torch.equal(fl.fleet_posterior_var(
                one, Xq100[:1, :B_PATH])[0],
                P["posterior_var"](g0, Xq100[0, :B_PATH])))
    print(f"fleet T=1 == single GP (caches, mean, var): bitwise {same}",
          flush=True)
    if not same:
        raise RuntimeError("a one-tenant fleet differs from the single GP")
    del fleet, one, g0
    # pcg fused="on" (a seed and one carried launch an iteration) against
    # "whole", bit for bit, at T = 4, n = 2000
    won = []
    for fused in ("whole", "on"):
        _build.reset_launch_counts()
        fo = fl.fleet_fit(dataclasses.replace(cfg, fused=fused),
                          np.stack([x[:2000] for x in Xs]),
                          np.stack([y[:2000] for y in Ys]), omega, 1.0, 2048)
        won.append((fo.gp.u_sy, fl.fleet_posterior_var(fo, Xq100[:, :B_PATH])))
        for k, v in _build.launch_counts().items():
            total[k] += v
    same_on = all(torch.equal(a, b) for a, b in zip(*won))
    print(f"fleet pcg fused=on == whole (caches, var): bitwise {same_on}",
          flush=True)
    if not same_on:
        raise RuntimeError("fleet: 'on' and 'whole' differ")
    del won, fo
    # q = 3 on a jittered grid: the MAXW = 4 tenant-axis kernel
    rj = np.random.default_rng(602)
    n3 = 2000
    X3 = np.stack([_jittered(rj, n3, D, spacing=0.2)[0] for _ in range(T)])
    span3 = 0.2 * n3 / 4.0
    Y3 = np.sin(X3 * 6.0 * np.pi / span3).sum(-1) \
        + 0.1 * rj.standard_normal((T, n3))
    Xq3 = torch.as_tensor(rj.uniform(0.0, span3, (T, B_PATH, D)),
                          device=dev)
    cfg3 = P["GPConfig"](q=3, solver_iters=40, precond="none")
    _build.reset_launch_counts()
    f3 = fl.fleet_fit(cfg3, X3, Y3, np.full(D, 4.0), 1.0, n3)
    v3 = fl.fleet_posterior_var(f3, Xq3)
    f3on = fl.fleet_fit(dataclasses.replace(cfg3, fused="on"), X3, Y3,
                        np.full(D, 4.0), 1.0, n3)
    same3 = (torch.equal(f3on.gp.u_sy, f3.gp.u_sy)
             and torch.equal(fl.fleet_posterior_var(f3on, Xq3), v3))
    c3 = _build.launch_counts()
    for k, v in c3.items():
        total[k] += v
    # each lane's caches against the single-GP solves of its own factors
    # (bit for bit), and against a standalone fit within 1e-6 (Phi's
    # einsum rounds by batch, scripts/lane_gap.py, and the q = 3 solves
    # on this grid amplify it to ~1e-7; ROADMAP Queue 3)
    gaps3, own3 = [], []
    for t in range(T):
        lane = fl.tenant_gp(f3.gp, t)
        u1, b1 = P["agp"].mean_caches(cfg3, lane.ops, lane.Y)
        gaps3.append(max(_lane_gap(f3.gp.u_sy[t], u1),
                         _lane_gap(f3.gp.bY[t], b1)))
        g = P["fit"](f3.config, X3[t], Y3[t], np.full(D, 4.0), 1.0,
                     capacity=n3)
        own3.append(_lane_gap(f3.gp.u_sy[t], g.u_sy))
    print(f"fleet q=3 T={T} n={n3} (jittered grid): fused "
          f"{f3.config.fused}, lanes' caches vs the single-GP solves of "
          f"their own factors max rel {max(gaps3):.3e}, vs standalone fits "
          f"{max(own3):.3e} (bar 1e-6); var finite "
          f"{bool(torch.isfinite(v3).all())}; on == whole bitwise {same3}; "
          f"launches { {k: v for k, v in c3.items() if v} }", flush=True)
    if not (max(gaps3) <= 1e-12 and max(own3) <= 1e-6
            and bool(torch.isfinite(v3).all())
            and same3 and c3["mega_pcg_fleet_w4"] > 0
            and c3["fused_pcg_iter_fleet_w4"] > 0):
        raise RuntimeError("q = 3 fleet wrong, or its kernel not launched")
    del f3, f3on
    # card against the plain CPU fleet at T = 4, n = 500 (jittered grid)
    nc = 500
    Xc = np.stack([_jittered(rj, nc, D)[0] for _ in range(T)])
    Yc = np.sin(Xc * 6.0 * np.pi / (0.1 * nc / 4.0)).sum(-1) \
        + 0.1 * rj.standard_normal((T, nc))
    Xqc = rj.uniform(0.0, 0.1 * nc / 4.0, (T, B_PATH, D))
    cc = P["GPConfig"](q=0, precond="none")
    fc = [fl.fleet_fit(cc, Xc, Yc, np.full(D, 4.0), 1.0, 512, device=d)
          for d in (None, "cpu")]
    for name, fn in (("mean", fl.fleet_posterior_mean),
                     ("var", fl.fleet_posterior_var)):
        _check(f"fleet T={T} n={nc} D={D} {name}", fn(fc[0], Xqc),
               fn(fc[1], Xqc, device="cpu"))
    return total


def fleet_kernel_rows(P, dev, s):
    """The PCG kernel's launches over T > 1 tenants (``csrc/mega_pcg.cu``,
    counted as ``mega_pcg_fleet`` etc.): the whole solve at the serving
    fleet's shape (T = 64, D = 10, npad = 2048, B = 32, 40 iterations) and
    one carried iteration, timed against the 64 one-system launches they
    replace; held against the plain version (tenant by tenant) on the first
    4 tenants' operands; and the MAXW = 4 pair at q = 3 (T = 4, n = 2000,
    jittered grid; the plain version on one and two tenants). Each lane of
    the T = 64 launch against its one-system launch: within 1e-12 (bit for
    bit in every run so far)."""
    fs = P["FusedSweep"]
    rows = []
    stack = s["fleet"].gp
    ops = stack.ops
    fsw = fs(ops.Phi.data, ops.SAPhi.data, ops.sort_idx, ops.rank_idx,
             ops.sigma2, w_p=ops.Phi.lo, w_s=ops.SAPhi.lo, a=ops.A.data,
             w_a=ops.A.lo, factors=(ops.phi_factor, ops.saphi_factor),
             n_active=ops.n_active)
    rng = np.random.default_rng(77)
    T, D, B = fsw.lead[0], fsw.D, B_PATH
    v = fsw.pad_state(torch.as_tensor(rng.standard_normal(
        (T, D, fsw.n, B)), device=dev))
    zero = torch.zeros_like(v)
    pops = (fsw.a, fsw.phi, fsw.saphi, fsw.sort_idx, fsw.rank_idx,
            fsw.sigma2)
    kw = dict(w_a=fsw.w_a, w_p=fsw.w_p, w_s=fsw.w_s)
    fac = fsw.cr_factors()
    ms, (x, r, it) = _event_ms(lambda: P["mega_pcg_solve"](
        *pops, v, zero, iters=40, factors=fac, **kw), reps=3)
    # the same solves as 64 one-system launches
    lane_ops = [(tuple(o[t] for o in pops[:5]) + (pops[5][t:t + 1],))
                for t in range(T)]
    lane_fac = [tuple(None if f is None else P["fsm"]._lane_factor(f, t)
                      for f in fac) for t in range(T)]
    sms, outs = _event_ms(lambda: [P["mega_pcg_solve"](
        *lane_ops[t], v[t], zero[t], iters=40, factors=lane_fac[t], **kw)
        for t in range(T)], reps=1)
    lane_bits = all(torch.equal(x[t], outs[t][0]) for t in range(T))
    lane_gap = max(_lane_gap(x[t], outs[t][0]) for t in range(T))
    # against the plain version (tenant by tenant) at T = 4. x within the
    # serving path's 1e-7; the recursive residual r at the scale of v
    # within 1e-7, or within what one-system launches leave on the
    # same tenants (these tenants' systems, omega * spacing ~0.004, are
    # conditioned far worse than the main path's)
    T8 = 4
    sl = tuple(o[:T8] for o in pops)
    pms, (xp, rp, itp) = _event_ms(lambda: P["mega_pcg_plain"](
        *sl, v[:T8], zero[:T8], iters=40, **kw), reps=1, warmup=0)
    err, rel = _errs(x[:T8], xp)
    r_err = float((r[:T8] - rp).abs().max()) / float(v.abs().max())
    r_single = max(float((outs[t][1] - rp[t]).abs().max())
                   for t in range(T8)) / float(v.abs().max())
    nbytes, nops = _mega_cost(T * D, fsw.npad, B, fsw.w_a, fsw.w_p, fsw.w_s,
                              40)
    b_ms, b_by = _bound(nbytes, nops)
    print(f"kernel mega_pcg_fleet T={T} D={D} npad={fsw.npad} B={B} 40 "
          f"iters: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol 1e-7, "
          f"T={T8} vs the plain version) r err (at |v|) {r_err:.3e} (the "
          f"one-system launches' {r_single:.3e}); "
          f"kernel_ms={ms:.4f} plain_ms={pms:.4f} (T={T8}) bound_ms="
          f"{b_ms:.4f} ({b_by}); {T} one-system launches {sms:.4f} ms; "
          f"lanes vs single launches bitwise {lane_bits} (max rel "
          f"{lane_gap:.3e}); solve items of "
          f"{P['fsm'].pcg_fleet_cols(T, D, B)} columns", flush=True)
    if not (rel <= 1e-7 and r_err <= max(1e-7, r_single)
            and lane_gap <= 1e-12
            and bool((it == 40).all()) and bool((itp == 40).all())):
        raise RuntimeError(f"mega_pcg_fleet: {rel:.3e}, {r_err:.3e}, "
                           f"lanes {lane_gap:.3e}")
    rows.append(dict(name="mega_pcg_fleet", max_abs_err=err, max_rel_err=rel,
                     ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                     single_ms=sms))
    # one carried iteration
    seed = P["pcg_seed"](*pops, v, zero, warm=False, factors=fac, **kw)
    ms1, out = _event_ms(lambda: P["fused_pcg_iter"](*pops, *seed,
                                                     factors=fac, **kw),
                         reps=10)
    sms1, _ = _event_ms(lambda: [P["fused_pcg_iter"](
        *lane_ops[t], *(u[t] for u in seed), factors=lane_fac[t], **kw)
        for t in range(T)], reps=3)
    pms1, outp = _event_ms(lambda: P["fused_pcg_iter_plain"](
        *sl, *(u[:T8] for u in seed), **kw), reps=1, warmup=0)
    err1, rel1 = _errs(_flat(out[k][:T8] for k in (0, 2, 3)),
                       _flat(outp[k] for k in (0, 2, 3)))
    nb1, no1 = _pcg_iter_cost(T * D, fsw.npad, B, fsw.w_a, fsw.w_p,
                              fsw.w_s)
    b1, b1_by = _bound(nb1, no1)
    print(f"kernel fused_pcg_iter_fleet T={T}: max_rel_err={rel1:.3e} (tol "
          f"1e-10, T={T8}) kernel_ms={ms1:.4f} plain_ms={pms1:.4f} "
          f"bound_ms={b1:.4f} ({b1_by}); {T} one-system launches "
          f"{sms1:.4f} ms", flush=True)
    if not rel1 <= 1e-10:
        raise RuntimeError(f"fused_pcg_iter_fleet: {rel1:.3e}")
    rows.append(dict(name="fused_pcg_iter_fleet", max_abs_err=err1,
                     max_rel_err=rel1, ms=ms1, plain_ms=pms1, bound_ms=b1,
                     bound_by=b1_by, single_ms=sms1))
    del v, zero, x, r, outs, seed, out
    # MAXW = 4: q = 3 tenants on a jittered grid (the plain whole solve on
    # the first, its one iteration on the first two)
    T3, n3 = 4, 2000
    rj = np.random.default_rng(78)
    per = [_operands(P, _jittered(rj, n3, D, spacing=0.2)[0],
                     np.full(D, 4.0), 0.8 + 0.1 * t, 3, dev)
           for t in range(T3)]
    st3 = fs(*(torch.stack([getattr(f, k)[:, :n3] for f in per])
               for k in ("phi", "saphi")),
             *(torch.stack([getattr(f, k)[:, :n3] for f in per])
               for k in ("sort_idx", "rank_idx")),
             torch.stack([f.sigma2[0] for f in per]), w_p=3, w_s=4,
             a=torch.stack([f.a[:, :n3] for f in per]), w_a=4)
    v3 = st3.pad_state(torch.as_tensor(rj.standard_normal(
        (T3, D, n3, B)), device=dev))
    z3 = torch.zeros_like(v3)
    p3 = (st3.a, st3.phi, st3.saphi, st3.sort_idx, st3.rank_idx, st3.sigma2)
    k3 = dict(w_a=4, w_p=3, w_s=4)
    f3 = st3.cr_factors()
    ms3, (x3, r3, _) = _event_ms(lambda: P["mega_pcg_solve"](
        *p3, v3, z3, iters=80, factors=f3, **k3), reps=3)
    sms3, _ = _event_ms(lambda: [P["mega_pcg_solve"](
        *(o[t] for o in p3[:5]), p3[5][t:t + 1], v3[t], z3[t], iters=80,
        factors=tuple(P["fsm"]._lane_factor(f, t) for f in f3), **k3)
        for t in range(T3)], reps=1)
    pms3, (xp3, _, _) = _event_ms(lambda: P["mega_pcg_plain"](
        *(o[:1] for o in p3), v3[:1], z3[:1], iters=80, **k3), reps=1,
        warmup=0)
    err3, rel3 = _errs(x3[:1], xp3)
    b3, b3_by = _bound(*_mega_cost(T3 * D, st3.npad, B, 4, 3, 4, 80))
    print(f"kernel mega_pcg_fleet_w4 q3 T={T3} n={n3} B={B} 80 iters: "
          f"max_rel_err={rel3:.3e} (tol 1e-7, T=1) kernel_ms={ms3:.4f} "
          f"plain_ms={pms3:.4f} (T=1) bound_ms={b3:.4f} ({b3_by}); {T3} "
          f"one-system launches {sms3:.4f} ms", flush=True)
    if not rel3 <= 1e-7:
        raise RuntimeError(f"mega_pcg_fleet_w4: {rel3:.3e}")
    rows.append(dict(name="mega_pcg_fleet_w4", max_abs_err=err3,
                     max_rel_err=rel3, ms=ms3, plain_ms=pms3, bound_ms=b3,
                     bound_by=b3_by, single_ms=sms3))
    sd3 = P["pcg_seed"](*p3, v3, z3, warm=False, factors=f3, **k3)
    ms4, o4 = _event_ms(lambda: P["fused_pcg_iter"](*p3, *sd3, factors=f3,
                                                    **k3), reps=10)
    sms4, _ = _event_ms(lambda: [P["fused_pcg_iter"](
        *(o[t] for o in p3[:5]), p3[5][t:t + 1], *(u[t] for u in sd3),
        factors=tuple(P["fsm"]._lane_factor(f, t) for f in f3), **k3)
        for t in range(T3)], reps=3)
    pms4, op4 = _event_ms(lambda: P["fused_pcg_iter_plain"](
        *(o[:2] for o in p3), *(u[:2] for u in sd3), **k3), reps=1,
        warmup=0)
    err4, rel4 = _errs(_flat(o4[k][:2] for k in (0, 2, 3)),
                       _flat(op4[k] for k in (0, 2, 3)))
    b4, b4_by = _bound(*_pcg_iter_cost(T3 * D, st3.npad, B, 4, 3, 4))
    print(f"kernel fused_pcg_iter_fleet_w4 q3 T={T3}: max_rel_err="
          f"{rel4:.3e} (tol 1e-10, T=2) kernel_ms={ms4:.4f} plain_ms="
          f"{pms4:.4f} (T=2) "
          f"bound_ms={b4:.4f} ({b4_by}); {T3} one-system launches "
          f"{sms4:.4f} ms", flush=True)
    if not rel4 <= 1e-10:
        raise RuntimeError(f"fused_pcg_iter_fleet_w4: {rel4:.3e}")
    rows.append(dict(name="fused_pcg_iter_fleet_w4", max_abs_err=err4,
                     max_rel_err=rel4, ms=ms4, plain_ms=pms4, bound_ms=b4,
                     bound_by=b4_by, single_ms=sms4))
    for r_ in rows:
        r_.update(route="cuda", source=FLEET_KERNELS[r_["name"]][0],
                  replaces=FLEET_KERNELS[r_["name"]][1], library_ms=None)
    return rows


def fleet_phase(P, dev):
    """The fleet (``core.fleet``, the masked mutations, ``GPFleetEngine``):
    every op at T = 64 serving tenants beside the same work as 64
    standalone calls, the launches per op required equal at T = 8; the
    main path's shape at T = 4 (:func:`fleet_lanes`); the tenant-axis
    kernels' rows (:func:`fleet_kernel_rows`). Returns (rows, counts, the
    T = 64 tenants with their bounds, capacities, queries and the engine
    tick's host syncs)."""
    _build = P["_build"]
    total = dict.fromkeys(_build.KERNELS, 0)
    # T = 8 first: its launches and syncs, and the warm-up of every op
    rec8, _ = _fleet_ops(P, 8, dev, seed=900)
    rec64, s = _fleet_ops(P, FLEET_T, dev)
    # the tenants and the tick's syncs, for health_phase's fleet engine
    small = dict(gps=s["gps"], Xs=s["Xs"], bounds=s["bounds"],
                 caps=s["caps"], Xq=s["Xq"].cpu().numpy(),
                 tick_syncs=rec64["GPFleetEngine tick"]["syncs"])
    for r in (*rec8.values(), *rec64.values()):
        for k, v in r["launches"].items():
            total[k] += v
    solo = _standalone_ops(P, s)
    for op, r in rec64.items():
        o = solo[op]
        print(f"fleet T={FLEET_T} {op}: {r['ms']:.1f} ms, launches "
              f"{r['launches']}, host syncs {r['syncs']}, peak "
              f"{r['peak']:.1f} MiB | {o['calls']} standalone calls: "
              f"{o['ms']:.1f} ms, launches {o['launches']}, host syncs "
              f"{o['syncs']} | T=8: launches {rec8[op]['launches']}, syncs "
              f"{rec8[op]['syncs']}", flush=True)
        if (r["launches"] != rec8[op]["launches"]
                or r["syncs"] != rec8[op]["syncs"]):
            raise RuntimeError(f"fleet {op}: launches or syncs differ "
                               f"between T = 8 and T = {FLEET_T}")
    print(f"fleet launches and host syncs per op equal at T=8 and "
          f"T={FLEET_T}: True", flush=True)
    _stamp("fleet: serving ops at T = 64 and 8")
    rows = fleet_kernel_rows(P, dev, s)
    del s
    _stamp("fleet: tenant-axis kernel rows")
    lanes = fleet_lanes(P, dev)
    for k, v in lanes.items():
        total[k] += v
    _stamp("fleet: lanes at the main path's shape, q = 3, card vs cpu")
    return rows, total, small

# ---------------------------------------------------------------------------
# the fleet's other solvers: the relaxation kernels' tenant axis, fused="off"
# and kmg fleets (the default GPConfig())
# ---------------------------------------------------------------------------

FLEET_RELAX_KERNELS = {
    name + "_fleet" + w: RELAX_KERNELS[name]
    for name in ("fused_jacobi_iter", "mega_jacobi", "fused_gauss_seidel_iter",
                 "mega_gauss_seidel") for w in ("", "_w4")}
# the small fleets' configurations: the relaxation solvers' tenant-axis
# kernels ("whole" and "on") and pcg's unfused host loop
FLEET_SOLVER_CFGS = (("jacobi", "whole"), ("jacobi", "on"),
                     ("gauss_seidel", "whole"), ("gauss_seidel", "on"),
                     ("pcg", "off"))
# card vs CPU at T = 4, n = 500: the relaxation solvers in both fused modes,
# pcg "off" and kmg (its CPU side in a worker, section "fleet"). The two
# CG solves run 200 iterations: at 40-50 they stop unconverged on this
# grid, where the card's and the CPU's rounding part by up to 1e-6 in one
# GP's mean on the H100 (PERF.md), as at q = 3 in section 3
FLEET_CHECK_CFGS = FLEET_SOLVER_CFGS + (("pcg", "kmg"),)
CHECK_CG_ITERS = 200


def _fleet_cfg(P, solver, fused, cg_iters=40):
    if fused == "kmg":
        return P["GPConfig"](q=0, precond="kmg", solver_iters=cg_iters)
    return P["GPConfig"](q=0, solver=solver, precond="none", fused=fused,
                         solver_iters=cg_iters if solver == "pcg" else 40)


def _fleet_check_data():
    """T = 4 jittered grids at n = 500 (capacity 512), 32 queries each."""
    rj = np.random.default_rng(604)
    n, D = 500, D_PATH
    X = np.stack([_jittered(rj, n, D)[0] for _ in range(4)])
    span = 0.1 * n / 4.0
    Y = np.sin(X * 6.0 * np.pi / span).sum(-1) \
        + 0.1 * rj.standard_normal((4, n))
    return X, Y, rj.uniform(0.0, span, (4, B_PATH, D))


def _fleet_solvers_cpu(P):
    """The CPU side of the fleet solvers' card-vs-CPU check (a worker's):
    the plain fleet's mean and variance per configuration."""
    fl = P["fleet"]
    X, Y, Xq = _fleet_check_data()
    out = {}
    for solver, fused in FLEET_CHECK_CFGS:
        f = fl.fleet_fit(_fleet_cfg(P, solver, fused, CHECK_CG_ITERS), X, Y,
                         np.full(D_PATH, 4.0), 1.0, 512, device="cpu")
        out[solver, fused] = (
            fl.fleet_posterior_mean(f, Xq, device="cpu").numpy(),
            fl.fleet_posterior_var(f, Xq, device="cpu").numpy())
    return out


def _op_line(tag, op, r, solo, calls, extra=""):
    print(f"{tag} {op}: {r['ms']:.1f} ms, launches {r['launches']}, host "
          f"syncs {r['syncs']}, peak {r['peak']:.1f} MiB | {calls} "
          f"standalone calls: {solo['ms']:.1f} ms, launches "
          f"{solo['launches']}, host syncs {solo['syncs']}, peak "
          f"{solo['peak']:.1f} MiB{extra}", flush=True)


@contextlib.contextmanager
def _batched_products(T):
    """A single GP's V-cycle products (``precond.coarse.tenant_mm``: the
    deflation's D x D by D x B) made as one batched GEMM of T copies, as a
    T-tenant fleet's lane makes them. cuBLAS rounds a one-column 2-D
    product (a GEMV) otherwise than the batched kernel; at two columns and
    more the two agree bit for bit (``scripts/batched_mm_bits.py``)."""
    import repro_torch.precond.coarse as pc
    import repro_torch.precond.vcycle as pv

    old = pc.tenant_mm

    def mm(a, b):
        if a.ndim != 2 or not a.is_cuda:
            return old(a, b)
        return (a.expand((T,) + a.shape).contiguous()
                @ b.expand((T,) + b.shape).contiguous())[0]

    pc.tenant_mm = pv.tenant_mm = mm
    try:
        yield
    finally:
        pc.tenant_mm = pv.tenant_mm = old


def fleet_default_path(P, dev, total):
    """``fleet_fit(GPConfig())`` at the main path's width: T = 4 Schwefel
    tenants at n = 30000 (capacity 32768, D = 10, q = 0, omega 8/span, the
    data of :func:`fleet_lanes`), which resolves to kmg, unfused; then
    ``fleet_posterior_mean(100)``, ``fleet_posterior_var(32)`` and one
    masked ``fleet_insert`` and ``fleet_evict`` on lanes 0 and 2; each op
    timed beside the 4 standalone default calls it replaces (after one
    fleet fit at n = 5000 that warms the fleet's library calls). Each lane
    against its standalone GP: the queries (after the mutations too)
    within 1e-7; the fit caches bit for bit (1e-12) against the standalone
    GP made with the fleet's batched V-cycle products (the twin,
    :func:`_batched_products`), and after the mutations its mean cache
    within 1e-7 of the twin's (5.2e-9 on the H100, PERF.md: another
    batched call of the insert's path rounds by batch), each gap to the
    plain standalone GP printed: the kmg solve stops after 50 iterations
    unconverged, and a one-ulp change of a deflation product moves its
    caches by up to ~2e-7 (PERF.md) while the queries stay
    within 1e-9."""
    fl, st = P["fleet"], P["stream"]
    T, n, cap, D, B = 4, N_PATH, STREAM_CAP, D_PATH, B_PATH
    cfg = P["GPConfig"]()
    Xs, Ys, _, bounds = _fleet_data(P, T, [n] * T, D, 600)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    nw = min(5000, n)
    fl.fleet_fit(cfg, np.stack([x[:nw] for x in Xs]),
                 np.stack([y[:nw] for y in Ys]), omega, 1.0, nw)
    rq = np.random.default_rng(601)
    Xq = torch.as_tensor(rq.uniform(bounds[:, 0], bounds[:, 1], (T, 100, D)),
                         device=dev)
    rs = np.random.default_rng(603)
    xn = rs.uniform(bounds[:, 0], bounds[:, 1], (T, D))
    yn = rs.standard_normal(T)
    do = np.array([True, False, True, False])
    counts = np.full(T, n)
    sel = [t for t in range(T) if do[t]]
    rec, solo = {}, {}
    fleet, rec["fleet_fit"] = _op(P, lambda: fl.fleet_fit(
        cfg, np.stack(Xs), np.stack(Ys), omega, 1.0, cap))
    mu, rec["mean(100)"] = _op(P, lambda: fl.fleet_posterior_mean(fleet, Xq))
    var, rec[f"var({B})"] = _op(P, lambda: fl.fleet_posterior_var(
        fleet, Xq[:, :B]))
    grown, rec["fleet_insert"] = _op(P, lambda: st.fleet_insert(
        fleet, xn, yn, do, counts=counts))
    shrunk, rec["fleet_evict"] = _op(P, lambda: st.fleet_evict(
        grown, do, counts=counts + do))
    del grown
    for r in rec.values():
        for k, v in r["launches"].items():
            total[k] += v
    gps, solo["fleet_fit"] = _op(P, lambda: [P["fit"](
        cfg, Xs[t], Ys[t], omega, 1.0, capacity=cap) for t in range(T)])
    mus, solo["mean(100)"] = _op(P, lambda: [P["posterior_mean"](
        g, Xq[t]) for t, g in enumerate(gps)])
    vars_, solo[f"var({B})"] = _op(P, lambda: [P["posterior_var"](
        g, Xq[t, :B]) for t, g in enumerate(gps)])
    gi, solo["fleet_insert"] = _op(P, lambda: [st.insert(
        gps[t], xn[t], yn[t], count=n) for t in sel])
    ge, solo["fleet_evict"] = _op(P, lambda: [st.evict(
        g, count=n + 1) for g in gi])
    del gi
    with _batched_products(T):
        twins = [P["fit"](cfg, Xs[t], Ys[t], omega, 1.0, capacity=cap)
                 for t in range(T)]
        twins_e = {t: st.evict(st.insert(twins[t], xn[t], yn[t], count=n),
                               count=n + 1) for t in sel}
    print(f"fleet default path GPConfig() T={T} n={n} (capacity {cap}) "
          f"D={D}: precond {fleet.config.precond}, fused "
          f"{fleet.config.fused}, iterations {fleet.config.solver_iters}, "
          f"levels {[lv.stride for lv in fleet.gp.hier]}, restriction "
          f"widths {[lv.r_idx.shape[-1] for lv in fleet.gp.hier]}",
          flush=True)
    for op, r in rec.items():
        _op_line(f"fleet default T={T}", op, r, solo[op],
                 len(sel) if op in ("fleet_insert", "fleet_evict") else T)
    gaps, bits = {}, {}

    def lane(key, a, b):
        gaps[key] = max(gaps.get(key, 0.0), _lane_gap(a, b))
        bits[key] = bits.get(key, True) and torch.equal(a, b)

    after = dict(zip(sel, ge))
    mu_s = fl.fleet_posterior_mean(shrunk, Xq)
    for t in range(T):
        g, w, f = gps[t], twins[t], fleet.tenant(t)
        for a, b, c in ((f.u_sy, g.u_sy, w.u_sy), (f.bY, g.bY, w.bY),
                        (f.Gband.data, g.Gband.data, w.Gband.data)):
            lane("fit caches vs the twin", a, c)
            lane("fit caches vs plain", a, b)
        lane("mean", mu[t], mus[t])
        lane("var", var[t], vars_[t])
        h, s = after.get(t, g), shrunk.tenant(t)
        lane("mutated mean cache vs the twin", s.u_sy,
             twins_e.get(t, w).u_sy)
        lane("mutated mean cache vs plain", s.u_sy, h.u_sy)
        lane("mutated mean", mu_s[t], P["posterior_mean"](h, Xq[t]))
    print(f"fleet default lanes vs their standalone card GPs (the twin: made "
          f"with the fleet's batched V-cycle products), max rel: "
          + ", ".join(f"{k} {v:.3e} (bitwise {bits[k]})"
                      for k, v in gaps.items())
          + " (bars: fit caches vs the twin 1e-12, mutated mean cache vs the "
          "twin 1e-7, the queries 1e-7; vs plain printed)",
          flush=True)
    bars = {"fit caches vs the twin": 1e-12, "mean": 1e-7, "var": 1e-7,
            "mutated mean cache vs the twin": 1e-7, "mutated mean": 1e-7}
    if not (fleet.config.precond == "kmg" and fleet.config.fused == "off"
            and all(gaps[k] <= b for k, b in bars.items())
            and bool(torch.isfinite(var).all()) and bool((var > 0).all())
            and list(shrunk.counts()) == [n] * T):
        raise RuntimeError(f"fleet default path: {fleet.config.precond}, "
                           f"{fleet.config.fused}, gaps {gaps}")


def _solver_ops(P, T, dev, cfg, seed):
    """The small fleet's ops at T tenants (1500..2000 points in capacity
    2048): ``fleet_fit`` at n = 1500, then on the stack of the tenants' own
    fits ``fleet_posterior_var(32)`` and a masked ``fleet_insert`` and
    ``fleet_evict`` (even lanes). ``({op: record}, state)``."""
    fl, st = P["fleet"], P["stream"]
    D = D_PATH
    counts = np.linspace(1500, 2000, T).astype(int)
    Xs, Ys, Xq, bounds = _fleet_data(P, T, counts, D, seed)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    X0 = np.stack([x[:1500] for x in Xs])
    Y0 = np.stack([y[:1500] for y in Ys])
    rec = {}
    _, rec["fleet_fit"] = _op(P, lambda: fl.fleet_fit(
        cfg, X0, Y0, omega, 1.0, FLEET_CAP))
    gps = [P["fit"](cfg, x, y, omega, 1.0, capacity=FLEET_CAP)
           for x, y in zip(Xs, Ys)]
    fleet = fl.stack_gps(gps)
    Xqt = torch.as_tensor(Xq, device=dev)
    _, rec["fleet_posterior_var"] = _op(
        P, lambda: fl.fleet_posterior_var(fleet, Xqt))
    rs = np.random.default_rng(seed + 2000)
    xn = rs.uniform(bounds[:, 0], bounds[:, 1], (T, D))
    yn = rs.standard_normal(T)
    do = np.arange(T) % 2 == 0
    grown, rec["fleet_insert"] = _op(P, lambda: st.fleet_insert(
        fleet, xn, yn, do, counts=counts))
    _, rec["fleet_evict"] = _op(P, lambda: st.fleet_evict(
        grown, do, counts=counts + do))
    return rec, dict(gps=gps, fleet=fleet, X0=X0, Y0=Y0, Xq=Xqt, xn=xn,
                     yn=yn, do=do, counts=counts, omega=omega)


def _solver_standalone(P, s, cfg):
    """The same work as :func:`_solver_ops` as standalone single-GP calls."""
    st, gps = P["stream"], s["gps"]
    sel = [t for t in range(len(gps)) if s["do"][t]]
    rec = {}
    _, rec["fleet_fit"] = _op(P, lambda: [
        P["fit"](cfg, x, y, s["omega"], 1.0, capacity=FLEET_CAP)
        for x, y in zip(s["X0"], s["Y0"])])
    _, rec["fleet_posterior_var"] = _op(P, lambda: [
        P["posterior_var"](g, s["Xq"][t]) for t, g in enumerate(gps)])
    grown, rec["fleet_insert"] = _op(P, lambda: [
        st.insert(gps[t], s["xn"][t], s["yn"][t], count=int(s["counts"][t]))
        for t in sel])
    _, rec["fleet_evict"] = _op(P, lambda: [
        st.evict(g, count=int(s["counts"][t]) + 1)
        for g, t in zip(grown, sel)])
    return rec, len(sel)


def fleet_small_solvers(P, dev, total):
    """Each of ``FLEET_SOLVER_CFGS`` on the small fleets: every op at T = 8
    and T = 64 (launches and host syncs required equal), beside 64
    standalone calls. Returns the T = 64 Jacobi "whole" fleet, whose
    operands the kernel rows take."""
    keep = None
    for solver, fused in FLEET_SOLVER_CFGS:
        cfg = _fleet_cfg(P, solver, fused)
        rec8, _ = _solver_ops(P, 8, dev, cfg, seed=910)
        rec64, s = _solver_ops(P, FLEET_T, dev, cfg, seed=510)
        for r in (*rec8.values(), *rec64.values()):
            for k, v in r["launches"].items():
                total[k] += v
        solo, nsel = _solver_standalone(P, s, cfg)
        for op, r in rec64.items():
            _op_line(f"fleet {solver} fused={fused} T={FLEET_T}", op, r,
                     solo[op], nsel if op in ("fleet_insert", "fleet_evict")
                     else FLEET_T,
                     f" | T=8: launches {rec8[op]['launches']}, syncs "
                     f"{rec8[op]['syncs']}")
            if (r["launches"] != rec8[op]["launches"]
                    or r["syncs"] != rec8[op]["syncs"]):
                raise RuntimeError(f"fleet {solver} {fused} {op}: launches "
                                   "or syncs differ between T = 8 and "
                                   f"T = {FLEET_T}")
        if (solver, fused) == ("jacobi", "whole"):
            keep = s["fleet"]
        del s
    print(f"fleet solvers: launches and host syncs per op equal at T=8 and "
          f"T={FLEET_T}: True", flush=True)
    return keep


def _relax_fleet_rows(P, fsw, tag, its, n_plain, rng, dev, rows=None):
    """The four relaxation kernels over the tenant stack ``fsw`` (B = 32):
    the fleet launch's event time, the T one-system launches it replaces,
    each lane bit for bit against its one-system launch, the plain version
    (tenant by tenant) on the first ``n_plain`` tenants within
    max(1e-12, kappa eps) (the single rows' bar, kappa the largest
    condition number of the stack's SAPhi systems), the bound. Appends the
    rows to ``rows`` when given (the kernels line's numbers)."""
    fsm = P["fsm"]
    T, D, B = fsw.lead[0], fsw.D, B_PATH
    eps = float(torch.finfo(torch.float64).eps)
    flat = P["FusedSweep"](fsw.phi.reshape(T * D, fsw.npad, -1),
                           fsw.saphi.reshape(T * D, fsw.npad, -1),
                           fsw.sort_idx.reshape(T * D, -1),
                           fsw.rank_idx.reshape(T * D, -1), 1.0,
                           w_p=fsw.w_p, w_s=fsw.w_s)
    kappa = _cond_est(P, flat, flat.saphi, fsw.w_s)
    tol = max(1e-12, kappa * eps)
    ops = (fsw.phi, fsw.saphi, fsw.sort_idx, fsw.rank_idx, fsw.sigma2)
    v = fsw.pad_state(torch.as_tensor(rng.standard_normal(
        (T, D, fsw.n, B)), device=dev))
    x0 = 0.1 * v
    k = 0.05 * v
    kw = dict(w_p=fsw.w_p, w_s=fsw.w_s)
    al = 1.0 / D
    jfac, gfac = fsw.cr_factors(), fsw.saphi_factor()
    lane_ops = [tuple(o[t] for o in ops[:4]) + (ops[4][t:t + 1],)
                for t in range(T)]

    def lane_fac(f, t):
        if isinstance(f, tuple):
            return tuple(None if x is None else fsm._lane_factor(x, t)
                         for x in f)
        return fsm._lane_factor(f, t)

    shape = (T * D, fsw.npad, B, fsw.w_p, fsw.w_s)
    cases = {
        "fused_jacobi_iter": (
            lambda o, s, f: P["fused_jacobi_iter"](
                *o, v[s], x0[s], k[s], alpha=al, factors=f, **kw),
            lambda o, s: P["fused_jacobi_iter_plain"](
                *o, v[s], x0[s], k[s], alpha=al, **kw), jfac,
            _sweep_cost(*shape, 1, 5, JACOBI_SWEPT,
                        JACOBI_ELEM + JACOBI_K_ELEM), 10),
        "fused_gauss_seidel_iter": (
            lambda o, s, f: P["fused_gauss_seidel_iter"](
                *o, v[s], x0[s], want_resid=True, factors=f, **kw),
            lambda o, s: P["fused_gauss_seidel_iter_plain"](
                *o, v[s], x0[s], want_resid=True, **kw), gfac,
            _sweep_cost(*shape, 1, GS_STATES, GS_SWEPT, GS_ELEM,
                        GS_K_FINAL), 3),
        "mega_jacobi": (
            lambda o, s, f: P["mega_jacobi_solve"](
                *o, v[s], x0[s], alpha=al, iters=its, warm=True, factors=f,
                **kw),
            lambda o, s: P["mega_jacobi_plain"](
                *o, v[s], x0[s], alpha=al, iters=its, warm=True, **kw), jfac,
            _sweep_cost(*shape, its, 4, JACOBI_SWEPT,
                        JACOBI_ELEM + JACOBI_K_ELEM, warm=True), 3),
        "mega_gauss_seidel": (
            lambda o, s, f: P["mega_gauss_seidel_solve"](
                *o, v[s], x0[s], iters=its, factors=f, **kw),
            lambda o, s: P["mega_gauss_seidel_plain"](
                *o, v[s], x0[s], iters=its, **kw), gfac,
            _sweep_cost(*shape, its, GS_STATES, GS_SWEPT, GS_ELEM,
                        GS_K_FINAL), 1),
    }
    every = slice(None)
    part = slice(0, n_plain)
    for name, (kern, plain, fac, cost, reps) in cases.items():
        ms, out = _event_ms(lambda: kern(ops, every, fac), reps=reps)
        sms, outs = _event_ms(lambda: [kern(lane_ops[t], t, lane_fac(fac, t))
                                       for t in range(T)], reps=1)
        out = out if isinstance(out, tuple) else (out,)
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        bits = all(torch.equal(a[t], b) for t in range(T)
                   for a, b in zip(out, outs[t]))
        pms, outp = _event_ms(lambda: plain(tuple(
            o[part] for o in ops), part), reps=1, warmup=0)
        outp = outp if isinstance(outp, tuple) else (outp,)
        err, rel = _errs(torch.cat([o[part].flatten() for o in out]),
                         torch.cat([o.flatten() for o in outp]))
        b_ms, b_by = _bound(*cost)
        counted = name + "_fleet" + ("_w4" if max(fsw.w_p, fsw.w_s) > 3
                                     else "")
        print(f"kernel {counted} {tag} T={T} D={D} npad={fsw.npad} B={B}"
              f"{'' if name.startswith('fused') else f' {its} sweeps'}: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol {tol:.1e}, "
              f"T={n_plain} vs the plain version) kernel_ms={ms:.4f} "
              f"plain_ms={pms:.4f} (T={n_plain}) bound_ms={b_ms:.4f} "
              f"({b_by}); {T} one-system launches {sms:.4f} ms; lanes vs "
              f"single launches bitwise {bits}", flush=True)
        if not (rel <= tol and bits):
            raise RuntimeError(f"{counted} {tag}: error {rel:.3e} > "
                               f"{tol:.1e}, or lanes not bitwise {bits}")
        if rows is not None:
            rows.append(dict(name=counted, route="cuda",
                             source=FLEET_RELAX_KERNELS[counted][0],
                             replaces=FLEET_RELAX_KERNELS[counted][1],
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None, single_ms=sms))
    print(f"relaxation fleet rows {tag}: cond(SAPhi) <= {kappa:.3e}; solve "
          f"items: jacobi {P['fsm'].jacobi_fleet_cols(T, D, B)} columns, "
          f"gauss_seidel {P['fsm'].gauss_seidel_fleet_cols(T, B)} columns",
          flush=True)


def _q3_fleet_stack(P, dev, T=4, n=2000, seed=78):
    """T q = 3 systems on jittered grids (spacing 0.2 / omega), as the
    padded tenant stack of the backfitting kernels."""
    rj = np.random.default_rng(seed)
    per = [_operands(P, _jittered(rj, n, D_PATH, spacing=0.2)[0],
                     np.full(D_PATH, 4.0), 0.8 + 0.1 * t, 3, dev)
           for t in range(T)]
    return P["FusedSweep"](
        *(torch.stack([getattr(f, k)[:, :n] for f in per])
          for k in ("phi", "saphi")),
        *(torch.stack([getattr(f, k)[:, :n] for f in per])
          for k in ("sort_idx", "rank_idx")),
        torch.stack([f.sigma2[0] for f in per]), w_p=3, w_s=4)


def fleet_solvers_phase(P, dev, refs):
    """The fleet's other solvers: ``fleet_fit(GPConfig())`` at the main
    path's width (:func:`fleet_default_path`); the small fleets per solver
    (:func:`fleet_small_solvers`); q = 3 fleets of the relaxation solvers
    (the "_w4" kernels); the four tenant-axis relaxation kernels' rows at
    T = 64, npad = 2048, at T = 4, n = 30000 and at q = 3 (T = 4,
    n = 2000); the card against the plain CPU fleet at T = 4, n = 500
    (Jacobi, Gauss-Seidel, "off", kmg). Returns (rows, counts)."""
    t0 = time.perf_counter()
    _build, fl = P["_build"], P["fleet"]
    total = dict.fromkeys(_build.KERNELS, 0)
    fleet_default_path(P, dev, total)
    _stamp("fleet solvers: the default path GPConfig() at T = 4, n = 30000")
    small = fleet_small_solvers(P, dev, total)
    _stamp("fleet solvers: small fleets at T = 64 and 8")
    # q = 3 fleets (the half-width-4 instantiations): fit and var(32)
    rj = np.random.default_rng(605)
    n3, D, T3 = 2000, D_PATH, 4
    X3 = np.stack([_jittered(rj, n3, D, spacing=0.2)[0] for _ in range(T3)])
    span3 = 0.2 * n3 / 4.0
    Y3 = np.sin(X3 * 6.0 * np.pi / span3).sum(-1) \
        + 0.1 * rj.standard_normal((T3, n3))
    Xq3 = torch.as_tensor(rj.uniform(0.0, span3, (T3, B_PATH, D)),
                          device=dev)
    out3 = {}
    for solver in ("jacobi", "gauss_seidel"):
        for fused in ("whole", "on"):
            _build.reset_launch_counts()
            f3 = fl.fleet_fit(P["GPConfig"](q=3, solver=solver, fused=fused,
                                            precond="none", solver_iters=40),
                              X3, Y3, np.full(D, 4.0), 1.0, n3)
            out3[solver, fused] = (f3.gp.u_sy, fl.fleet_posterior_var(
                f3, Xq3))
            for k, v in _build.launch_counts().items():
                total[k] += v
        same = all(torch.equal(a, b) for a, b in zip(out3[solver, "whole"],
                                                     out3[solver, "on"]))
        print(f"fleet q=3 {solver} T={T3} n={n3}: on == whole (caches, var) "
              f"bitwise {same}; var finite "
              f"{bool(torch.isfinite(out3[solver, 'whole'][1]).all())}",
              flush=True)
        if not (same and bool(torch.isfinite(out3[solver, "whole"][1])
                              .all())):
            raise RuntimeError(f"q = 3 {solver} fleet")
    del out3
    # the kernel rows (their launches are not the paths' and do not count)
    rows = []
    ops = small.gp.ops
    fsw = P["FusedSweep"](ops.Phi.data, ops.SAPhi.data, ops.sort_idx,
                          ops.rank_idx, ops.sigma2, w_p=ops.Phi.lo,
                          w_s=ops.SAPhi.lo, n_active=ops.n_active,
                          factors=(ops.phi_factor, ops.saphi_factor))
    rng = np.random.default_rng(79)
    _relax_fleet_rows(P, fsw, "serving fleet", 10, 1, rng, dev, rows)
    del fsw, small
    big = _operands_stack(P, dev)
    _relax_fleet_rows(P, big, "main path's shape", 10, 1, rng, dev)
    del big
    _relax_fleet_rows(P, _q3_fleet_stack(P, dev), "q3", 10, 1, rng, dev,
                      rows)
    _stamp("fleet solvers: tenant-axis relaxation kernel rows")
    # the card against the plain CPU fleet (its side from a worker)
    X, Y, Xq = _fleet_check_data()
    r = refs("fleet")
    for solver, fused in FLEET_CHECK_CFGS:
        f = fl.fleet_fit(_fleet_cfg(P, solver, fused, CHECK_CG_ITERS), X, Y,
                         np.full(D, 4.0), 1.0, 512)
        for name, fn, want in (("mean", fl.fleet_posterior_mean,
                                r[solver, fused][0]),
                               ("var", fl.fleet_posterior_var,
                                r[solver, fused][1])):
            _check(f"fleet {solver} {fused} T=4 n=500 D={D} {name}",
                   fn(f, Xq), torch.as_tensor(want))
    print(f"fleet solvers phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    _stamp("fleet solvers: card vs cpu")
    return rows, total


def _operands_stack(P, dev, T=4, seed=600):
    """The T = 4 main-path tenants' (n = 30000) operands as one padded
    tenant stack (no capacity)."""
    Xs, _, _, bounds = _fleet_data(P, T, [N_PATH] * T, D_PATH, seed)
    omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
    per = [_operands(P, x, omega, 1.0, 0, dev) for x in Xs]
    return P["FusedSweep"](
        *(torch.stack([getattr(f, k)[:, :N_PATH] for f in per])
          for k in ("phi", "saphi", "sort_idx", "rank_idx")),
        torch.stack([f.sigma2[0] for f in per]), w_p=0, w_s=1)


# ---------------------------------------------------------------------------
# the health ladder: injected faults repaired on the card, the engines'
# repair and quarantine, a checkpoint round trip
# ---------------------------------------------------------------------------

# the kernels the phase's repairs (the ladder's re-solves, resyncs and
# refits) must launch
HEALTH_KERNELS = ("mega_pcg", "cr_factor", "cr_apply", "banded_lu",
                  "banded_matvec", "rgf_blocks", "band_matmul")
# every rung that applies to a pcg "whole" GP on the card, in order
PCG_WHOLE_RUNGS = ["warm_to_cold", "unfused", "gband_resync", "refit_clean"]


@contextlib.contextmanager
def _timed_rungs(P, times):
    """Record each ladder rung's wall ms (ending in a synchronise) in
    ``times`` as (rung, ms), by wrapping ``health.ladder._apply`` for the
    duration."""
    ladder = P["ladder"]
    apply = ladder._apply

    def timed(rung, gp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(rung, gp)
        torch.cuda.synchronize()
        times.append((rung, (time.perf_counter() - t0) * 1e3))
        return out

    ladder._apply = timed
    try:
        yield
    finally:
        ladder._apply = apply


def _queries(P, gp, Xq, m_var):
    return (P["posterior_mean"](gp, Xq), P["posterior_var"](gp, Xq[:m_var]))


def _repair_case(P, tag, bad, want_verdicts, want_rungs, total):
    """Repair ``bad`` on the card; check the detection verdict and the
    trail; add the repair's launches to ``total``. Returns the GP."""
    _build, ladder = P["_build"], P["ladder"]
    verdict = ladder.probe_gp(bad)
    times = []
    _build.reset_launch_counts()
    with _timed_rungs(P, times):
        (fixed, events), t = _sync_time(lambda: ladder.repair(bad, op=tag))
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    for k, v in counts.items():
        total[k] += v
    rungs = [e.rung for e in events]
    print(f"health {tag}: detected {P['verdict_name'](verdict)}; trail "
          + "; ".join(f"{e} {ms:.1f} ms" for e, (_, ms) in zip(events, times))
          + f"; repair {t * 1e3:.1f} ms; launches {counts}", flush=True)
    if not (P["verdict_name"](verdict) in want_verdicts and rungs == want_rungs
            and events[-1].fixed and ladder.probe_gp(fixed) == 0
            and fixed.config == bad.config):
        raise RuntimeError(f"health {tag}: detected "
                           f"{P['verdict_name'](verdict)}, trail {rungs}; "
                           f"expected {want_verdicts}, {want_rungs}")
    return fixed


def _same_queries(tag, got, want, tol=1e-10):
    gaps = [_errs(a, b)[1] for a, b in zip(got, want)]
    bits = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"health {tag}: mean / var max rel {gaps[0]:.3e} / {gaps[1]:.3e} "
          f"(tol {tol:.0e}), bit for bit {bits}", flush=True)
    if not max(gaps) <= tol:
        raise RuntimeError(f"health {tag}: repaired queries off by {gaps}")


def health_phase(P, dev, gp, X, Y, omega, sigma, Xq, bounds, small):
    """The health ladder at the main path's width (Schwefel n = 30000,
    D = 10, q = 0, health on), on the pcg "whole" GP ``gp`` (40
    iterations) and on a default ``GPConfig()`` GP (kmg, unfused):
    ``iteration_cap(iters=1)`` (both, STALLED, repaired by warm_to_cold,
    mean(100) and var(100) within 1e-10 of the healthy GP);
    ``corrupt_hierarchy`` (kmg: warm_to_cold then precond_off, the next
    preconditioned solve OK); ``nan_active_row`` (pcg: NONFINITE, through
    every rung to refit_clean, within 1e-10 of a clean card fit of the
    surviving rows at the same capacity); ``near_singular_band`` (pcg:
    every rung that applies, to refit_clean; each rung re-solves on the
    card). Each rung's wall ms, the repairs' launches
    by kernel (``HEALTH_KERNELS`` required). ``GPServeEngine`` on the pcg
    GP: a NaN insert repaired at the fence, a poisoned posterior's query
    held and served after the repair. ``GPFleetEngine`` over ``small``
    (fleet_phase's T = 64 tenants) with one poisoned lane: one quarantine,
    the 63 other lanes' tensors, counts and versions as before; a healthy
    tick's host syncs equal fleet_phase's, a healthy mutation round's
    counted. A checkpoint round trip of the kmg GP (mean(100) and var(32)
    bit for bit), save and restore timed. Returns the repairs' counts."""
    t_phase = time.perf_counter()
    h, st, _build = P["health"], P["stream"], P["_build"]
    total = dict.fromkeys(_build.KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    Xq_t = torch.as_tensor(Xq, device=dev)
    kmg = P["fit"](P["GPConfig"](), X, Y, omega, sigma)
    if (kmg.config.precond, kmg.config.fused, gp.config.fused) != (
            "kmg", "off", "whole"):
        raise RuntimeError("health: the two GPs' configs are not kmg/off and "
                           "pcg whole")
    healthy = {"pcg": _queries(P, gp, Xq_t, 100),
               "kmg": _queries(P, kmg, Xq_t, 100)}
    # iteration_cap: warm_to_cold on both GPs
    for tag, g in (("pcg", gp), ("kmg", kmg)):
        fixed = _repair_case(P, f"iteration_cap(1) {tag}",
                             h.iteration_cap(g, iters=1), ("STALLED",),
                             ["warm_to_cold"], total)
        _same_queries(f"iteration_cap {tag} vs healthy",
                      _queries(P, fixed, Xq_t, 100), healthy[tag])
        del fixed
    # corrupt_hierarchy (kmg): warm_to_cold, then precond_off
    bad = h.iteration_cap(h.corrupt_hierarchy(kmg),
                          iters=kmg.config.solver_iters)
    fixed = _repair_case(P, "corrupt_hierarchy kmg", bad, ("STALLED",),
                         ["warm_to_cold", "precond_off"], total)
    again = P["verdict_name"](h.iteration_cap(
        fixed, iters=kmg.config.solver_iters).health.verdict)
    print(f"health corrupt_hierarchy kmg: the next preconditioned solve "
          f"{again}", flush=True)
    if again != "OK":
        raise RuntimeError("health: the rebuilt hierarchy's solve is not OK")
    del bad, fixed
    # nan_active_row (pcg): every rung, then a clean refit
    row = 3
    fixed = _repair_case(P, "nan_active_row pcg", h.nan_active_row(gp,
                                                                   row=row),
                         ("NONFINITE",), PCG_WHOLE_RUNGS, total)
    keep = np.arange(len(Y)) != row
    clean = P["fit"](gp.config, X[keep], Y[keep], omega, sigma,
                     capacity=gp.n)
    if fixed.num_points() != len(Y) - 1 or fixed.n != gp.n:
        raise RuntimeError("health: refit_clean kept the NaN row")
    _same_queries("nan_active_row pcg vs a clean card fit",
                  _queries(P, fixed, Xq_t, 100), _queries(P, clean, Xq_t,
                                                         100))
    del fixed, clean
    # near_singular_band (pcg): every rung that applies
    fixed = _repair_case(
        P, "near_singular_band pcg",
        h.iteration_cap(h.near_singular_band(gp, row=1, dim=0),
                        iters=gp.config.solver_iters),
        ("STALLED", "DIVERGED", "NONFINITE"), PCG_WHOLE_RUNGS, total)
    _same_queries("near_singular_band pcg vs healthy",
                  _queries(P, fixed, Xq_t, 100), healthy["pcg"])
    del fixed, healthy
    _require_launched("health repairs", total, HEALTH_KERNELS)
    _stamp("health: injected faults at n = 30000")

    # the serving engine on the pcg GP
    _build.reset_launch_counts()
    eng = st.GPServeEngine(gp, bounds, batch_slots=8)
    eng.insert(X[0] * 0.999, float("nan"))
    q = eng.submit(Xq[0], "mean")
    _, t_fence = _sync_time(eng.run_until_done)
    # the drift sentinel's resync (op "sentinel") may come first: at this n
    # the windowed band's truncation estimate crosses DRIFT_TOL (ROADMAP
    # Queue 3 item 7)
    fence = [e.rung for e in eng.health_stats()["events"]
             if e.op == "mutation"]
    sentinel = [e.rung for e in eng.health_stats()["events"]
                if e.op == "sentinel"]
    eng.set_posterior(h.nan_active_row(eng.gp, row=row))
    q_bad = eng.submit(X[row], "mean")
    q_ok = eng.submit(Xq[1], "var")
    _, t_query = _sync_time(eng.run_until_done)
    stats = eng.health_stats()
    query = [e.rung for e in stats["events"] if e.op == "query"]
    for k, v in _build.launch_counts().items():
        total[k] += v
    print(f"health engine: NaN insert repaired at the fence in "
          f"{t_fence * 1e3:.1f} ms (sentinel {sentinel}, trail {fence}); "
          f"query quarantine {t_query * 1e3:.1f} ms (trail {query}); "
          f"repairs {stats['repairs']}; points {eng.num_points}; version "
          f"{eng.version}", flush=True)
    if not (fence == query == PCG_WHOLE_RUNGS and stats["repairs"] == 2
            and eng.num_points == len(Y) - 1
            and all(x.done and np.isfinite(x.result["mean"])
                    and np.isfinite(x.result["var"]) for x in (q, q_bad,
                                                               q_ok))):
        raise RuntimeError("health: the engine's repairs")
    del eng

    # the fleet engine on fleet_phase's T = 64 tenants, one lane poisoned
    gps = list(small["gps"])
    poisoned = 5
    gps[poisoned] = h.nan_active_row(gps[poisoned], row=row)
    fe = st.GPFleetEngine(gps, small["bounds"], batch_slots=8,
                          capacity=small["caps"],
                          insert_iters=gps[0].config.solver_iters)
    before = {t: [x.clone() for x in P["flatten"](fe.tenant_gp(t))[0]]
              for t in range(len(gps)) if t != poisoned}
    for t in range(len(gps)):  # each at its own row ``row``'s point
        fe.submit(t, small["Xs"][t][row], kind="mean")
    _build.reset_launch_counts()
    done, t_q = _sync_time(fe.run_until_done)
    for k, v in _build.launch_counts().items():
        total[k] += v
    stats = fe.health_stats()
    others = all(all(torch.equal(a, b) for a, b in zip(
        P["flatten"](fe.tenant_gp(t))[0], v)) for t, v in before.items())
    counts, versions = fe.counts(), fe.versions()
    kept = all(counts[t] == gps[t].num_points() and versions[t] == 0
               for t in before)
    # healthy ticks and a healthy mutation round
    for t in range(len(gps)):
        fe.submit(t, small["Xq"][t, 1], kind="acq")
    _, tick_syncs, _ = _count_syncs(fe.step)
    fe.insert(0, small["Xq"][0, 2], 0.5)
    _, round_syncs, sites = _count_syncs(fe.step)
    print(f"health fleet engine T={len(gps)}: quarantine of tenant "
          f"{poisoned} in {t_q * 1e3:.1f} ms ({stats['quarantines']} "
          f"quarantine, trail {[e.rung for e in stats['events']]}), "
          f"{len(done)} queries retired; the other lanes' tensors bit for "
          f"bit {others}, counts and versions kept {kept}; a healthy tick "
          f"{tick_syncs} host syncs (fleet_phase's tick "
          f"{small['tick_syncs']}); a healthy insert round {round_syncs} "
          f"syncs ({sites})", flush=True)
    if not (stats["quarantines"] == 1 and stats["repairs"] == 1 and others
            and kept and len(done) == len(gps)
            and all(np.isfinite(x.result["mean"]) for x in done)
            and tick_syncs == small["tick_syncs"]
            and fe.health_stats()["repairs"] == 1):  # none in healthy rounds
        raise RuntimeError("health: the fleet engine's quarantine")
    del fe, gps, before

    # a checkpoint round trip of the kmg GP
    with tempfile.TemporaryDirectory() as d:
        ck = P["Checkpointer"](d, keep=1)
        _, t_save = _sync_time(lambda: ck.save(0, kmg, blocking=True))
        (restored, step), t_load = _sync_time(lambda: ck.restore(kmg))
        size = sum(f.stat().st_size for f in Path(d).rglob("*")
                   if f.is_file())
    got, want = (_queries(P, g, Xq_t, B_PATH) for g in (restored, kmg))
    bits = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"health checkpoint kmg GP: save {t_save * 1e3:.1f} ms, restore "
          f"{t_load * 1e3:.1f} ms, {size / 2**20:.1f} MiB on disk; mean(100) "
          f"and var({B_PATH}) bit for bit {bits}", flush=True)
    if not (bits and step == 0):
        raise RuntimeError("health: the checkpoint round trip")
    print(f"health phase: {time.perf_counter() - t_phase:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; repair "
          f"launches {({k: v for k, v in total.items() if v})}", flush=True)
    _stamp("health: engines and checkpoint")
    return total


# ---------------------------------------------------------------------------
# the pivoted LU route: GPConfig(pivot=True, solve_alg="lu")
# ---------------------------------------------------------------------------

# the kmg card-vs-CPU check's size: its CPU side runs the plain pivoted LU's
# row loop in every V-cycle
N_PIVOT_KMG = 1500


def _pivot_cfgs(P):
    """The pivoted LU checks' configurations (section 3)."""
    G = P["GPConfig"]
    kw = dict(pivot=True, solve_alg="lu")
    return dict(pcg=G(q=0, solver_iters=40, precond="none", **kw),
                kmg=G(q=0, precond="kmg", **kw),
                q1=G(q=1, solver_iters=40, precond="none", **kw))


def _lu_backward_err(P, band, x, rhs, lo, hi):
    """Normwise backward error |M x - r| / (|M| |x| + |r|), max norms."""
    res = P["banded_matvec_plain"](band, x, lo, hi) - rhs
    return float(res.abs().max() / (band.abs().sum(-1).max() * x.abs().max()
                                    + rhs.abs().max()))


def _swap_band(rng, G, n, lo, hi, dev):
    """A well-conditioned band on which partial pivoting swaps: a dominant
    band's rows scaled by 1 and 50 in turn (the scaled rows' off-diagonals
    outgrow the diagonals above them), and a zero leading diagonal entry,
    which leaves the unpivoted LU nothing to divide by."""
    bd = _band(rng, G, n, lo, hi, "cpu")
    bd = bd * torch.where(torch.arange(n) % 2 == 1, 50.0, 1.0)[None, :, None]
    bd[:, 0, lo] = 0.0
    return bd.to(dev)


def pivot_kernel_rows(P, rng, dev, gp):
    """``banded_lu_pivot`` against its plain version on the same CUDA
    tensors: the pivoted path's own SAPhi (lo = hi = 1, G = 10, n = 30000,
    B = 32: the kernels line's row), a (2, 2) band (SAPhi at q = 1, the
    gradients' B at q = 0; B = 16 probes), an asymmetric (2, 1) band that
    forces swaps, and the q = 3 insert patch's shape (half-width 8, 2 D
    bands of patch_size rows, 12 q + 17 columns). Gates: x within 1e-10
    relative on the well-conditioned bands (all but the path's SAPhi,
    whose conditioning follows the Schwefel points); on every band the
    kernel's backward error within 10x the plain version's (the kernel
    rounds each product and difference as the plain version does, so its
    pivots are the plain version's; were two candidates to differ only by
    rounding, the choices could part, and this gate decides); the
    log-determinant within 1e-12 of max(|plain|, 1)."""
    D, n, B = D_PATH, N_PATH, B_PATH
    Pn = P["patch_size"](3, STREAM_CAP)
    eps = float(torch.finfo(torch.float64).eps)
    cases = (("path SAPhi (1,1)", gp.ops.SAPhi.data, 1, 1, B, False),
             ("(2,2)", _band(rng, D, n, 2, 2, dev), 2, 2, 16, True),
             ("swaps (2,1)", _swap_band(rng, D, n, 2, 1, dev), 2, 1, 8, True),
             ("patch (8,8)", _swap_band(rng, 2 * D, Pn, 8, 8, dev), 8, 8,
              53, True))
    rows = []
    for tag, bd, lo, hi, Bc, well in cases:
        G, nn, wb = bd.shape
        rhs = torch.as_tensor(rng.standard_normal((G, nn, Bc)), device=dev)
        ms, (x, ld) = _event_ms(lambda: P["banded_lu_pivot"](bd, rhs, lo, hi),
                                reps=5)
        pms, (xp, ldp, swaps) = _event_ms(
            lambda: P["banded_lu_pivot_plain"](bd, rhs, lo, hi, swaps=True),
            reps=1, warmup=0)
        err, rel = _errs(x, xp)
        ld_err = float((ld - ldp).abs().max()
                       / max(float(ldp.abs().max()), 1.0))
        be_k = _lu_backward_err(P, bd, x, rhs, lo, hi)
        be_p = _lu_backward_err(P, bd, xp, rhs, lo, hi)
        wu = lo + hi + 1
        nbytes = 8 * (G * nn * wb + 2 * G * nn * Bc + G)
        flops = G * nn * (lo + 2 * lo * wu + 1) + G * nn * Bc * (
            2 * lo + 2 * (wu - 1) + 1)
        b_ms, b_by = _bound(nbytes, flops)
        tol = 1e-10 if well else float("inf")
        print(f"kernel banded_lu_pivot {tag} G={G} n={nn} B={Bc}: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol "
              f"{tol:.0e}); bitwise {torch.equal(x, xp)}; swaps "
              f"{int(swaps.sum())} of {G * nn}; backward error kernel "
              f"{be_k:.3e} plain {be_p:.3e}; logdet err {ld_err:.3e} (tol "
              f"1e-12); kernel_ms={ms:.4f} plain_ms={pms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not (rel <= tol and be_k <= 10.0 * max(be_p, eps)
                and ld_err <= 1e-12 and bool(torch.isfinite(x).all())):
            raise RuntimeError(f"banded_lu_pivot {tag}: rel {rel:.3e}, "
                               f"backward {be_k:.3e} vs {be_p:.3e}, logdet "
                               f"{ld_err:.3e}")
        if not rows:
            rows.append(dict(
                name="banded_lu_pivot", route="cuda",
                source="src/repro_torch/csrc/banded_lu_pivot.cu",
                replaces="src/repro/core/banded.py:304 (a lax.scan; no "
                         "Pallas kernel)",
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None))
        del bd, rhs, x, xp
    return rows


def pivot_lu_phase(P, dev, X, Y, omega, sigma, Xq, f):
    """``GPConfig(pivot=True, solve_alg="lu")`` as users write it, at the
    main path's point: ``precond`` resolves to kmg and ``fused`` to "off",
    and every banded solve and log-determinant of width >= 1 runs the
    pivoted banded LU. fit -> mean(100) -> var(100) -> ``log_likelihood``
    -> ``mll_gradients``, with walls, peak memory and launches; no block-CR
    or fused kernel may launch. Then the kernel rows
    (:func:`pivot_kernel_rows`). Returns (rows, the path's counts)."""
    _build = P["_build"]
    t0 = time.perf_counter()
    D, n = D_PATH, N_PATH
    cfg = P["GPConfig"](pivot=True, solve_alg="lu")
    gen = torch.Generator().manual_seed(9)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    gp, t_fit = _sync_time(lambda: P["fit"](cfg, X, Y, omega, sigma))
    mu, t_mean = _sync_time(lambda: P["posterior_mean"](gp, Xq))
    var, t_var = _sync_time(lambda: P["posterior_var"](gp, Xq))
    (ll, ll_v), t_ll = _sync_time(
        lambda: P["log_likelihood"](gp, gen, return_verdict=True))
    (g_om, g_sg, info), t_grad = _sync_time(
        lambda: P["mll_gradients"](gp, gen, return_info=True))
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    mu_np, var_np = mu.cpu().numpy(), var.cpu().numpy()
    verdicts = {k: P["verdict_name"](v) for k, v in (
        ("fit", gp.health.verdict), ("log_likelihood", ll_v),
        ("mll_gradients", info.verdict))}
    print(f"pivoted LU path GPConfig(pivot=True, solve_alg='lu') n={n} "
          f"D={D}: precond {gp.config.precond}, fused {gp.config.fused}: "
          f"fit {t_fit * 1e3:.1f} ms, posterior_mean(100) "
          f"{t_mean * 1e3:.1f} ms, posterior_var(100) {t_var * 1e3:.1f} ms, "
          f"log_likelihood {t_ll * 1e3:.1f} ms (value {float(ll):.6f}), "
          f"mll_gradients {t_grad * 1e3:.1f} ms; RMSE "
          f"{float(np.sqrt(np.mean((mu_np - f(Xq)) ** 2))):.4f}; verdicts "
          f"{verdicts}; peak memory {peak / 2**20:.1f} MiB; launches "
          f"{counts}", flush=True)
    vals = torch.cat([ll.reshape(1), g_om, g_sg.reshape(1)]).cpu()
    if not (gp.config.precond == "kmg" and gp.config.fused == "off"
            and np.isfinite(mu_np).all() and np.isfinite(var_np).all()
            and (var_np > 0).all() and bool(torch.isfinite(vals).all())
            and all(v in ("OK", "STALLED") for v in verdicts.values())):
        raise RuntimeError("pivoted LU path: not kmg/off, not finite, or "
                           "diverged")
    _require_launched("pivoted LU path", counts,
                      ("banded_lu_pivot", "banded_lu", "banded_matvec",
                       "band_matmul", "rgf_blocks"))
    bad = [k for k, v in counts.items()
           if v and k.startswith(("cr_", "mega_", "fused_"))]
    if bad:
        raise RuntimeError(f"the pivoted LU path launched {bad}")
    rows = pivot_kernel_rows(P, np.random.default_rng(26), dev, gp)
    del gp
    print(f"pivoted LU phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, counts


def _pivot_cpu(P, name):
    """The CPU side of :func:`pivot_consistency` (a worker's)."""
    cfgs, draws = _pivot_cfgs(P), _draws(P)
    mean, var = P["posterior_mean"], P["posterior_var"]

    def fit(cfg, X, Y, om):
        return P["fit"](cfg, X, Y, om, 1.0, device="cpu")

    out = {}
    if name == "pivot":
        Xc, Yc, omc, Xqc = _schwefel_check(P)
        g = fit(cfgs["pcg"], Xc, Yc, omc)
        out["gp"] = _gp_arrays(P, g)
        out["mean"] = _np(mean(g, Xqc, device="cpu"))
        out["var"] = _np(var(g, Xqc[:B_PATH], device="cpu"))
        out["ll"] = _np(P["_log_likelihood"](g, draws["schwefel pm"],
                                             draws["schwefel pv"]))
        out["xpu"] = _np(P["banded_lu_pivot_plain"](
            g.B.data, _same_factors_rhs(P, g, draws["schwefel V"]), g.B.lo,
            g.B.hi)[0])
        k = N_PIVOT_KMG
        gk = fit(cfgs["kmg"], Xc[:k], Yc[:k], omc)
        out["kmg mean"] = _np(mean(gk, Xqc, device="cpu"))
        out["kmg var"] = _np(var(gk, Xqc[:8], device="cpu"))
    elif name == "pivot jittered":
        (Xj, Yj, Xqj), _ = _jittered_checks()
        om4 = np.full(D_PATH, 4.0)
        out["grads"] = _np(_grads(P, fit(cfgs["pcg"], Xj, Yj, om4),
                                  draws["jittered V"]))
        g1 = fit(cfgs["q1"], Xj, Yj, om4)
        out["q1 mean"] = _np(mean(g1, Xqj, device="cpu"))
        out["q1 var"] = _np(var(g1, Xqj[:8], device="cpu"))
    else:
        out = _stream_cpu(P, lu=True)
    return out


def pivot_consistency(P, dev, refs):
    """The pivoted LU route, card against the plain CPU port (the CPU side
    from the workers, :func:`_pivot_cpu`), within 1e-7: at n = N_CHECK on
    the Schwefel data with ``precond="none"`` the mean and variance, the
    log-likelihood (the same probes) from the CPU fit's caches (that of
    each side's own fit printed), and the gradients' B solves from the
    same factors (B is ill-conditioned here, ROADMAP Queue 3: the kernel's
    backward error within 10x the plain version's is the gate); kmg at
    N_PIVOT_KMG; on the jittered grid the q = 0 gradients and a q = 1 mean
    and variance; 4 inserts and 4 evicts of a ``solve_alg="lu"`` GP,
    unpivoted and pivoted, from one carried state."""
    D, B = D_PATH, B_PATH
    cfgs, draws = _pivot_cfgs(P), _draws(P)
    T = torch.as_tensor
    r = refs("pivot")
    Xc, Yc, omc, Xqc = _schwefel_check(P)
    g = P["fit"](cfgs["pcg"], Xc, Yc, omc, 1.0)
    tag = f"pivoted LU n={N_CHECK} D={D}"
    _check(f"{tag} mean", P["posterior_mean"](g, Xqc), T(r["mean"]))
    _check(f"{tag} var", P["posterior_var"](g, Xqc[:B]), T(r["var"]))
    pm, pv = draws["schwefel pm"].to(dev), draws["schwefel pv"].to(dev)
    # The likelihood's quadratic term Y^T Y / s^2 - Y^T u / s^4 cancels
    # about |Y|^2 / |ll| here (Schwefel values ~1e3, sigma = 1), so it
    # carries the two fits' gap in u = Mhat^{-1} S Y (their 40 PCG
    # iterations round apart) times that: printed, not a gate. The gate is
    # the likelihood from the same fit caches (the CPU fit rebuilt on the
    # card), which holds the log-determinants' kernels and the estimator's
    # pivoted block solves.
    ll_own = P["_log_likelihood"](g, pm, pv)
    gap = float((ll_own.cpu() - T(r["ll"])).abs() / T(r["ll"]).abs())
    yy = float((g.Y @ g.Y).cpu()) / float(T(r["ll"]).abs())
    u_cpu = T(r["gp"]["u_sy"])
    u_gap = float((g.u_sy.cpu() - u_cpu).abs().max() / u_cpu.abs().max())
    print(f"{tag} log_likelihood of the card's own fit: card vs cpu max rel "
          f"{gap:.3e} (not a gate: |Y|^2 / |ll| = {yy:.3e}, the fits' u_sy "
          f"max rel {u_gap:.3e})", flush=True)
    del g
    g_cpu = P["gp_from_arrays"](r["gp"], cfgs["pcg"], "cpu")
    _check(f"{tag} log_likelihood (the CPU fit's caches)",
           P["_log_likelihood"](_gp_on(P, g_cpu, dev), pm, pv), T(r["ll"]))
    Bb = g_cpu.B
    rhs = _same_factors_rhs(P, g_cpu, draws["schwefel V"])
    Bd, rd = Bb.data.to(dev), rhs.contiguous().to(dev)
    xs = {"kernel": P["banded_lu_pivot"](Bd, rd, Bb.lo, Bb.hi)[0].cpu(),
          "plain card": P["banded_lu_pivot_plain"](Bd, rd, Bb.lo,
                                                   Bb.hi)[0].cpu(),
          "plain cpu": T(r["xpu"])}
    be = {k: _lu_backward_err(P, Bb.data, x, rhs, Bb.lo, Bb.hi)
          for k, x in xs.items()}
    gap = float((xs["kernel"] - xs["plain cpu"]).abs().max()
                / xs["plain cpu"].abs().max())
    print(f"{tag} gradients' B ({Bb.lo},{Bb.hi}) solves from the same "
          f"factors: kernel vs plain cpu max rel {gap:.3e} (conditioning; "
          f"not a gate), kernel bitwise the plain card's "
          f"{torch.equal(xs['kernel'], xs['plain card'])}; backward errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in be.items()), flush=True)
    eps = float(torch.finfo(torch.float64).eps)
    if not be["kernel"] <= 10.0 * max(be["plain card"], be["plain cpu"], eps):
        raise RuntimeError(f"banded_lu_pivot on the Schwefel B: backward "
                           f"error {be} above the plain version's")
    k = N_PIVOT_KMG
    gk = P["fit"](cfgs["kmg"], Xc[:k], Yc[:k], omc, 1.0)
    _check(f"pivoted LU kmg n={k} D={D} mean", P["posterior_mean"](gk, Xqc),
           T(r["kmg mean"]))
    _check(f"pivoted LU kmg n={k} D={D} var", P["posterior_var"](gk, Xqc[:8]),
           T(r["kmg var"]))
    del gk
    r = refs("pivot jittered")
    (Xj, Yj, Xqj), _ = _jittered_checks()
    om4 = np.full(D, 4.0)
    g0 = P["fit"](cfgs["pcg"], Xj, Yj, om4, 1.0)
    _check(f"pivoted LU jittered n={N_Q1} D={D} gradients",
           _grads(P, g0, draws["jittered V"].to(dev)), T(r["grads"]))
    del g0
    g1 = P["fit"](cfgs["q1"], Xj, Yj, om4, 1.0)
    _check(f"pivoted LU q=1 n={N_Q1} D={D} mean", P["posterior_mean"](g1, Xqj),
           T(r["q1 mean"]))
    _check(f"pivoted LU q=1 n={N_Q1} D={D} var",
           P["posterior_var"](g1, Xqj[:8]), T(r["q1 var"]))
    del g1
    stream_consistency(P, dev, refs("pivot stream"), lu=True)


# ---------------------------------------------------------------------------
# consistency (section 3): the card against the plain CPU port. The CPU side
# (plain fits, solves, queries, likelihoods, gradients) runs in worker
# processes started at the top of main(), while the card phases run; the
# card side and every comparison stay in the main process.
# ---------------------------------------------------------------------------

# the worker processes of the CPU side, and the sections they compute (the
# longest first, so that they end together)
REF_WORKERS = 3
REF_SECTIONS = ("fleet", "pivot jittered", "pivot", "q3", "pivot stream",
                "jittered", "schwefel", "q2", "relaxation", "stream")
_PORT = None


class _ProbeShape:
    """What ``_probe_block`` reads of a GP: its size and where it lives."""

    def __init__(self, n, D):
        self.n, self.D, self.n_active = n, D, None
        self.Y = torch.zeros(0, dtype=torch.float64)
        self.device = torch.device("cpu")


def _draws(P):
    """Every probe block and gradient draw of section 3, from one generator
    in the order the checks take them (the row-keyed draws need only the
    systems' sizes), so that each section can run on its own."""
    gen = torch.Generator().manual_seed(1)

    def block(n, Q):
        return P["_probe_block"](_ProbeShape(n, D_PATH), gen, Q)

    out = {"schwefel pm": block(N_CHECK, 4),
           "schwefel pv": block(N_CHECK, Q_PATH)}
    out["schwefel V"] = P["rademacher_rows"](gen, N_CHECK, (Q_CHECK,))
    out["jittered V"] = P["rademacher_rows"](gen, N_Q1, (Q_CHECK,))
    for name, n in (("q1", N_Q1), ("q2", N_Q2_CHECK), ("q3", N_Q3_CHECK)):
        out[f"{name} pm"], out[f"{name} pv"] = block(n, 4), block(n, Q_PATH)
    return out


def _schwefel_check(P):
    """The quickstart's Schwefel data at N_CHECK, omega, 100 queries."""
    Xc, Yc, _, bc = P["sample_test_function"]("schwefel", N_CHECK, D_PATH,
                                              seed=0)
    omc = 8.0 / (bc[:, 1] - bc[:, 0])
    Xqc = np.random.default_rng(1).uniform(bc[:, 0], bc[:, 1], (100, D_PATH))
    return Xc, Yc, omc, Xqc


def _jittered_checks():
    """The jittered grids of the q = 0 / q = 1 checks (N_Q1) and of the
    q = 3 checks (N_Q3_CHECK, spacing 0.2), from one generator, and each
    one's queries."""
    D = D_PATH
    rq = np.random.default_rng(2)
    Xj, span = _jittered(rq, N_Q1, D)
    Yj = np.sin(Xj * 6.0 * np.pi / span).sum(1) \
        + 0.1 * rq.standard_normal(N_Q1)
    Xqj = rq.uniform(0.0, span, (40, D))
    Xj3, span3 = _jittered(rq, N_Q3_CHECK, D, spacing=0.2)
    Yj3 = np.sin(Xj3 * 6.0 * np.pi / span3).sum(1) \
        + 0.1 * rq.standard_normal(N_Q3_CHECK)
    Xqj3 = rq.uniform(0.0, span3, (40, D))
    return (Xj, Yj, Xqj), (Xj3, Yj3, Xqj3)


def _q2_check():
    r2 = np.random.default_rng(5)
    Xj2, span2 = _jittered(r2, N_Q2_CHECK, D_PATH)
    Yj2 = np.sin(Xj2 * 6.0 * np.pi / span2).sum(1) \
        + 0.1 * r2.standard_normal(N_Q2_CHECK)
    return Xj2, Yj2, r2.uniform(0.0, span2, (B_PATH, D_PATH))


def _check_cfgs(P):
    """The configurations of section 3."""
    G = P["GPConfig"]
    return dict(
        pcg=G(q=0, solver="pcg", solver_iters=40, precond="none"),
        kmg=G(q=0, precond="kmg"),
        q1=G(q=1, solver="pcg", solver_iters=40, precond="none"),
        q2=G(q=2, solver="pcg", solver_iters=40, precond="none"),
        q3=G(q=3, solver="pcg", solver_iters=80, precond="none",
             fused="off"),
        relax={(solver, f): G(q=0, solver=solver, solver_iters=40,
                              precond="none", fused=f)
               for solver in ("gauss_seidel", "jacobi")
               for f in ("whole", "on", "off")})


def _q3_solver_cfg(cfg, solver, fused):
    """The q = 3 fused solves' config from the fit's: pcg 80 iterations,
    the relaxation solvers 40 sweeps."""
    return dataclasses.replace(cfg, solver=solver, fused=fused,
                               solver_iters=80 if solver == "pcg" else 40)


def _np(t):
    return t.detach().cpu().numpy()


def _cpu_section(P, name):
    """The CPU side of one consistency section (plain versions, CPU
    tensors): numpy arrays by name."""
    cfgs, draws = _check_cfgs(P), _draws(P)
    mean, var = P["posterior_mean"], P["posterior_var"]
    ll = P["_log_likelihood"]
    B = B_PATH

    def fit(cfg, X, Y, om, **kw):
        return P["fit"](cfg, X, Y, om, 1.0, device="cpu", **kw)

    out = {}
    if name == "schwefel":
        Xc, Yc, omc, Xqc = _schwefel_check(P)
        g = fit(cfgs["pcg"], Xc, Yc, omc)
        out["gp"] = _gp_arrays(P, g)
        out["mean"] = _np(mean(g, Xqc, device="cpu"))
        out["var"] = _np(var(g, Xqc[:B], device="cpu"))
        out["bo"] = _bo_cpu(P, g, Xqc[:B][:8])
        gk = fit(cfgs["kmg"], Xc, Yc, omc)
        out["kmg mean"] = _np(mean(gk, Xqc, device="cpu"))
        out["kmg var"] = _np(var(gk, Xqc[:8], device="cpu"))
        out["ll"] = _np(ll(g, draws["schwefel pm"], draws["schwefel pv"]))
        out["same factors"] = _same_factors_cpu(P, g, draws["schwefel V"])
    elif name == "stream":
        out = _stream_cpu(P)
    elif name == "jittered":
        (Xj, Yj, Xqj), _ = _jittered_checks()
        om = np.full(D_PATH, 4.0)
        g0 = fit(cfgs["pcg"], Xj, Yj, om)
        out["grads"] = _np(_grads(P, g0, draws["jittered V"]))
        g1 = fit(cfgs["q1"], Xj, Yj, om)
        out["q1 mean"] = _np(mean(g1, Xqj, device="cpu"))
        out["q1 var"] = _np(var(g1, Xqj, device="cpu"))
        out["q1 ll"] = _np(ll(g1, draws["q1 pm"], draws["q1 pv"]))
        out["q1 bo"] = _bo_cpu(P, g1, Xqj[:8])
    elif name == "relaxation":
        Xc, Yc, omc, Xqc = _schwefel_check(P)
        for solver in ("gauss_seidel", "jacobi"):
            g = fit(cfgs["relax"][solver, "whole"], Xc, Yc, omc)
            out[solver] = (_np(mean(g, Xqc, device="cpu")),
                           _np(var(g, Xqc[:B], device="cpu")))
    elif name == "q2":
        Xj2, Yj2, Xqj2 = _q2_check()
        g = fit(cfgs["q2"], Xj2, Yj2, np.full(D_PATH, 4.0))
        out["mean"] = _np(mean(g, Xqj2, device="cpu"))
        out["var"] = _np(var(g, Xqj2, device="cpu"))
        out["ll"] = _np(ll(g, draws["q2 pm"], draws["q2 pv"]))
    elif name == "q3":
        _, (Xj3, Yj3, Xqj3) = _jittered_checks()
        g = fit(cfgs["q3"], Xj3, Yj3, np.full(D_PATH, 4.0))
        out["gp"] = _gp_arrays(P, g)
        out["mean"] = _np(mean(g, Xqj3[:B], device="cpu"))
        out["var"] = _np(var(g, Xqj3[:B], device="cpu"))
        out["ll"] = _np(ll(g, draws["q3 pm"], draws["q3 pv"]))
        for solver in ("pcg", "gauss_seidel", "jacobi"):
            ccfg = _q3_solver_cfg(g.config, solver, "whole")
            u_sy, bY = P["agp"].mean_caches(ccfg, g.ops, g.Y)
            g3 = dataclasses.replace(g, config=ccfg, u_sy=u_sy, bY=bY)
            out[solver] = (_np(mean(g3, Xqj3[:B], device="cpu")),
                           _np(var(g3, Xqj3[:8], device="cpu")))
        V3 = draws["jittered V"][:N_Q3_CHECK]
        out["xp"] = _np(P["block_cr_plain"](
            g.B.data, _same_factors_rhs(P, g, V3), g.B.lo)[0])
    elif name == "fleet":
        out = _fleet_solvers_cpu(P)
    elif name.startswith("pivot"):
        out = _pivot_cpu(P, name)
    else:
        raise ValueError(f"unknown consistency section {name!r}")
    return out


def _ref_init(threads):
    torch.set_num_threads(threads)


def cpu_section(name):
    """A worker's task: :func:`_cpu_section` with its wall time."""
    global _PORT
    t0 = time.perf_counter()
    if _PORT is None:
        _PORT = _import_port()
    out = _cpu_section(_PORT, name)
    return out, time.perf_counter() - t0


class _Refs:
    """The CPU side of section 3, in ``REF_WORKERS`` spawned processes of
    ``(cores - 2) / REF_WORKERS`` torch threads each (the two cores left
    are the card side's launching thread's). A section's result is waited
    for where its comparison needs it; a worker's failure, or a result
    that has not come by the script's limit, fails the run."""

    def __init__(self):
        import multiprocessing

        cores = os.cpu_count() or 4
        self.threads = max(1, (cores - 2) // REF_WORKERS)
        ctx = multiprocessing.get_context("spawn")
        self.pool = ctx.Pool(REF_WORKERS, initializer=_ref_init,
                             initargs=(self.threads,))
        self.jobs = {k: self.pool.apply_async(cpu_section, (k,))
                     for k in REF_SECTIONS}
        self.seconds = {}
        print(f"cpu references: {REF_WORKERS} worker processes x "
              f"{self.threads} torch threads of {cores} cores; the card "
              f"side keeps {torch.get_num_threads()} threads; sections "
              f"{list(REF_SECTIONS)}", flush=True)

    def __call__(self, name):
        t0 = time.perf_counter()
        left = max(1.0, 1180.0 - (t0 - _T0))
        out, secs = self.jobs[name].get(timeout=left)
        self.seconds[name] = secs
        print(f"cpu references {name}: {secs:.1f} s in its worker; waited "
              f"{time.perf_counter() - t0:.1f} s for it", flush=True)
        return out

    def close(self):
        self.pool.terminate()
        self.pool.join()


def consistency(P, dev, refs):
    """Section 3: each check's card side here, its CPU side from ``refs``
    (the workers' :func:`_cpu_section`), on the same data, probes and
    bars as when both sides ran here."""
    D, B = D_PATH, B_PATH
    cfgs, draws = _check_cfgs(P), _draws(P)
    cfg = cfgs["pcg"]
    T = torch.as_tensor

    def on(t):
        return t.to(dev)

    # --- the quickstart's Schwefel data
    Xc, Yc, omc, Xqc = _schwefel_check(P)
    Xqr = Xqc[:B]  # one variance chunk
    g_card = P["fit"](cfg, Xc, Yc, omc, 1.0)
    r = refs("schwefel")
    for name, fn, xq in (("mean", P["posterior_mean"], Xqc),
                         ("var", P["posterior_var"], Xqr)):
        _check(f"n={N_CHECK} D={D} {name}", fn(g_card, xq), T(r[name]))
    # Bayesian optimisation: the acquisition and the mean's gradient
    # (8 queries: the CPU side's plain PCG runs once per kind)
    bo_consistency(P, g_card, r["bo"], Xqr[:8], f"n={N_CHECK} D={D}")
    # the per-iteration pcg path on the card against the CPU's whole solve
    # (the CPU's "on" equals its "whole" bit for bit: the CPU tests)
    g_on = P["fit"](dataclasses.replace(cfg, fused="on"), Xc, Yc, omc, 1.0)
    for name, fn, xq in (("mean", P["posterior_mean"], Xqc),
                         ("var", P["posterior_var"], Xqr)):
        _check(f"n={N_CHECK} D={D} pcg fused=on {name}", fn(g_on, xq),
               T(r[name]))
    del g_on
    # kmg (forced: n < 4096), one variance chunk of 8 queries to bound the
    # CPU's plain V-cycles
    gk = P["fit"](cfgs["kmg"], Xc, Yc, omc, 1.0)
    for name, fn, xq in (("mean", P["posterior_mean"], Xqc),
                         ("var", P["posterior_var"], Xqc[:8])):
        _check(f"n={N_CHECK} D={D} kmg {name}", fn(gk, xq),
               T(r[f"kmg {name}"]))
    del gk
    # the same probe blocks, drawn once, fed to the card and the CPU
    _check(f"n={N_CHECK} D={D} log_likelihood",
           P["_log_likelihood"](g_card, on(draws["schwefel pm"]),
                                on(draws["schwefel pv"])), T(r["ll"]))
    # The gradients solve with the generalized-KP factor B. On these
    # clustered points (omega * gap down to ~1e-7) B is ill-conditioned
    # (cond 1e15..1e18 at this size, ROADMAP Queue 3): the card's and the
    # CPU's SVDs give B's that differ far above 1e-7, as two LAPACK builds
    # do. So here the gradients are compared from the same factors, with the
    # kernel's backward error as the gate, and held within 1e-7 on the
    # jittered grid below.
    g_cpu = P["gp_from_arrays"](r["gp"], cfg, "cpu")
    b_rel = float((g_card.B.data.cpu() - g_cpu.B.data).abs().max()
                  / g_cpu.B.data.abs().max())
    print(f"n={N_CHECK} D={D} generalized-KP B factor: card vs cpu max rel "
          f"{b_rel:.3e} (ill-conditioned; not a gate)", flush=True)
    del g_card
    schwefel_same_factors(P, g_cpu, draws["schwefel V"], dev,
                          r["same factors"])
    del g_cpu, r
    _stamp("consistency: Schwefel")
    stream_consistency(P, dev, refs("stream"))
    _stamp("consistency: streaming from one carried state")

    # --- jittered grids (see _jittered): q = 0 gradients, then a q = 1 path
    (Xj, Yj, Xqj), (Xj3, Yj3, Xqj3) = _jittered_checks()
    om4 = np.full(D, 4.0)
    q0 = P["fit"](cfg, Xj, Yj, om4, 1.0)
    ga = _grads(P, q0, on(draws["jittered V"]))
    del q0
    r = refs("jittered")
    _check(f"n={N_Q1} D={D} jittered mll_gradients", ga, T(r["grads"]))
    bo_finite_differences(P, cfg, Xj, Yj, Xqj[:4],
                          f"n={N_Q1} D={D} q=0 jittered")
    q1 = P["fit"](cfgs["q1"], Xj, Yj, om4, 1.0)
    for name, fn in (("mean", P["posterior_mean"]),
                     ("var", P["posterior_var"])):
        _check(f"n={N_Q1} D={D} q=1 {name}", fn(q1, Xqj),
               T(r[f"q1 {name}"]))
    _check(f"n={N_Q1} D={D} q=1 log_likelihood",
           P["_log_likelihood"](q1, on(draws["q1 pm"]),
                                on(draws["q1 pv"])), T(r["q1 ll"]))
    # Bayesian optimisation at q = 1: Phi^T is solved by block CR
    bo_consistency(P, q1, r["q1 bo"], Xqj[:8], f"n={N_Q1} D={D} q=1")
    bo_finite_differences(P, cfgs["q1"], Xj, Yj, Xqj[:4],
                          f"n={N_Q1} D={D} q=1 jittered")
    del q1
    local_cache_check(P, dev)
    _stamp("consistency: jittered q = 0 gradients, q = 1, BO")

    # relaxation solvers: the card in every fused mode against the CPU's
    # whole solve on the quickstart's data (the CPU's "on" is a loop of the
    # same plain sweep, bit for bit, and its "off" is held to "whole" by
    # the CPU tests)
    r = refs("relaxation")
    for solver in ("gauss_seidel", "jacobi"):
        want = r[solver]
        for fused in ("whole", "on", "off"):
            g = P["fit"](cfgs["relax"][solver, fused], Xc, Yc, omc, 1.0)
            _check(f"n={N_CHECK} D={D} {solver} fused={fused} mean",
                   P["posterior_mean"](g, Xqc), T(want[0]))
            _check(f"n={N_CHECK} D={D} {solver} fused={fused} var",
                   P["posterior_var"](g, Xqr), T(want[1]))
    _stamp("consistency: relaxation solvers")
    # q = 2 (Matern-5/2) on a jittered grid: block_cr W = 4, rgf w = 5
    Xj2, Yj2, Xqj2 = _q2_check()
    q2 = P["fit"](cfgs["q2"], Xj2, Yj2, om4, 1.0)
    r = refs("q2")
    for name, fn in (("mean", P["posterior_mean"]),
                     ("var", P["posterior_var"])):
        _check(f"n={N_Q2_CHECK} D={D} q=2 {name}", fn(q2, Xqj2), T(r[name]))
    _check(f"n={N_Q2_CHECK} D={D} q=2 log_likelihood",
           P["_log_likelihood"](q2, on(draws["q2 pm"]), on(draws["q2 pv"])),
           T(r["ll"]))
    del q2
    _stamp("consistency: q = 2")
    # q = 3 on a jittered grid of spacing 0.2 / omega (cond(H) ~1e8, as
    # the q = 2 grid's), 80 iterations (at 40 the solve stops at a relative
    # residual of 6e-6 there, and a 1e-15 change of Y moves the CPU's own
    # mean by 1e-7; at 80, 4e-11 and 5e-11). The card's fit is redone from
    # the CPU fit's KP factors (they come from batched SVDs whose q = 3
    # null vectors differ between the card's and the CPU's LAPACK, ROADMAP
    # Queue 3; the card's own fit's gap is printed, not gated); the
    # gradients, through the generalized-KP B (w = 5), are gated by the
    # block-CR kernels' backward error on that B against the plain
    # version's, from the same factors
    cfg3 = cfgs["q3"]
    own = P["posterior_mean"](P["fit"](cfg3, Xj3, Yj3, om4, 1.0),
                              Xqj3[:B]).cpu()
    r = refs("q3")
    want3 = T(r["mean"])
    gap = float((own - want3).abs().max() / want3.abs().max())
    print(f"n={N_Q3_CHECK} D={D} q=3 mean, the card's own fit (its own SVDs) "
          f"vs cpu max rel {gap:.3e} (not a gate)", flush=True)
    g3cpu = P["gp_from_arrays"](r["gp"], cfg3, "cpu")
    g3 = _refit_on(P, g3cpu, dev)
    for name, fn in (("mean", P["posterior_mean"]),
                     ("var", P["posterior_var"])):
        _check(f"n={N_Q3_CHECK} D={D} q=3 (same factors) {name}",
               fn(g3, Xqj3[:B]), T(r[name]))
    pm3, pv3 = on(draws["q3 pm"]), on(draws["q3 pv"])
    _check(f"n={N_Q3_CHECK} D={D} q=3 (same factors) log_likelihood",
           P["_log_likelihood"](g3, pm3, pv3), T(r["ll"]))
    # the fused solves at q = 3 (the half-width-4 kernels) from the same
    # factors, against the CPU's plain whole solve of the same solver
    # (pcg 80 iterations, the relaxation solvers 40 sweeps; the CPU redoes
    # only the mean solve, the variance band being the fit's), 8 variance
    # queries; the likelihood against the CPU's above (its solves enter
    # only through the mean cache)
    for solver in ("pcg", "gauss_seidel", "jacobi"):
        want = r[solver]
        for fused in ("whole", "on") if solver == "pcg" else ("whole",):
            card3 = _refit_on(P, dataclasses.replace(
                g3cpu, config=_q3_solver_cfg(g3cpu.config, solver, fused)),
                dev)
            for name, fn, xq, w in (
                    ("mean", P["posterior_mean"], Xqj3[:B], want[0]),
                    ("var", P["posterior_var"], Xqj3[:8], want[1])):
                _check(f"n={N_Q3_CHECK} D={D} q=3 {solver} fused={fused} "
                       f"(same factors) {name}", fn(card3, xq), T(w))
            if solver == "pcg":
                _check(f"n={N_Q3_CHECK} D={D} q=3 pcg fused={fused} (same "
                       "factors) log_likelihood",
                       P["_log_likelihood"](card3, pm3, pv3), T(r["ll"]))
            del card3
    Bq3 = g3cpu.B
    V3 = draws["jittered V"][:N_Q3_CHECK]  # row-keyed: a longer draw's rows
    rhs3 = _same_factors_rhs(P, g3cpu, V3)
    xk3, _ = P["block_cr"](Bq3.data.to(dev), rhs3.to(dev), Bq3.lo)
    be3 = [_backward_err(P, Bq3.data, x, rhs3, Bq3.lo)
           for x in (xk3.cpu(), T(r["xp"]))]
    g3k = P["_mll_gradients"](g3, V3.to(dev))
    print(f"n={N_Q3_CHECK} D={D} q=3 gradients on the card from the CPU "
          f"fit's factors: finite {bool(torch.isfinite(g3k[0]).all())}; "
          f"block-CR backward error on B (w = {Bq3.lo}): kernel "
          f"{be3[0]:.3e}, plain {be3[1]:.3e}", flush=True)
    eps = float(torch.finfo(torch.float64).eps)
    if not (be3[0] <= 10 * max(be3[1], eps)
            and bool(torch.isfinite(g3k[0]).all())):
        raise RuntimeError(f"q = 3 gradients: backward error {be3}")
    del g3, g3cpu
    _stamp("consistency: q = 3")
    pivot_consistency(P, dev, refs)
    _stamp("consistency: the pivoted LU route")
    print("cpu references, seconds in the workers: " + ", ".join(
        f"{k} {v:.1f}" for k, v in refs.seconds.items()), flush=True)



# ---------------------------------------------------------------------------
# the substrate: a fleet placed on a one-rank NCCL DeviceMesh, the elastic
# restart onto a fresh mesh, the decode engine and the sharded pipeline
# ---------------------------------------------------------------------------

SUBSTRATE_N = 1500  # each tenant's points in the placed fit (fleet_fit's n)
SUBSTRATE_KERNELS = ("mega_pcg_fleet", "banded_lu", "band_matmul",
                     "rgf_blocks")


class _DecodeStub:
    """``tests/test_substrate.py``'s decode-only stub model on the card:
    greedy next token = (token + 1) % vocab."""

    vocab = 17

    def __init__(self, dev):
        self.dev = dev

    def init_cache(self, B, ctx):
        return {"pos": torch.zeros((B,), dtype=torch.int32, device=self.dev)}

    def decode_step(self, params, cache, tokens, pos, par):
        if tokens.device != self.dev or pos.device != self.dev:
            raise RuntimeError(f"decode step got tokens on {tokens.device}")
        nxt = (tokens[:, 0].long() + 1) % self.vocab
        logits = torch.nn.functional.one_hot(nxt, self.vocab).double()
        return logits[:, None, :] * 10.0, cache


def _bitwise(P, a, b) -> bool:
    """Two GP trees of one structure hold the same tensors bit for bit."""
    same = []
    P["fleet"].tree_map(lambda x, y: same.append(
        x.shape == y.shape and torch.equal(x, y)), a, b)
    return bool(same) and all(same)


def substrate_phase(P, dev):
    """A GP fleet on a torch ``DeviceMesh`` (``repro_torch.distributed``):

    1. a one-rank NCCL process group (a ``FileStore`` in a temporary
       directory; NCCL's sockets on the loopback interface) and
       ``elastic_mesh(model=1)``, a (1, 1) ("data", "model") CUDA mesh;
    2. ``fleet_phase``'s service of many small GPs (T = 64 Schwefel
       tenants, ``SUBSTRATE_N`` points each in capacity 2048, D = 10,
       ``GPConfig()``: pcg "whole"): the per-tenant data placed by
       ``fleet_pspecs`` / ``device_put``, ``fleet_fit`` and the queries (32
       a tenant) on the rank's local shards, the gathered mean and variance
       and the fitted fleet bit for bit the unplaced fleet's, with the same
       launches kernel by kernel;
    3. the fitted fleet checkpointed, restored and moved by
       ``reshard_tree`` onto a fresh ``elastic_mesh(model=1, ranks=[0])``
       (the restart after a lost device), queried again bit for bit;
    4. ``ServeEngine`` with the greedy stub on CUDA tensors (6 requests in
       4 slots) and ``ShardedBatches(device="cuda", sharding=...)``, batch
       3 equal to the CPU's.

    Returns the launches by kernel over the phase."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    _build, fl = P["_build"], P["fleet"]
    t_phase = time.perf_counter()
    total = dict.fromkeys(_build.KERNELS, 0)

    def op(fn):
        out, rec = _op(P, fn)
        for k, v in rec["launches"].items():
            total[k] += v
        return out, rec

    tmp = tempfile.mkdtemp(prefix="substrate_")
    env_old = os.environ.get("NCCL_SOCKET_IFNAME")
    os.environ["NCCL_SOCKET_IFNAME"] = "lo"
    try:
        # -- 1. the process group and the mesh --------------------------------
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=dev)
        mesh = P["elastic_mesh"](model=1)
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        t_init = (time.perf_counter() - t0) * 1e3
        shape = P["mesh_shape"](mesh)
        print(f"substrate: NCCL process group (1 rank, FileStore), "
              f"elastic_mesh(model=1) -> {shape} {mesh.device_type} mesh and "
              f"a first all_reduce: {t_init:.1f} ms (backend "
              f"{dist.get_backend()})", flush=True)
        if (shape != {"data": 1, "model": 1} or mesh.device_type != dev.type
                or dist.get_backend() != "nccl" or float(probe) != 1.0):
            raise RuntimeError("substrate: the one-rank NCCL mesh is wrong")

        # -- 2. the placed fleet against the unplaced one --------------------
        T, D = FLEET_T, D_PATH
        Xs, Ys, Xq, bounds = _fleet_data(P, T, np.full(T, SUBSTRATE_N), D,
                                         seed=500)
        omega = 8.0 / (bounds[:, 1] - bounds[:, 0])
        data = {"X": np.stack(Xs), "Y": np.stack(Ys),
                "omega": np.tile(omega, (T, 1)), "sigma": np.ones(T),
                "Xq": Xq}
        data = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        cfg = P["GPConfig"]()
        runs = {}
        for tag in ("unplaced", "placed"):
            rec = {}
            if tag == "placed":
                placed, rec["place"] = op(lambda: P["device_put"](
                    data, P["fleet_pspecs"](data, mesh, T=T)))
                src = {k: v.to_local() for k, v in placed.items()}
            else:
                src = data
            fleet, rec["fleet_fit"] = op(lambda: fl.fleet_fit(
                cfg, src["X"], src["Y"], src["omega"], src["sigma"],
                FLEET_CAP))
            mu, rec["fleet_posterior_mean"] = op(
                lambda: fl.fleet_posterior_mean(fleet, src["Xq"]))
            var, rec["fleet_posterior_var"] = op(
                lambda: fl.fleet_posterior_var(fleet, src["Xq"]))
            if tag == "placed":
                like = placed["Xq"]
                mu, var = (DTensor.from_local(t, mesh, like.placements)
                           .full_tensor() for t in (mu, var))
            runs[tag] = dict(rec=rec, fleet=fleet, mu=mu, var=var)
        a, b = runs["placed"], runs["unplaced"]
        same = (_bitwise(P, a["fleet"], b["fleet"])
                and torch.equal(a["mu"], b["mu"])
                and torch.equal(a["var"], b["var"]))
        ops = ("fleet_fit", "fleet_posterior_mean", "fleet_posterior_var")
        launches_same = all(a["rec"][o]["launches"] == b["rec"][o]["launches"]
                            for o in ops)
        print(f"substrate: fleet T={T} (Schwefel, n={SUBSTRATE_N} each in "
              f"capacity {FLEET_CAP}, D={D}, GPConfig() -> "
              f"{a['fleet'].config.solver} {a['fleet'].config.fused}) placed "
              f"by fleet_pspecs on the (1, 1) mesh: device_put "
              f"{a['rec']['place']['ms']:.1f} ms; " + "; ".join(
                  f"{o} {a['rec'][o]['ms']:.1f} ms (unplaced "
                  f"{b['rec'][o]['ms']:.1f} ms), launches "
                  f"{a['rec'][o]['launches']}" for o in ops)
              + f"; launches equal to the unplaced fleet's, kernel by "
              f"kernel: {launches_same}; fit, mean and variance bit for bit: "
              f"{same}", flush=True)
        if not (same and launches_same):
            raise RuntimeError("substrate: the placed fleet differs from the "
                               "unplaced one")
        used = {k: a["rec"]["fleet_fit"]["launches"].get(k, 0)
                + a["rec"]["fleet_posterior_var"]["launches"].get(k, 0)
                for k in _build.KERNELS}
        _require_launched("placed fleet's fit and variance", used,
                          SUBSTRATE_KERNELS)
        if not (bool(torch.isfinite(a["mu"]).all())
                and bool((a["var"] > 0).all())):
            raise RuntimeError("substrate: placed fleet's queries are not "
                               "finite/positive")

        # -- 3. restart after a lost device: checkpoint, restore, reshard ----
        fitted = a["fleet"]
        ck = P["Checkpointer"](os.path.join(tmp, "ckpt"), keep=1)
        _, r_save = op(lambda: ck.save(1, fitted, blocking=True))
        (restored, step), r_restore = op(lambda: ck.restore(fitted))
        mesh2 = P["elastic_mesh"](model=1, ranks=[0])
        axes = fl.tree_map(lambda t: ("tenant",) + (None,) * (t.ndim - 1),
                           restored)
        moved, r_move = op(lambda: P["reshard_tree"](restored, axes, mesh2))
        local = fl.tree_map(lambda t: t.to_local(), moved)
        xq = P["device_put"](data["Xq"], P["fleet_pspecs"](data["Xq"], mesh2,
                                                           T=T))
        mu2, r_mean2 = op(lambda: fl.fleet_posterior_mean(local,
                                                          xq.to_local()))
        var2, r_var2 = op(lambda: fl.fleet_posterior_var(local,
                                                         xq.to_local()))
        mu2, var2 = (DTensor.from_local(t, mesh2, xq.placements).full_tensor()
                     for t in (mu2, var2))
        same2 = (step == 1 and torch.equal(mu2, b["mu"])
                 and torch.equal(var2, b["var"]))
        print(f"substrate: restart on elastic_mesh(model=1, ranks=[0]) -> "
              f"{P['mesh_shape'](mesh2)}: Checkpointer.save "
              f"{r_save['ms']:.1f} ms, restore {r_restore['ms']:.1f} ms "
              f"(launches {r_restore['launches']}), reshard_tree "
              f"{r_move['ms']:.1f} ms, mean {r_mean2['ms']:.1f} ms, var "
              f"{r_var2['ms']:.1f} ms; queries bit for bit: {same2}",
              flush=True)
        if not same2:
            raise RuntimeError("substrate: the restored fleet's queries "
                               "differ")

        # -- 4. the decode engine and the sharded pipeline on the card -------
        eng = P["ServeEngine"](_DecodeStub(dev), params={}, par=None,
                               batch_slots=4, ctx=64, eos_id=-1)
        for rid in range(6):
            eng.submit(P["Request"](rid=rid, prompt=[1 + rid, 2, 3],
                                    max_new=5))
        t0 = time.perf_counter()
        done = eng.run_until_done(max_ticks=200)
        t_serve = (time.perf_counter() - t0) * 1e3
        serve_ok = (eng.device.type == dev.type and len(done) == 6
                    and all(len(r.out) == 5 and r.out[:2] == [4, 5]
                            for r in done))
        ab = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
        it = P["ShardedBatches"](100, 16, 8, seed=3,
                                 sharding=P["batch_pspecs"](ab, mesh))
        b3 = [next(it) for _ in range(4)][3]
        c3 = next(P["ShardedBatches"](100, 16, 8, seed=3, start_step=3,
                                      device="cpu"))
        batch_ok = all(
            b3[k].to_local().device.type == dev.type
            and torch.equal(b3[k].to_local().cpu(), c3[k]) for k in c3)
        print(f"substrate: ServeEngine on {eng.device} (greedy stub, 6 "
              f"requests in 4 slots): {len(done)} done in "
              f"{int(eng.pos.max())} ticks, {t_serve:.1f} ms, outputs as "
              f"the reference's test expects: {serve_ok}; ShardedBatches on "
              f"the mesh, batch 3 equal to the CPU's: {batch_ok}",
              flush=True)
        if not (serve_ok and batch_ok):
            raise RuntimeError("substrate: engine or pipeline on the card "
                               "differs")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if env_old is None:
            os.environ.pop("NCCL_SOCKET_IFNAME", None)
        else:
            os.environ["NCCL_SOCKET_IFNAME"] = env_old
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"substrate phase: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {({k: v for k, v in total.items() if v})}", flush=True)
    return total


def single_bits_phase():
    """Every single-GP output that ``scripts/single_bits.py`` records (71
    outputs of the paths this script drives for one GP) against the
    digests of the tree before the tenant axis
    (``scripts/single_bits_ref.json``), bit for bit: the fleet's tenant
    axis must leave every single-GP path where it was."""
    import single_bits

    root = Path(__file__).resolve().parent
    ref = json.loads((root / "scripts" / "single_bits_ref.json").read_text())
    got = single_bits.digests(str(root / "src"), quiet=True)
    bad = sorted(k for k in ref.keys() | got.keys()
                 if ref.get(k) != got.get(k))
    print(f"single-GP outputs vs the tree before the tenant axis "
          f"(scripts/single_bits_ref.json): {len(ref) - len(bad)} of "
          f"{len(ref)} bitwise" + (f"; differ: {bad}" if bad else ""),
          flush=True)
    if bad:
        raise RuntimeError(f"single-GP outputs moved: {bad}")


def _jittered(rng, n, D, spacing=0.1):
    """(n, D) points, each column a shuffled jittered grid whose spacing is
    ``spacing`` / omega at omega = 4, and the grid's span. At q >= 1 the KP
    systems of clustered points are ill-conditioned enough that PCG
    amplifies rounding chaotically (ROADMAP Queue 3); these stay well
    conditioned (at q = 3 from spacing 0.2: at 0.1 cond(H = A Phi^T)
    reaches ~3e10, and two exact float64 algorithms, RGF and a dense
    inverse, give variances 2e-6 apart)."""
    span = spacing * n / 4.0
    cols = [rng.permutation((np.arange(n) + 0.5 + 0.3 * rng.uniform(-1, 1, n))
                            * span / n) for _ in range(D)]
    return np.stack(cols, axis=1), span


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
    # the CPU side of section 3 starts now, in worker processes, and runs
    # while the card works; the card side keeps two threads
    torch.set_num_threads(2)
    refs = _Refs()
    try:
        _card_main(P, refs)
    finally:
        refs.close()


def _card_main(P, refs):
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
    for src, kernels, arg in (("rgf.cu", "tile_fwd|top|tile_bwd", "W"),
                              ("kp_gram.cu", "kp_gram", "q"),
                              ("mega_pcg.cu", "mega_pcg", "PIVOT, MAXW"),
                              ("jacobi.cu", "jacobi", "PIVOT, MAXW"),
                              ("gauss_seidel.cu", "gs", "PIVOT, MAXW"),
                              ("banded_lu_pivot.cu", "lu_pivot", "L, L")):
        print(f"ptxas {src} ({arg}, kernel, registers, spill stores, spill "
              "loads): " + "; ".join(
                  f"{w} {k} {r} {st} {ld}"
                  for w, k, r, st, ld in _ptxas(_build, src, kernels)),
              flush=True)

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
    ops_q1 = _operands(P, _jittered(rng, N_Q1, D)[0], np.full(D, 4.0), sigma,
                       1, dev)
    rows = kernel_phase(P, rng, dev, (D, n, B), ops_path, ops_q1)
    _stamp("kernel phase")
    rows += relax_kernel_phase(P, rng, dev, ops_path, ops_q1, iters=40)
    _stamp("relaxation kernel phase")
    del ops_q1
    ops_q1 = _operands(P, _jittered(rng, n, D)[0], np.full(D, 4.0), sigma, 1,
                       dev)
    rows += pcg_iter_kernel_phase(P, rng, dev, ops_path, ops_q1)
    del ops_path, ops_q1
    rows += kp_gram_phase(P, rng, dev)
    _stamp("per-iteration PCG and kp_gram kernel phase")
    rows += w4_kernel_phase(P, dev)
    rows += wide_cr_rows(P, np.random.default_rng(22), dev)
    _stamp("W = 4 and wide block-CR kernel phase")

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
    _require_launched("serving path", counts, SERVING_KERNELS)
    variance_band_phase(P, gp)

    # --- learning path on the same fitted GP and data ---------------------
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    (ll, ll_v), t_ll = _sync_time(
        lambda: P["log_likelihood"](gp, gen, return_verdict=True))
    (g_om, g_sg, g_info), t_grad = _sync_time(
        lambda: P["mll_gradients"](gp, gen, return_info=True))
    (hgp, (om_fit, sg_fit), norms), t_hyp = _sync_time(
        lambda: P["fit_hyperparams"](cfg, X, Y, omega, sigma, gen, steps=3))
    counts_l = _build.launch_counts()
    peak_l = torch.cuda.max_memory_allocated()
    verdicts = {k: P["verdict_name"](v) for k, v in (
        ("log_likelihood", ll_v), ("mll_gradients", g_info.verdict),
        ("fit_hyperparams fit", hgp.health.verdict))}
    print(f"learning path n={n} D={D} q=0 iters=40 probes={Q_PATH}: "
          f"log_likelihood {t_ll * 1e3:.1f} ms (value {float(ll):.6f}), "
          f"mll_gradients {t_grad * 1e3:.1f} ms, fit_hyperparams(3) "
          f"{t_hyp * 1e3:.1f} ms (grad norms {norms}); verdicts {verdicts}; "
          f"peak memory {peak_l / 2**20:.1f} MiB; launches {counts_l}",
          flush=True)
    values = torch.cat([ll.reshape(1), g_om, g_sg.reshape(1), om_fit,
                        sg_fit.reshape(1)]).cpu()
    if not (bool(torch.isfinite(values).all())
            and np.isfinite(norms).all() and g_om.shape == (D,)
            and all(v == "OK" for v in verdicts.values())):
        raise RuntimeError("learning path output is not finite/OK")
    _require_launched("learning path", counts_l, LEARNING_KERNELS)
    _stamp("serving and learning paths")

    # --- the relaxation solvers on the same data: Gauss-Seidel (the paper's
    # Algorithm 4) and damped Jacobi, each with the whole-solve kernels
    # (fused="auto" -> "whole") and with one launch per sweep ("on") -------
    relax_counts = []
    for solver in ("gauss_seidel", "jacobi"):
        for fused in ("auto", "on"):
            rcfg = P["GPConfig"](q=0, solver=solver, solver_iters=40,
                                 precond="none", fused=fused)
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            rgp, t_f = _sync_time(lambda: P["fit"](rcfg, X, Y, omega, sigma))
            rmu, t_m = _sync_time(lambda: P["posterior_mean"](rgp, Xq))
            rvar, t_v = _sync_time(lambda: P["posterior_var"](rgp, Xq[:B]))
            rc = _build.launch_counts()
            relax_counts.append(rc)
            rpeak = torch.cuda.max_memory_allocated()
            h = rgp.health
            verdict = P["verdict_name"](h.verdict)
            rres = float(h.resid) / float(h.rhs)
            rmu_np, rvar_np = rmu.cpu().numpy(), rvar.cpu().numpy()
            rrmse = float(np.sqrt(np.mean((rmu_np - f(Xq)) ** 2)))
            print(f"relaxation path {solver} fused={fused} "
                  f"(-> {rgp.config.fused}) n={n} D={D} q=0 iters=40: fit "
                  f"{t_f * 1e3:.1f} ms, posterior_mean(100) {t_m * 1e3:.1f} "
                  f"ms, posterior_var({B}) {t_v * 1e3:.1f} ms; RMSE "
                  f"{rrmse:.4f}; fit solve verdict {verdict}, residual "
                  f"|v - Mhat x| / |v| {rres:.3e}; peak memory "
                  f"{rpeak / 2**20:.1f} MiB; launches {rc}", flush=True)
            if not (rmu_np.shape == (100,) and rvar_np.shape == (B,)
                    and np.isfinite(rmu_np).all()
                    and np.isfinite(rvar_np).all()
                    and verdict in ("OK", "STALLED")):
                raise RuntimeError(f"relaxation path {solver} {fused}: not "
                                   "finite, or diverged")
            sweep = ("mega_" if fused == "auto" else "fused_") + solver + (
                "" if fused == "auto" else "_iter")
            # both solve from SAPhi's factor, which the fit's DimOps makes
            # (one cr_factor launch) and every solve's FusedSweep takes
            need = ("banded_lu", "band_matmul", "rgf_blocks", sweep,
                    "cr_factor")
            print(f"relaxation path {solver} fused={fused}: "
                  f"{rc['cr_factor']} cr_factor launches for "
                  f"{rc[sweep]} {sweep} launches", flush=True)
            _require_launched(f"relaxation path {solver} {fused}", rc, need)
    _stamp("relaxation paths")

    # --- Algorithm 2's Gram assembly through the kernels layer's public op
    # (ops.kp_gram; no core module calls it) on the main path's factors ----
    _build.reset_launch_counts()
    for d in range(D):
        phi_d = P["kops"].kp_gram(0, float(omega[d]), gp.xs[d].contiguous(),
                                  gp.ops.A.data[d].contiguous())
        terms = float(gp.ops.A.data[d].abs().sum(-1).max())
        gap = float((phi_d - gp.ops.Phi.data[d]).abs().max()) / terms
        if not gap <= 1e-12:
            raise RuntimeError(f"ops.kp_gram dim {d}: {gap:.3e} of the "
                               "terms' scale from the fit's Phi")
    counts_k = _build.launch_counts()
    print(f"kernels layer: ops.kp_gram over the {D} dimensions of the main "
          f"path's factors, within 1e-12 of the terms' scale of the fit's "
          f"Phi; launches {counts_k}", flush=True)
    _require_launched("kernels layer", counts_k, ("kp_gram",))

    # --- the reference's default configuration at the same point:
    # GPConfig(q=0), precond "auto" -> kmg, fused -> "off", 50 iterations --
    dcfg = P["GPConfig"](q=0)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    gen_d = torch.Generator().manual_seed(3)
    dgp, td_fit = _sync_time(lambda: P["fit"](dcfg, X, Y, omega, sigma))
    dmu, td_mean = _sync_time(lambda: P["posterior_mean"](dgp, Xq))
    dvar, td_var = _sync_time(lambda: P["posterior_var"](dgp, Xq))
    (dll, dll_v), td_ll = _sync_time(
        lambda: P["log_likelihood"](dgp, gen_d, return_verdict=True))
    (dg_om, dg_sg, dinfo), td_grad = _sync_time(
        lambda: P["mll_gradients"](dgp, gen_d, return_info=True))
    counts_d = _build.launch_counts()
    peak_d = torch.cuda.max_memory_allocated()
    dmu_np, dvar_np = dmu.cpu().numpy(), dvar.cpu().numpy()
    dverdicts = {k: P["verdict_name"](v) for k, v in (
        ("fit", dgp.health.verdict), ("log_likelihood", dll_v),
        ("mll_gradients", dinfo.verdict))}
    print(f"default config GPConfig(q=0) n={n} D={D}: precond "
          f"{dgp.config.precond}, fused {dgp.config.fused}, iterations "
          f"{dgp.config.solver_iters} (realized {int(dinfo.iters)}), "
          f"levels {[lv.stride for lv in dgp.hier]}: fit {td_fit * 1e3:.1f} "
          f"ms, posterior_mean(100) {td_mean * 1e3:.1f} ms, "
          f"posterior_var(100) {td_var * 1e3:.1f} ms, log_likelihood "
          f"{td_ll * 1e3:.1f} ms (value {float(dll):.6f}), mll_gradients "
          f"{td_grad * 1e3:.1f} ms; RMSE "
          f"{float(np.sqrt(np.mean((dmu_np - f(Xq)) ** 2))):.4f}; fit solve "
          f"residual {float(dgp.health.resid / dgp.health.rhs):.3e}; "
          f"verdicts {dverdicts}; peak memory {peak_d / 2**20:.1f} MiB; "
          f"launches {counts_d}", flush=True)
    dvals = torch.cat([dll.reshape(1), dg_om, dg_sg.reshape(1)]).cpu()
    if not (dgp.config.precond == "kmg" and dgp.config.fused == "off"
            and np.isfinite(dmu_np).all() and np.isfinite(dvar_np).all()
            and (dvar_np > 0).all() and bool(torch.isfinite(dvals).all())
            and all(v in ("OK", "STALLED") for v in dverdicts.values())):
        raise RuntimeError("default-config path: not kmg/off, not finite, "
                           "or diverged")
    _require_launched("default-config path", counts_d,
                      ("banded_lu", "band_matmul", "rgf_blocks", "cr_factor",
                       "cr_apply", "banded_matvec"))
    if counts_d["mega_pcg"] or counts_d["fused_pcg_iter"]:
        raise RuntimeError("the kmg path ran a fused PCG kernel")
    # where its time goes: a torch.profiler trace of one variance chunk
    # (scripts/path_trace.py's trace_call; device ms by kernel group, idle
    # share = 1 - device / wall on the one stream; the script also traces
    # the gradients and splits fit: that trace's ~110 k events took ~100 s
    # to read here, cut for the time limit)
    for name, fn in ((f"posterior_var({B})",
                      lambda: P["posterior_var"](dgp, Xq[:B])),):
        t = P["trace_call"](fn)
        print(f"default-path trace {name}: wall {t['wall_ms']:.1f} ms "
              f"(traced {t['traced_wall_ms']:.1f}), device "
              f"{t['device_ms']:.1f} ms, idle {t['idle_share']:.3f}; "
              + ", ".join(f"{k} {v:.1f} ms/{t['launches'][k]}" for k, v in
                          sorted(t["groups"].items(), key=lambda kv: -kv[1])),
              flush=True)
        if not t["device_ms"] > 0:
            raise RuntimeError(f"the trace of {name} shows no device time")
    del dgp
    _stamp("default-config (kmg) path and its trace")
    kmg_convergence(P, dev)
    _stamp("kmg convergence")

    # --- PCG with one launch per iteration (fused="on"): fit and one
    # variance chunk; then "on" against "whole" bit for bit on the main
    # path's own operands, cold, warm and with tol --------------------------
    ocfg = P["GPConfig"](q=0, solver="pcg", solver_iters=40, precond="none",
                         fused="on")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    ogp, to_fit = _sync_time(lambda: P["fit"](ocfg, X, Y, omega, sigma))
    ovar, to_var = _sync_time(lambda: P["posterior_var"](ogp, Xq[:B]))
    counts_o = _build.launch_counts()
    peak_o = torch.cuda.max_memory_allocated()
    ovar_np = ovar.cpu().numpy()
    print(f"pcg fused=on path n={n} D={D} iters=40: fit {to_fit * 1e3:.1f} "
          f"ms, posterior_var({B}) {to_var * 1e3:.1f} ms; fit solve verdict "
          f"{P['verdict_name'](ogp.health.verdict)}; peak memory "
          f"{peak_o / 2**20:.1f} MiB; launches {counts_o}", flush=True)
    if not (np.isfinite(ovar_np).all() and (ovar_np > 0).all()
            and P["verdict_name"](ogp.health.verdict) == "OK"):
        raise RuntimeError("pcg fused=on path: not finite/positive/OK")
    _require_launched("pcg fused=on path", counts_o,
                      ("banded_lu", "band_matmul", "rgf_blocks",
                       "fused_pcg_iter", "cr_factor"))
    if counts_o["mega_pcg"]:
        raise RuntimeError("the fused='on' path ran the whole-solve kernel")
    del ogp
    vb = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (D, n, B)), device=dev)
    for warm, tol in ((False, 0.0), (False, 1e-6), (True, 1e-6)):
        res = {}
        for fz in ("whole", "on"):
            _build.reset_launch_counts()
            res[fz] = _sync_time(lambda: P["solve_mhat"](
                gp.ops, vb, P["SolveConfig"](iters=40, tol=tol, fused=fz),
                x0=0.5 * vb if warm else None, return_info=True))
            res[fz + " launches"] = _build.launch_counts()["fused_pcg_iter"]
        ((xw, iw), tw), ((xo, io), t_on) = res["whole"], res["on"]
        same = (torch.equal(xw, xo) and torch.equal(iw.resid, io.resid)
                and int(iw.iters) == int(io.iters))
        nl = res["on launches"]
        print(f"pcg on == whole (n={n} D={D} B={B}, warm={warm}, tol={tol}):"
              f" bitwise {same}; {int(io.iters)} iterations; whole "
              f"{tw * 1e3:.1f} ms, on {t_on * 1e3:.1f} ms in {nl} launches: "
              f"{(t_on - tw) / nl * 1e3:.3f} ms more a launch", flush=True)
        if not same or nl != int(io.iters) + 1:
            raise RuntimeError("pcg fused='on' and 'whole' differ")
    # a tol-exit solve of 300 > MAX_B columns: its two column chunks run in
    # lockstep under the one exit (a seed and one per-iteration launch per
    # chunk and iteration), against the plain PCG over all 300 columns on
    # the same CUDA tensors: the same iterations, x within mega_pcg's bar
    fs = P["FusedSweep"](gp.ops.Phi.data, gp.ops.SAPhi.data, gp.ops.sort_idx,
                         gp.ops.rank_idx, gp.ops.sigma2, w_p=gp.ops.Phi.lo,
                         w_s=gp.ops.SAPhi.lo, a=gp.ops.A.data,
                         w_a=gp.ops.A.lo)
    v300 = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (D, n, 300)), device=dev)
    _build.reset_launch_counts()
    (x3, _, it3), t3 = _sync_time(lambda: P["MegaSolve"](fs).pcg(
        v300, None, iters=40, tol=1e-6))
    counts_t = _build.launch_counts()
    v3p = fs.pad_state(v300)
    xp3, _, itp3 = P["mega_pcg_plain"](
        fs.a, fs.phi, fs.saphi, fs.sort_idx, fs.rank_idx, fs.sigma2, v3p,
        torch.zeros_like(v3p), w_a=fs.w_a, w_p=fs.w_p, w_s=fs.w_s, iters=40,
        tol=1e-6)
    _, rel3 = _errs(x3, fs.unpad(xp3))
    print(f"tol-exit pcg B=300 (n={n} D={D}, tol 1e-6): {int(it3)} "
          f"iterations (plain {int(itp3)}), x max rel vs plain {rel3:.3e} "
          f"(tol 1e-7), {t3 * 1e3:.1f} ms; launches {counts_t}", flush=True)
    if not (int(it3) == int(itp3) < 40 and rel3 < 1e-7
            and counts_t["fused_pcg_iter"] == 2 * (int(it3) + 1)
            and counts_t["mega_pcg"] == 0):
        raise RuntimeError("tol-exit pcg over 300 columns differs from the "
                           "plain version")
    del fs, v300, v3p, xp3, x3
    _stamp("pcg fused=on path and tol-exit over 300 columns")

    # --- Bayesian optimisation (Sec. 6) on the main path's GP ------------
    counts_bo = bo_phase(P, gp, bounds, Xq, lambda x: float(f(x)[0]), dev)
    _stamp("Bayesian optimisation path")

    # --- streaming (Sec. 6): capacity padding, insert / evict, the serving
    # engine and BO's default loop, at the same point ----------------------
    counts_s = dict.fromkeys(_build.KERNELS, 0)
    rs = np.random.default_rng(11)
    Xn = rs.uniform(bounds[:, 0], bounds[:, 1], (N_MUT, D))
    Yn = f(Xn) + rs.standard_normal(N_MUT)
    padded_parity(P, cfg, X, Y, omega, sigma, Xq)
    for tag, scfg in (("pcg whole", cfg), ("default GPConfig(q=0)",
                                            P["GPConfig"](q=0))):
        stream_phase(P, tag, scfg, X, Y, Xn, Yn, omega, sigma, Xq, counts_s,
                     STREAM_BARS["pcg" if tag == "pcg whole" else "kmg"])
        _stamp(f"stream {tag}")
    mutation_paths(P, X, Y, Xn, Yn, omega, sigma, Xq, dev, counts_s)
    _stamp("stream: relaxation solvers, q = 3 and jittered q = 0")
    engine_phase(P, gp, X, Y, Xn, Yn, bounds, Xq, counts_s)
    bo_default_phase(P, gp, lambda x: float(f(x)[0]), bounds, dev, counts_s)
    _stamp("stream: engine and the default BO loop")

    # --- q = 3 (Matern-7/2) at the main size on a jittered grid (omega = 4:
    # on the Schwefel points the q = 3 KP windows are ill-conditioned,
    # ROADMAP Queue 3): unfused ("off"; block CR at w = 3, 4, 5, the factors
    # held by the GP; rgf at w = 7), then pcg "whole" and "on" (the
    # half-width-4 instantiation of mega_pcg.cu) and the relaxation solvers
    # "whole" and "on" (jacobi.cu, gauss_seidel.cu), each "on" equal to its
    # "whole" bit for bit --------------------------------------------------
    r3 = np.random.default_rng(7)
    X3, span3 = _jittered(r3, n, D)
    Y3 = np.sin(X3 * 6.0 * np.pi / span3).sum(1) + 0.1 * r3.standard_normal(n)
    Xq3 = r3.uniform(0.0, span3, (100, D))
    counts_3 = []
    out3 = {}
    for solver, fused in (("pcg", "off"), ("pcg", "whole"), ("pcg", "on"),
                          ("gauss_seidel", "whole"), ("gauss_seidel", "on"),
                          ("jacobi", "whole"), ("jacobi", "on")):
        q3cfg = P["GPConfig"](q=3, solver=solver, solver_iters=40,
                              precond="none", fused=fused)
        pcg = solver == "pcg"
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        g3, t3f = _sync_time(lambda: P["fit"](q3cfg, X3, Y3,
                                              np.full(D, 4.0), sigma))
        mu3, t3m = _sync_time(lambda: P["posterior_mean"](g3, Xq3))
        var3, t3v = _sync_time(lambda: P["posterior_var"](g3, Xq3[:B]))
        ll3, t3l = (_sync_time(lambda: P["log_likelihood"](
            g3, torch.Generator().manual_seed(4))) if pcg
            else (torch.zeros(()), 0.0))
        c3 = _build.launch_counts()
        counts_3.append(c3)
        peak_3 = torch.cuda.max_memory_allocated()
        vals3 = torch.cat([mu3, var3, ll3.reshape(1).to(dev)]).cpu()
        verdict3 = P["verdict_name"](g3.health.verdict)
        ll_txt = (f", log_likelihood {t3l * 1e3:.1f} ms (value "
                  f"{float(ll3):.6f})" if pcg else "")
        print(f"q=3 path (jittered grid) {solver} n={n} D={D} iters=40: "
              f"fused {g3.config.fused}, fit "
              f"{t3f * 1e3:.1f} ms, posterior_mean(100) {t3m * 1e3:.1f} ms, "
              f"posterior_var({B}) {t3v * 1e3:.1f} ms{ll_txt}; fit solve "
              f"verdict {verdict3}; peak memory "
              f"{peak_3 / 2**20:.1f} MiB; launches {c3}", flush=True)
        if not (g3.config.fused == fused and bool(torch.isfinite(vals3).all())
                and bool((var3 > 0).all())
                and verdict3 in ("OK", "STALLED")):
            raise RuntimeError(f"q = 3 path {solver} {fused}: not "
                               "finite/positive, or diverged")
        need = ["band_matmul", "rgf_blocks", "cr_factor"]
        if fused == "off":
            need += ["cr_apply", "banded_matvec"]
            if c3["mega_pcg"] or c3["mega_pcg_w4"]:
                raise RuntimeError("the q = 3 'off' path ran a fused kernel")
        else:
            need.append(("mega_" if fused == "whole" else "fused_") + solver
                        + ("_iter" if fused == "on" else "") + "_w4")
        _require_launched(f"q = 3 path {solver} {fused}", c3, need)
        out3[solver, fused] = (g3.u_sy, g3.bY, mu3, var3, ll3)
        del g3
    for solver in ("pcg", "gauss_seidel", "jacobi"):
        same = all(torch.equal(a, b) for a, b in zip(out3[solver, "whole"],
                                                     out3[solver, "on"]))
        print(f"q=3 {solver} on == whole (fit caches, mean, variance"
              f"{', log-likelihood' if solver == 'pcg' else ''}): bitwise "
              f"{same}", flush=True)
        if not same:
            raise RuntimeError(f"q = 3 {solver}: 'on' and 'whole' differ")
    gap = _errs(out3["pcg", "whole"][2], out3["pcg", "off"][2])[1]
    print(f"q=3 pcg mean, whole vs off: max rel {gap:.3e} (not a gate: "
          "both stop after 40 iterations)", flush=True)
    del out3
    _stamp("q = 3 path")

    # --- the fleet: T GPs on a leading tenant axis (core.fleet, the masked
    # mutations, GPFleetEngine), the tenant-axis PCG kernel ---------------
    fleet_rows, counts_f, small = fleet_phase(P, dev)
    rows += fleet_rows
    _require_launched("fleet path", counts_f, tuple(FLEET_KERNELS))
    # --- the fleet's other solvers: the relaxation kernels' tenant axis,
    # fused="off" and kmg fleets, fleet_fit(GPConfig()) ---------------------
    solver_rows, counts_fs = fleet_solvers_phase(P, dev, refs)
    rows += solver_rows
    _require_launched("fleet solvers path", counts_fs,
                      tuple(FLEET_RELAX_KERNELS))
    # --- the health ladder: injected faults repaired on the card, the
    # engines' repair and quarantine, a checkpoint round trip --------------
    counts_h = health_phase(P, dev, gp, X, Y, omega, sigma, Xq, bounds,
                            small)
    del small
    # --- the pivoted LU route: GPConfig(pivot=True, solve_alg="lu") at the
    # main path's point, and the pivoted banded LU kernel's rows ----------
    pivot_rows, counts_p = pivot_lu_phase(P, dev, X, Y, omega, sigma, Xq, f)
    rows += pivot_rows
    _stamp("pivoted LU route")
    # --- the substrate: the fleet on a one-rank NCCL DeviceMesh, the
    # elastic restart, the decode engine and the sharded pipeline ---------
    counts_sub = substrate_phase(P, dev)
    _stamp("substrate")

    all_counts = [counts, counts_l, *relax_counts, counts_k, counts_d,
                  counts_o, counts_t, counts_bo, counts_s, *counts_3,
                  counts_f, counts_fs, counts_h, counts_p, counts_sub]
    for row in rows:
        row["launches"] = sum(c[row["name"]] for c in all_counts)

    # --- consistency (section 3): the card against the plain CPU port; the
    # CPU side came from the worker processes started at the top ---------
    consistency(P, dev, refs)
    single_bits_phase()
    _stamp("single-GP outputs against the reference digests")

    if sorted(r["name"] for r in rows) != sorted(_build.KERNELS):
        raise RuntimeError("the kernels line must list each kernel once")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
