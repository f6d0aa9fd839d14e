// Damped block-Jacobi backfitting: one sweep, or the whole solve, per
// launch, float64.
//
// Replaces: src/repro/kernels/fused_sweep.py, fused_jacobi_iter_pallas
// (kernel body `_jacobi_kernel`), one sweep per launch (fused="on"), and
// src/repro/kernels/mega_solve.py, mega_jacobi_solve_pallas (body
// `_jacobi_solve_kernel`, warm k0 by `_khat_inv_dim`), the whole solve per
// launch (fused="auto"/"whole"). Per sweep, for every dimension d:
//   total = sum_d u_d                          (d = 0..D-1 in order)
//   r_d   = v_d - (total - u_d) / s^2
//   new_d = s^2 gather_rank(SAPhi_d^{-1} Phi_d gather_sort(r_d))
//   u_d  <- (1 - alpha) u_d + alpha new_d
//   k_d  <- (1 - alpha) k_d + alpha (r_d - new_d / s^2)     (when k is kept)
// k carries Khat_d^{-1} u_d, from which the caller forms the exit residual
// with no extra matvec; a warm whole solve seeds it with
// k0 = (gather_rank(Phi^{-1} SAPhi gather_sort(x0)) - x0) / s^2.
//
// What bounds it on the H100: the SAPhi solve of each sweep, a latency
// chain of ceil(log2 nb) levels each way per (dimension, column chunk)
// item with a block barrier per level, and the passes over (D, npad, B)
// states: 77 MB each at the serving path's 10 x 30000 x 32, more than the
// 50 MB L2, so v, x and k stream from device memory every sweep. The TPU
// kernels keep the state in VMEM and carry the cross-dim total in scratch
// from grid step 0; here the state lives in device memory and each thread
// forms the total of its own rows.
//
// Design: one cooperative kernel for both entry points; the per-sweep
// launch (fused="on") is the whole-solve kernel run for one sweep with
// k taken from its input, so a host loop of sweeps and the whole solve
// execute the same machine code and agree bit for bit.
//   * SAPhi (and Phi, which a warm start solves with at w_p >= 1) does not
//     change during a solve, nor between the launches of one FusedSweep,
//     so its block-CR elimination is factored once by the caller
//     (cr_block_factor, block_cr.cu's factor launch) and each sweep only
//     replays the right-hand-side half of it from the factor (sweep.cuh
//     apply_cols: the elimination's own expressions in its order, so the
//     same bits), reading the factor with no scratch. The (dimension, chunk
//     of cpc columns) items of all D dimensions spread over the grid
//     (sweep.cuh auto_cols: the narrowest width whose items fit the grid).
//   * The solve's operand t1 holds each dimension in column chunks
//     (sweep.cuh chunk_col), so an item's rows are contiguous.
//   * The elementwise work is one phase between solves: each thread owns a
//     (row, column) pair over all D dimensions. It updates x and k from the
//     solved t1 (recomputing r from the sweep's total, kept per row in tp,
//     where k is kept), sums the next sweep's total in d order as it goes,
//     then forms the next sweep's r from it. At w_p = 0 (Phi diagonal,
//     q = 0) sorted row i of t1_d needs r_d at the one row sort_d[i], so
//     the same phase writes r_d's Phi product straight into t1_d at sorted
//     row rank_d[j] of its state row j: a location no other thread touches,
//     and the one it has just read the solved value from. So a sweep is
//     that phase and the apply, two grid barriers, and r is never stored;
//     at w_p >= 1 the phase stores r and the gathered Phi matvec is a
//     phase of its own (three barriers).
//   * A row takes the loads of DG dimensions at a time (each dimension's
//     rank, then its t1 element), so a thread has many independent loads
//     in flight at the grid's one block a SM; each dimension's arithmetic
//     keeps the expressions, and the total its d order, of the plain loop.
//   * The first sweep reads x_in and k_in in place of x and k, so a
//     one-sweep launch makes no copy pass.
//   * MAXW is the widest band: 3 (q <= 2), or 4 for q = 3's SAPhi, a
//     second instantiation so that the first keeps its machine code.
//   * The tenant axis: T independent systems of Dt dimensions each (a
//     fleet of GPs sharing one shape) in one launch, as mega_pcg.cu takes
//     them. Bands, factors, permutations and states are stacked over
//     (t Dt + d), so the gathered matvecs and the SAPhi solves are those of
//     one launch over T Dt dimensions, their (tenant, dimension, chunk)
//     items spread over the same grid; sigma2 is per tenant, alpha
//     fleet-wide, and the elementwise phase walks each tenant's rows in
//     turn, its total over that tenant's dimensions in d order. A tenant's
//     arithmetic is that of its own launch, so its bits are. One system is
//     the stack of T = 1.
#include <cooperative_groups.h>

#include "sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::make_map;
using repro::Map;

constexpr int NT = repro::SWEEP_NT;
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int ILP = repro::ROW_ILP;  // rows of the gathered matvec at a time
constexpr int DG = 5;  // dimensions of a row whose loads go out together

// how k starts: none kept, from k_in, zero, or Khat^{-1} x_in (warm)
enum KMode { K_NONE = 0, K_IN = 1, K_ZERO = 2, K_WARM = 3 };

// the launch's operands; SweepDims::D is T Dt (every tenant's dimensions)
struct Args : repro::SweepDims {
  const double* phi;
  const double* saphi;
  const double* fac_p;  // Phi's block-CR factor per dimension (warm, w_p > 0)
  const double* fac_s;  // SAPhi's block-CR factor per dimension
  const double* sigma2;  // (T)
  const double* v;
  const double* x_in;
  const double* k_in;
  double* x;
  double* k;
  double* r;   // r per element (w_p >= 1)
  double* t1;  // the solve operand, in column chunks of cpc
  double* tp;  // the sweep's total per (tenant, row, column) (w_p = 0, k kept)
  double alpha;
  int w_p, w_s, iters, kmode, cpc;
  int T, Dt;
};

template <bool PIVOT, int MAXW>
__global__ void __launch_bounds__(NT) jacobi_kernel(Args A) {
  cg::grid_group grid = cg::this_grid();
  const Map m = make_map(A.B);
  const int B = A.B, D = A.D, T = A.T, Dt = A.Dt;
  const long long npad = A.npad, per = npad * B;
  const double al = A.alpha;
  const bool fuse = A.w_p == 0;
  const bool keep_k = A.kmode != K_NONE;
  // this thread's column of t1: (d, i, m.b) at d per + tc + i tn
  int tn = 1;
  const long long tc = repro::chunk_col(m.b, A.npad, B, A.cpc, &tn);
  const auto t1_store = [&](long long row, double a) {
    const long long d = row / npad;
    A.t1[d * per + tc + (row - d * npad) * tn] = a;
  };

  // the next sweep's right-hand side of tenant t's state row j, from its
  // total and the state u: r stored (w_p >= 1), or its Phi product
  // 0 + phi r written to t1 at sorted row rank_d[j] (w_p = 0, as gather_mv
  // forms it)
  const auto next_rhs = [&](int t, long long j, double tot, const double* u) {
    const double s2 = A.sigma2[t];
    const int db = t * Dt;
    const long long e0 = j * B + m.b;
    if (fuse && keep_k) A.tp[t * per + e0] = tot;
    for (int d0 = 0; d0 < Dt; d0 += DG) {
      double vv[DG], uv[DG], ph[DG];
      long long ri[DG];
#pragma unroll
      for (int q = 0; q < DG; ++q) {
        const int d = db + d0 + q;
        if (d0 + q < Dt) {
          vv[q] = A.v[d * per + e0];
          uv[q] = u[d * per + e0];
          if (fuse) ri[q] = A.rank[d * npad + j];
        }
      }
      if (fuse) {
#pragma unroll
        for (int q = 0; q < DG; ++q)
          if (d0 + q < Dt) ph[q] = A.phi[(db + d0 + q) * npad + ri[q]];
      }
#pragma unroll
      for (int q = 0; q < DG; ++q) {
        const int d = db + d0 + q;
        if (d0 + q < Dt) {
          const double r = vv[q] - (tot - uv[q]) / s2;
          if (fuse) {
            double a = 0.0;
            a += ph[q] * r;
            A.t1[d * per + tc + ri[q] * tn] = a;
          } else {
            A.r[d * per + e0] = r;
          }
        }
      }
    }
  };

  if (A.kmode == K_WARM) {
    // k0 = Khat^{-1} x0 = (P^T Phi^{-1} SAPhi P x0 - x0) / s^2: the
    // gathered SAPhi matvec here, Phi's solve below (w_p >= 1 from its
    // factor; w_p = 0 a division in the start phase)
    repro::gather_mv_to<ILP>(A, m, A.x_in, A.saphi, A.w_s, 0, D, t1_store);
    grid.sync();
    if (!fuse) {
      repro::apply_cols<PIVOT, true, MAXW>(A, m, A.t1, A.phi, A.fac_p,
                                           A.w_p, 0, D, A.cpc);
      grid.sync();
    }
  }
  // start: the total of x_in per (tenant, row) and the first sweep's
  // right-hand side; k0 at a warm start; with no sweep, x = x_in and k as
  // kmode says
  for (int t = 0; t < T && m.on; ++t) {
    const double s2 = A.sigma2[t];
    for (long long j = m.r0; j < npad; j += m.rs) {
      const long long e0 = j * B + m.b;
      double tot = 0.0;
      for (int d = t * Dt; d < (t + 1) * Dt; ++d) {
        const long long e = d * per + e0;
        const double xv = A.x_in[e];
        tot += xv;
        if (A.kmode == K_WARM) {
          const long long i = A.rank[d * npad + j];
          double kw = A.t1[d * per + tc + i * tn];
          if (fuse) kw = kw / A.phi[d * npad + i];
          A.k[e] = (kw - xv) / s2;
        }
        if (A.iters == 0) {
          A.x[e] = xv;
          if (A.kmode == K_IN) A.k[e] = A.k_in[e];
          if (A.kmode == K_ZERO) A.k[e] = 0.0;
        }
      }
      if (A.iters > 0) next_rhs(t, j, tot, A.x_in);
    }
  }

  for (int it = 0; it < A.iters; ++it) {
    const bool more = it + 1 < A.iters;
    // the first sweep reads x_in and k_in (zero at K_ZERO; k0 at K_WARM)
    const double* xs = it == 0 ? A.x_in : A.x;
    const double* ks =
        it == 0 && A.kmode == K_IN ? A.k_in
        : it == 0 && A.kmode == K_ZERO ? nullptr : A.k;
    if (!fuse) {
      grid.sync();
      repro::gather_mv_to<ILP>(A, m, A.r, A.phi, A.w_p, 0, D, t1_store);
    }
    grid.sync();
    repro::apply_cols<PIVOT, true, MAXW>(A, m, A.t1, A.saphi, A.fac_s,
                                         A.w_s, 0, D, A.cpc);
    grid.sync();
    for (int t = 0; t < T && m.on; ++t) {
      const double s2 = A.sigma2[t];
      const int db = t * Dt;
      for (long long j = m.r0; j < npad; j += m.rs) {
        const long long e0 = j * B + m.b;
        const double to = fuse && keep_k ? A.tp[t * per + e0] : 0.0;
        double tot = 0.0;
        for (int d0 = 0; d0 < Dt; d0 += DG) {
          double xo[DG], ko[DG], rv[DG], tv[DG];
          long long ri[DG];
#pragma unroll
          for (int q = 0; q < DG; ++q) {
            const int d = db + d0 + q;
            if (d0 + q < Dt) {
              const long long e = d * per + e0;
              ri[q] = A.rank[d * npad + j];
              xo[q] = xs[e];
              if (keep_k) {
                ko[q] = ks ? ks[e] : 0.0;
                rv[q] = fuse ? A.v[e] : A.r[e];
              }
            }
          }
#pragma unroll
          for (int q = 0; q < DG; ++q)
            if (d0 + q < Dt)
              tv[q] = A.t1[(db + d0 + q) * per + tc + ri[q] * tn];
#pragma unroll
          for (int q = 0; q < DG; ++q) {
            const int d = db + d0 + q;
            if (d0 + q < Dt) {
              const long long e = d * per + e0;
              const double nw = s2 * tv[q];
              // each update's one multiply-add is written out (x folds
              // alpha new, k folds (1 - alpha) k), so its bits do not rest
              // on the compiler's choice
              const double xn = __fma_rn(al, nw, __dmul_rn(1.0 - al, xo[q]));
              A.x[e] = xn;
              if (keep_k) {
                const double r = fuse ? rv[q] - (to - xo[q]) / s2 : rv[q];
                A.k[e] = __fma_rn(1.0 - al, ko[q], __dmul_rn(al, r - nw / s2));
              }
              tot += xn;
            }
          }
        }
        if (more) next_rhs(t, j, tot, A.x);
      }
    }
  }
}

// f(kernel) for the instantiation of the pivot mode and the widest band
// (wide: w = 4)
template <typename F>
int with_kernel(int pivot, bool wide, F&& f) {
  if (wide)
    return pivot ? f(jacobi_kernel<true, 4>) : f(jacobi_kernel<false, 4>);
  return pivot ? f(jacobi_kernel<true, 3>) : f(jacobi_kernel<false, 3>);
}

int grid_size(int pivot, bool wide, int* grid) {
  return with_kernel(pivot, wide, [&](auto k) {
    return repro::cooperative_blocks(k, MAX_BLOCKS_PER_SM, grid);
  });
}

}  // namespace

// float64 workspace entries of a launch over T systems of D dimensions: r,
// t1 and the per-tenant total
extern "C" long long repro_jacobi_workspace(int T, int D, int npad, int B) {
  return 2LL * T * D * npad * B + (long long)T * npad * B;
}

// Blocks of the cooperative grid (negative: -error) of the instantiation
// for the widest band maxw; the same for every T, so a tenant's items and
// rows are walked as in its own launch.
extern "C" int repro_jacobi_grid(int pivot, int maxw) {
  int grid = 0;
  const int err = grid_size(pivot, maxw > 3, &grid);
  return err ? -err : grid;
}

// Columns per solve item that a launch with cpc = 0 takes (negative:
// -error): sweep.cuh auto_cols over the T D dimensions' items.
extern "C" int repro_jacobi_cols(int T, int D, int B, int pivot, int maxw) {
  int grid = 0;
  const int err = grid_size(pivot, maxw > 3, &grid);
  return err ? -err : repro::auto_cols(T * D, B, grid);
}

// T systems of D dimensions each: bands, factors, permutations and states
// stacked over (t D + d), sigma2 (T); T B <= MAX_TB. x_in (T, D, npad, B)
// the start; k_in the carried k (kmode 1); x, k the outputs (k unused at
// kmode 0); `iters` sweeps; alpha the damping. fac_s holds SAPhi's T D
// block-CR factors, fac_p (read only by a warm start at w_p >= 1) Phi's
// (block_cr.cu repro_cr_factor_f64, in the launch's pivot mode); cpc is the
// number of columns each solve item takes (0: chosen by auto_cols). Bands
// of half-width up to 4; a launch with one of 4 runs the wide
// instantiation.
extern "C" int repro_jacobi_f64(const double* phi, const double* saphi,
                                const double* fac_p, const double* fac_s,
                                const int* sort, const int* rank,
                                const double* sigma2, const double* v,
                                const double* x_in, const double* k_in,
                                double* x, double* k, double* work, int T,
                                int D, int npad, int B, int w_p, int w_s,
                                int iters, int cpc, double alpha, int kmode,
                                int pivot, void* stream) {
  if (T < 1 || D < 1 || npad < 1 || B < 1 || B > NT ||
      (long long)T * B > repro::MAX_TB || w_p < 0 || w_s < 1 ||
      w_p > 4 || w_s > 4 || iters < 0 || cpc < 0 || kmode < K_NONE ||
      kmode > K_WARM || !fac_s || (kmode == K_WARM && w_p > 0 && !fac_p))
    return (int)cudaErrorInvalidValue;
  if ((w_p > 0 && npad % w_p) || npad % w_s) return (int)cudaErrorInvalidValue;
  const bool wide = w_p > 3 || w_s > 3;
  int grid = 0;
  const int err = grid_size(pivot, wide, &grid);
  if (err) return err;
  const long long N = (long long)T * D * npad * B;
  Args A;
  A.sort = sort; A.rank = rank; A.D = T * D; A.npad = npad; A.B = B;
  A.T = T; A.Dt = D;
  A.phi = phi; A.saphi = saphi; A.fac_p = fac_p; A.fac_s = fac_s;
  A.sigma2 = sigma2; A.v = v; A.x_in = x_in; A.k_in = k_in; A.x = x;
  A.k = k;
  A.r = work;
  A.t1 = A.r + N;
  A.tp = A.t1 + N;
  A.alpha = alpha;
  A.w_p = w_p; A.w_s = w_s; A.iters = iters; A.kmode = kmode;
  A.cpc = cpc == 0 ? repro::auto_cols(T * D, B, grid) : (cpc < B ? cpc : B);
  void* params[] = {&A};
  return with_kernel(pivot, wide, [&](auto k) {
    REPRO_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
        (const void*)k, dim3(grid), dim3(NT), params, 0,
        (cudaStream_t)stream));
    return (int)cudaGetLastError();
  });
}
