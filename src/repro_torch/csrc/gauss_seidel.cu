// Block Gauss-Seidel backfitting (the paper's Algorithm 4): one sweep, or
// the whole solve, per launch, float64.
//
// Replaces: src/repro/kernels/fused_sweep.py,
// fused_gauss_seidel_iter_pallas (kernel body `_gs_kernel`), one sweep per
// launch (fused="on"), and src/repro/kernels/mega_solve.py,
// mega_gauss_seidel_solve_pallas (body `_gs_solve_kernel`), the whole solve
// per launch (fused="auto"/"whole"). Per sweep:
//   total = sum_d u_d                          (d = 0..D-1 in order)
//   for d = 0..D-1, in sequence:
//     r_d   = v_d - (total - u_d) / s^2
//     new_d = s^2 gather_rank(SAPhi_d^{-1} Phi_d gather_sort(r_d))
//     total = total - u_d + new_d              (the reference's order)
//     u_d   = new_d
//     k_d   = r_d - new_d / s^2                (final sweep, when kept)
// k = Khat^{-1} u is exact by the block solves of the final sweep, so the
// caller forms the exit residual with no extra matvec.
//
// What bounds it on the H100: the dimensions run in sequence, each a
// block-CR solve of one system between elementwise phases, with grid
// barriers between them; one system's solve is a latency chain of
// ceil(log2 nb) levels each way, a block barrier per level, which one
// block per column chunk walks. A sweep also streams a few passes over
// (D, npad, B) states: 77 MB each at the serving path's 10 x 30000 x 32,
// more than the 50 MB L2, so at least x read and written and v read from
// device memory every sweep.
//
// Design: one cooperative kernel for both entry points; the per-sweep
// launch (fused="on") is the whole-solve kernel run for one sweep, so
// a host loop of sweeps and the whole solve execute the same machine code
// and agree bit for bit.
//   * SAPhi does not change during a solve (nor between the launches of one
//     FusedSweep), so its block-CR elimination is factored once by the
//     caller (cr_block_factor, block_cr.cu's factor launch) and each
//     dimension step only replays the right-hand-side half of it from the
//     factor (sweep.cuh apply_cols: the elimination's own expressions in its
//     order, so the same bits), reading the factor with no scratch.
//     Gauss-Seidel multiplies by Phi and never solves with it, so SAPhi's
//     factor is the only one.
//   * Only one dimension is active per step, so the solve's items are
//     chunks of `cpc` of the B columns (sweep.cuh auto_cols with D = 1:
//     one column an item while B fits the grid), each on a block of its
//     own. The solve's operand t1 holds each dimension in column chunks
//     (sweep.cuh chunk_col), so an item's rows are contiguous: at one
//     column an item, its column is, where a row-major (npad, B) block
//     would give it 8 bytes of every 32-byte sector it reads.
//   * The update of dimension d and the residual of dimension d + 1 are
//     one phase: each thread owns a (row, column) pair of the running
//     total, ROW_ILP rows at a time. At w_p = 0 (Phi diagonal, q = 0) the
//     sorted row i of t1_{d+1} needs r_{d+1} at the one row sort[i], so
//     that phase also forms t1_{d+1}, its thread taking state row
//     sort[i] for sorted row i (the sweep's first phase does so for
//     t1_0): two grid barriers a dimension instead of three, and r is
//     stored only where the final sweep's k reads it.
//   * MAXW is the widest band: 3 (q <= 2), or 4 for q = 3's SAPhi, a
//     second instantiation so that the first keeps its machine code.
//   * The tenant axis: T independent systems of Dt dimensions each (a
//     fleet of GPs sharing one shape) in one launch, as mega_pcg.cu takes
//     them: bands, factors, permutations and states stacked over
//     (t Dt + d), sigma2 per tenant. The dimensions stay in sequence inside
//     a tenant, and the tenants step through them together: step d solves
//     dimension d of every tenant, its (tenant, column chunk) items spread
//     over the grid (sweep.cuh apply_cols with a dimension step of Dt), so
//     a fleet launch has T B columns to spread where one system has B. The
//     elementwise phases walk each tenant's rows in turn with a single
//     system's expressions, so a tenant's bits are those of its own
//     launch. One system is the stack of T = 1.
#include <cooperative_groups.h>

#include "sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::gather_mv;
using repro::make_map;
using repro::Map;

constexpr int NT = repro::SWEEP_NT;
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int ILP = repro::ROW_ILP;  // rows a thread takes at a time

// the launch's operands; SweepDims::D is T Dt (every tenant's dimensions)
struct Args : repro::SweepDims {
  const double* phi;
  const double* saphi;
  const double* sigma2;  // (T)
  const double* v;
  const double* x_in;
  double* x;
  double* k;  // nullptr: k not kept
  double* r;
  double* t1;
  double* tp;  // the running total per (tenant, row, column)
  const double* fac_s;  // SAPhi's block-CR factor per dimension
  int w_p, w_s, iters, cpc;
  int T, Dt;
};

template <bool PIVOT, int MAXW>
__global__ void __launch_bounds__(NT) gs_kernel(Args A) {
  cg::grid_group grid = cg::this_grid();
  const Map m = make_map(A.B);
  const int B = A.B, D = A.D, T = A.T, Dt = A.Dt;
  const long long npad = A.npad, per = npad * B;
  // this thread's column of t1, which holds each dimension in column
  // chunks of cpc (sweep.cuh chunk_col): (d, i, m.b) at d per + tc + i tn
  int tn = 1;
  const long long tc = repro::chunk_col(m.b, A.npad, B, A.cpc, &tn);
  // w_p = 0: Phi is diagonal, so t1_d's sorted row i reads r_d at the one
  // row j = sort_d[i] alone, and the phase that forms r_d can form t1_d:
  // its thread takes row j of the state for sorted row i (each j once)
  const bool fuse = A.w_p == 0;

  if (A.iters == 0) {
    if (m.on) {
      const long long rows = (long long)D * npad;
      for (long long row = m.r0; row < rows; row += m.rs) {
        const long long e = row * B + m.b;
        A.x[e] = A.x_in[e];
        if (A.k) A.k[e] = 0.0;
      }
    }
    return;
  }
  for (int it = 0; it < A.iters; ++it) {
    const bool last = it == A.iters - 1;
    // r is read again only by the next gather (w_p >= 1) or, in the
    // final sweep, for k
    const bool keep_r = !fuse || (A.k && last);
    const double* u = it == 0 ? A.x_in : A.x;
    if (it > 0) grid.sync();
    // each tenant's total over its dimensions and r_0 (the first sweep also
    // copies x_in); fused, also t1_0
    for (int t = 0; t < T && m.on; ++t) {
      const double s2 = A.sigma2[t];
      const long long b0 = (long long)t * Dt * npad;  // tenant's first row
      for (long long i = m.r0; i < npad; i += m.rs) {
        const long long j = fuse ? A.sort[b0 + i] : i;
        double tot = 0.0;
        for (int d = 0; d < Dt; ++d) {
          const long long e = (b0 + (long long)d * npad + j) * B + m.b;
          tot += u[e];
          if (it == 0) A.x[e] = u[e];
        }
        const long long e0 = (b0 + j) * B + m.b;
        A.tp[t * per + j * B + m.b] = tot;
        const double r0 = A.v[e0] - (tot - u[e0]) / s2;
        if (keep_r) A.r[e0] = r0;
        if (fuse) {
          double a = 0.0;
          a += A.phi[b0 + i] * r0;
          A.t1[t * Dt * per + tc + i * tn] = a;
        }
      }
    }
    for (int d = 0; d < Dt; ++d) {
      if (!fuse) {
        grid.sync();
        for (int t = 0; t < T; ++t) {
          const int dg = t * Dt + d;
          const long long base = (long long)dg * npad;
          repro::gather_mv_to<ILP>(
              A, m, A.r, A.phi, A.w_p, dg, dg + 1,
              [&](long long row, double a) {
                A.t1[dg * per + tc + (row - base) * tn] = a;
              });
        }
      }
      grid.sync();
      // dimension d of every tenant
      repro::apply_cols<PIVOT, true, MAXW>(A, m, A.t1, A.saphi, A.fac_s,
                                           A.w_s, d, D, A.cpc, Dt);
      grid.sync();
      // the update of dimension d and r of dimension d + 1 (fused, also
      // t1_{d+1}), tenant by tenant, ILP rows at a time (sweep.cuh
      // for_rows: the loads, then each row's arithmetic as a plain loop has
      // it); a row's stores touch no row another row loads
      for (int t = 0; t < T && m.on; ++t) {
        const double s2 = A.sigma2[t];
        const int dg = t * Dt + d;
        const long long base = (long long)dg * npad;
        const bool more = d + 1 < Dt, keep_k = A.k && last;
        const bool gather = fuse && more;
        const long long next = base + npad;
        double tv[ILP], tp[ILP], xd[ILP], rd[ILP], v1[ILP], x1[ILP], ph[ILP];
        long long jj[ILP];
        repro::for_rows<ILP>(
            m, 0, npad,
            [&](int u, long long i) {
              const long long j = gather ? A.sort[next + i] : i;
              const long long e = (base + j) * B + m.b;
              jj[u] = j;
              tv[u] = A.t1[dg * per + tc + A.rank[base + j] * tn];
              tp[u] = A.tp[t * per + j * B + m.b];
              xd[u] = A.x[e];
              if (keep_k) rd[u] = A.r[e];
              if (more) {
                v1[u] = A.v[e + per];
                x1[u] = A.x[e + per];
              }
              if (gather) ph[u] = A.phi[next + i];
            },
            [&](int u, long long i) {
              const long long e = (base + jj[u]) * B + m.b;
              const double nw = s2 * tv[u];
              const double tot = tp[u] - xd[u] + nw;
              A.tp[t * per + jj[u] * B + m.b] = tot;
              if (keep_k) A.k[e] = rd[u] - nw / s2;
              A.x[e] = nw;
              if (more) {
                const double r1 = v1[u] - (tot - x1[u]) / s2;
                if (keep_r) A.r[e + per] = r1;
                if (gather) {
                  double a = 0.0;
                  a += ph[u] * r1;
                  A.t1[(dg + 1) * per + tc + i * tn] = a;
                }
              }
            });
      }
    }
  }
}

// f(kernel) for the instantiation of the pivot mode and the widest band
// (wide: w = 4)
template <typename F>
int with_kernel(int pivot, bool wide, F&& f) {
  if (wide) return pivot ? f(gs_kernel<true, 4>) : f(gs_kernel<false, 4>);
  return pivot ? f(gs_kernel<true, 3>) : f(gs_kernel<false, 3>);
}

int grid_size(int pivot, bool wide, int* grid) {
  return with_kernel(pivot, wide, [&](auto k) {
    return repro::cooperative_blocks(k, MAX_BLOCKS_PER_SM, grid);
  });
}

}  // namespace

// float64 workspace entries of a launch over T systems of D dimensions: r,
// t1 and the per-tenant running total
extern "C" long long repro_gauss_seidel_workspace(int T, int D, int npad,
                                                  int B) {
  return 2LL * T * D * npad * B + (long long)T * npad * B;
}

// Blocks of the cooperative grid (negative: -error) of the instantiation
// for the widest band maxw; the same for every T, so a tenant's items and
// rows are walked as in its own launch.
extern "C" int repro_gauss_seidel_grid(int pivot, int maxw) {
  int grid = 0;
  const int err = grid_size(pivot, maxw > 3, &grid);
  return err ? -err : grid;
}

// Columns per solve item that a launch with cpc = 0 takes (negative:
// -error): sweep.cuh auto_cols for the active dimension of T tenants.
extern "C" int repro_gauss_seidel_cols(int T, int B, int pivot, int maxw) {
  int grid = 0;
  const int err = grid_size(pivot, maxw > 3, &grid);
  return err ? -err : repro::auto_cols(T, B, grid);
}

// T systems of D dimensions each: bands, factors, permutations and states
// stacked over (t D + d), sigma2 (T); T B <= MAX_TB. x_in (T, D, npad, B)
// the start; x the output; k (nullable) receives the final sweep's
// Khat^{-1} x (zeros when iters == 0); `iters` sweeps. fac_s holds SAPhi's
// T D block-CR factors (block_cr.cu repro_cr_factor_f64 of saphi, in the
// launch's pivot mode); cpc is the number of columns each solve item takes
// (0: chosen by auto_cols). Bands of half-width up to 4; a launch with one
// of 4 runs the wide instantiation.
extern "C" int repro_gauss_seidel_f64(const double* phi, const double* saphi,
                                      const double* fac_s, const int* sort,
                                      const int* rank, const double* sigma2,
                                      const double* v, const double* x_in,
                                      double* x, double* k, double* work,
                                      int T, int D, int npad, int B, int w_p,
                                      int w_s, int iters, int cpc, int pivot,
                                      void* stream) {
  if (T < 1 || D < 1 || npad < 1 || B < 1 || B > NT ||
      (long long)T * B > repro::MAX_TB || w_p < 0 || w_s < 1 ||
      w_p > 4 || w_s > 4 || iters < 0 || cpc < 0 || !fac_s)
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
  A.phi = phi; A.saphi = saphi; A.fac_s = fac_s; A.sigma2 = sigma2;
  A.v = v; A.x_in = x_in; A.x = x; A.k = k;
  A.r = work;
  A.t1 = A.r + N;
  A.tp = A.t1 + N;
  A.w_p = w_p; A.w_s = w_s; A.iters = iters;
  A.cpc = cpc == 0 ? repro::auto_cols(T, B, grid) : (cpc < B ? cpc : B);
  void* params[] = {&A};
  return with_kernel(pivot, wide, [&](auto k) {
    REPRO_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
        (const void*)k, dim3(grid), dim3(NT), params, 0,
        (cudaStream_t)stream));
    return (int)cudaGetLastError();
  });
}
