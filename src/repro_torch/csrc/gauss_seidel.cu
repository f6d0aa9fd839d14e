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
// gathered matvec, a block-CR solve of one system and an update, with grid
// barriers between them (three per dimension); one system's solve is a
// latency chain of ceil(log2 nb) levels each way. The bytes per sweep are a
// few passes over (D, npad, B) states.
//
// Design: one cooperative kernel for both entry points; the per-sweep
// launch (fused="on") is the whole-solve kernel run for one sweep, so
// a host loop of sweeps and the whole solve execute the same machine code
// and agree bit for bit. The active dimension's solve spreads its columns
// over the blocks (sweep.cuh solve_cols): every block recomputes the same
// block elimination on its own scratch and solves its columns, so one
// system occupies up to min(B, grid) SMs instead of one. The update of
// dimension d and the residual of dimension d + 1 are one phase: each thread
// owns a (row, column) pair of the running total.
#include <cooperative_groups.h>

#include "sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::gather_mv;
using repro::make_map;
using repro::Map;

constexpr int NT = repro::SWEEP_NT;
constexpr int MAX_BLOCKS_PER_SM = 2;

struct Args : repro::SweepDims {
  const double* phi;
  const double* saphi;
  const double* sigma2;
  const double* v;
  const double* x_in;
  double* x;
  double* k;  // nullptr: k not kept
  double* r;
  double* t1;
  double* tp;
  double* scratch;
  long long sstride;  // CR scratch doubles per slot and array
  int w_p, w_s, iters, nslots;
};

template <bool PIVOT>
__global__ void __launch_bounds__(NT) gs_kernel(Args A) {
  cg::grid_group grid = cg::this_grid();
  const Map m = make_map(A.B);
  const int B = A.B, D = A.D;
  const double s2 = *A.sigma2;

  if (A.iters == 0) {
    if (m.on) {
      const long long rows = (long long)D * A.npad;
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
    const double* u = it == 0 ? A.x_in : A.x;
    if (it > 0) grid.sync();
    // total over the dimensions and r_0 (the first sweep also copies x_in)
    if (m.on) {
      for (long long i = m.r0; i < A.npad; i += m.rs) {
        double tot = 0.0;
        for (int d = 0; d < D; ++d) {
          const long long e = ((long long)d * A.npad + i) * B + m.b;
          tot += u[e];
          if (it == 0) A.x[e] = u[e];
        }
        const long long e0 = i * B + m.b;
        A.tp[e0] = tot;
        A.r[e0] = A.v[e0] - (tot - u[e0]) / s2;
      }
    }
    for (int d = 0; d < D; ++d) {
      grid.sync();
      gather_mv(A, m, A.t1, A.r, A.phi, A.w_p, d, d + 1);
      grid.sync();
      repro::solve_cols<PIVOT>(A, m, A.t1, A.saphi, A.w_s, d, d + 1,
                               A.scratch, A.sstride, A.nslots);
      grid.sync();
      if (m.on) {
        const long long base = (long long)d * A.npad;
        for (long long i = m.r0; i < A.npad; i += m.rs) {
          const long long e = (base + i) * B + m.b;
          const long long t = i * B + m.b;
          const double nw = s2 * A.t1[(base + A.rank[base + i]) * B + m.b];
          const double tot = A.tp[t] - A.x[e] + nw;
          A.tp[t] = tot;
          if (A.k && last) A.k[e] = A.r[e] - nw / s2;
          A.x[e] = nw;
          if (d + 1 < D) {
            const long long e1 = e + (long long)A.npad * B;
            A.r[e1] = A.v[e1] - (tot - A.x[e1]) / s2;
          }
        }
      }
    }
  }
}

template <bool PIVOT>
int grid_blocks(int* out) {
  return repro::cooperative_blocks(gs_kernel<PIVOT>, MAX_BLOCKS_PER_SM, out);
}

int slots(int B, int pivot, int* grid, int* nslots) {
  const int err = pivot ? grid_blocks<true>(grid) : grid_blocks<false>(grid);
  if (err) return err;
  *nslots = B < *grid ? B : *grid;
  return 0;
}

}  // namespace

// float64 workspace entries of one launch: r, t1, the total and the CR
// scratch (negative: -error)
extern "C" long long repro_gauss_seidel_workspace(int D, int npad, int B,
                                                  int w_s, int pivot) {
  int grid = 0, nslots = 0;
  const int err = slots(B, pivot, &grid, &nslots);
  if (err) return -(long long)err;
  return 2LL * D * npad * B + (long long)npad * B +
         3LL * nslots * npad * w_s;
}

// x_in (D, npad, B) the start; x the output; k (nullable) receives the
// final sweep's Khat^{-1} x (zeros when iters == 0); `iters` sweeps.
extern "C" int repro_gauss_seidel_f64(const double* phi, const double* saphi,
                                      const int* sort, const int* rank,
                                      const double* sigma2, const double* v,
                                      const double* x_in, double* x,
                                      double* k, double* work, int D,
                                      int npad, int B, int w_p, int w_s,
                                      int iters, int pivot, void* stream) {
  if (D < 1 || npad < 1 || B < 1 || B > NT || w_p < 0 || w_s < 1 ||
      w_p > 3 || w_s > 3 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if ((w_p > 0 && npad % w_p) || npad % w_s) return (int)cudaErrorInvalidValue;
  int grid = 0, nslots = 0;
  const int err = slots(B, pivot, &grid, &nslots);
  if (err) return err;
  const long long N = (long long)D * npad * B;
  Args A;
  A.sort = sort; A.rank = rank; A.D = D; A.npad = npad; A.B = B;
  A.phi = phi; A.saphi = saphi; A.sigma2 = sigma2; A.v = v; A.x_in = x_in;
  A.x = x; A.k = k;
  A.r = work;
  A.t1 = A.r + N;
  A.tp = A.t1 + N;
  A.scratch = A.tp + (long long)npad * B;
  A.sstride = (long long)npad * w_s;
  A.w_p = w_p; A.w_s = w_s; A.iters = iters; A.nslots = nslots;
  void* params[] = {&A};
  const void* fn = pivot ? (const void*)gs_kernel<true>
                         : (const void*)gs_kernel<false>;
  REPRO_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(NT), params, 0, (cudaStream_t)stream));
  return (int)cudaGetLastError();
}
