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
// What bounds it on the H100: the block-CR solve of each sweep (a chain of
// ceil(log2 nb) levels each way with a barrier per level) and the grid-wide
// barriers between phases; the bytes are a few passes over (D, npad, B)
// states per sweep. The TPU kernels keep the state in VMEM and carry the
// cross-dim total in scratch from grid step 0; here the state lives in
// device memory and the total is a phase before any dimension reads it.
//
// Design: one cooperative kernel for both entry points. The per-sweep
// launch (fused="on") is the whole-solve kernel run for one sweep with
// k taken from its input, so a host loop of sweeps and the whole solve
// execute the same machine code and agree bit for bit. Phases are separated
// by grid syncs: total and r (each thread owns a (row, column) pair over all
// dimensions), the gathered Phi matvec, the SAPhi solve, the update. The
// SAPhi solve spreads the (dimension, column chunk) items over the blocks
// (sweep.cuh solve_cols), each block with its own CR scratch.
#include <cooperative_groups.h>

#include "sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::gather_mv;
using repro::make_map;
using repro::Map;

constexpr int NT = repro::SWEEP_NT;
constexpr int MAX_BLOCKS_PER_SM = 2;

// how k starts: none kept, from k_in, zero, or Khat^{-1} x_in (warm)
enum KMode { K_NONE = 0, K_IN = 1, K_ZERO = 2, K_WARM = 3 };

struct Args : repro::SweepDims {
  const double* phi;
  const double* saphi;
  const double* sigma2;
  const double* v;
  const double* x_in;
  const double* k_in;
  double* x;
  double* k;
  double* r;
  double* t1;
  double* scratch;
  double alpha;
  long long sstride;  // CR scratch doubles per slot and array
  int w_p, w_s, iters, kmode, nslots;
};

template <bool PIVOT>
__global__ void __launch_bounds__(NT) jacobi_kernel(Args A) {
  cg::grid_group grid = cg::this_grid();
  const Map m = make_map(A.B);
  const int B = A.B, D = A.D;
  const long long rows = (long long)D * A.npad;
  const double s2 = *A.sigma2;
  const double al = A.alpha;

  if (m.on) {
    for (long long row = m.r0; row < rows; row += m.rs) {
      const long long e = row * B + m.b;
      A.x[e] = A.x_in[e];
      if (A.kmode == K_IN) A.k[e] = A.k_in[e];
      if (A.kmode == K_ZERO) A.k[e] = 0.0;
    }
  }
  if (A.kmode == K_WARM) {
    // k0 = Khat^{-1} x0 = (P^T Phi^{-1} SAPhi P x0 - x0) / s^2
    gather_mv(A, m, A.t1, A.x_in, A.saphi, A.w_s);
    grid.sync();
    repro::solve_cols<PIVOT>(A, m, A.t1, A.phi, A.w_p, 0, D, A.scratch,
                             A.sstride, A.nslots);
    grid.sync();
    if (m.on) {
      for (long long row = m.r0; row < rows; row += m.rs) {
        const int d = (int)(row / A.npad);
        const long long e = row * B + m.b;
        const double kw =
            A.t1[((long long)d * A.npad + A.rank[row]) * B + m.b];
        A.k[e] = (kw - A.x_in[e]) / s2;
      }
    }
  }

  for (int it = 0; it < A.iters; ++it) {
    grid.sync();
    // total over the dimensions, then every dimension's r off it
    if (m.on) {
      for (long long i = m.r0; i < A.npad; i += m.rs) {
        double tot = 0.0;
        for (int d = 0; d < D; ++d)
          tot += A.x[((long long)d * A.npad + i) * B + m.b];
        for (int d = 0; d < D; ++d) {
          const long long e = ((long long)d * A.npad + i) * B + m.b;
          A.r[e] = A.v[e] - (tot - A.x[e]) / s2;
        }
      }
    }
    grid.sync();
    gather_mv(A, m, A.t1, A.r, A.phi, A.w_p);
    grid.sync();
    repro::solve_cols<PIVOT>(A, m, A.t1, A.saphi, A.w_s, 0, D, A.scratch,
                             A.sstride, A.nslots);
    grid.sync();
    if (m.on) {
      for (long long row = m.r0; row < rows; row += m.rs) {
        const int d = (int)(row / A.npad);
        const long long e = row * B + m.b;
        const double nw =
            s2 * A.t1[((long long)d * A.npad + A.rank[row]) * B + m.b];
        A.x[e] = (1.0 - al) * A.x[e] + al * nw;
        if (A.kmode != K_NONE)
          A.k[e] = (1.0 - al) * A.k[e] + al * (A.r[e] - nw / s2);
      }
    }
  }
}

template <bool PIVOT>
int grid_blocks(int* out) {
  return repro::cooperative_blocks(jacobi_kernel<PIVOT>, MAX_BLOCKS_PER_SM,
                                   out);
}

int slots(int D, int B, int pivot, int* grid, int* nslots) {
  const int err = pivot ? grid_blocks<true>(grid) : grid_blocks<false>(grid);
  if (err) return err;
  const long long items = (long long)D * B;
  *nslots = items < *grid ? (int)items : *grid;
  return 0;
}

long long scratch_stride(int npad, int w_p, int w_s) {
  const int w = w_p > w_s ? w_p : w_s;
  return (long long)npad * (w > 1 ? w : 1);
}

}  // namespace

// float64 workspace entries of one launch: r, t1 and the CR scratch
// (negative: -error)
extern "C" long long repro_jacobi_workspace(int D, int npad, int B, int w_p,
                                            int w_s, int pivot) {
  int grid = 0, nslots = 0;
  const int err = slots(D, B, pivot, &grid, &nslots);
  if (err) return -(long long)err;
  return 2LL * D * npad * B + 3LL * nslots * scratch_stride(npad, w_p, w_s);
}

// x_in (D, npad, B) the start; k_in the carried k (kmode 1); x, k the
// outputs (k unused at kmode 0); `iters` sweeps; alpha the damping.
extern "C" int repro_jacobi_f64(const double* phi, const double* saphi,
                                const int* sort, const int* rank,
                                const double* sigma2, const double* v,
                                const double* x_in, const double* k_in,
                                double* x, double* k, double* work, int D,
                                int npad, int B, int w_p, int w_s, int iters,
                                double alpha, int kmode, int pivot,
                                void* stream) {
  if (D < 1 || npad < 1 || B < 1 || B > NT || w_p < 0 || w_s < 1 ||
      w_p > 3 || w_s > 3 || iters < 0 || kmode < K_NONE || kmode > K_WARM)
    return (int)cudaErrorInvalidValue;
  if ((w_p > 0 && npad % w_p) || npad % w_s) return (int)cudaErrorInvalidValue;
  int grid = 0, nslots = 0;
  const int err = slots(D, B, pivot, &grid, &nslots);
  if (err) return err;
  const long long N = (long long)D * npad * B;
  Args A;
  A.sort = sort; A.rank = rank; A.D = D; A.npad = npad; A.B = B;
  A.phi = phi; A.saphi = saphi; A.sigma2 = sigma2; A.v = v; A.x_in = x_in;
  A.k_in = k_in; A.x = x; A.k = k;
  A.r = work;
  A.t1 = A.r + N;
  A.scratch = A.t1 + N;
  A.alpha = alpha;
  A.sstride = scratch_stride(npad, w_p, w_s);
  A.w_p = w_p; A.w_s = w_s; A.iters = iters; A.kmode = kmode;
  A.nslots = nslots;
  void* params[] = {&A};
  const void* fn = pivot ? (const void*)jacobi_kernel<true>
                         : (const void*)jacobi_kernel<false>;
  REPRO_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(NT), params, 0, (cudaStream_t)stream));
  return (int)cudaGetLastError();
}
