// The whole preconditioned-CG backfitting solve in one launch, float64.
//
// Replaces: src/repro/kernels/mega_solve.py, mega_pcg_solve_pallas (kernel
// body `_pcg_solve_kernel`), which runs every Mhat solve of the serving
// path: the fit's mean cache (B = 1) and each 32-column chunk of the
// posterior variance.
//
// Per iteration, for every dimension d (the reference's op order):
//   Mhat p = gather_rank(Phi^{-1} A gather_sort(p)) + (sum_d p_d) / s^2
//   z      = s^2 gather_rank(SAPhi^{-1} Phi gather_sort(r))
// plus two inner products per RHS column over all D x npad rows, and the
// tol exit any_b |rz_b| > tol^2 |rz0_b| (tol = 0: exactly `iters`).
//
// What bounds it on the H100: bytes and grid-wide barriers. The TPU kernel
// keeps the whole (D, npad, B) state in VMEM; here one state array is
// D * npad * B * 8 bytes (77 MB at the serving path's 10 x 30000 x 32),
// far beyond 227 KB of shared memory, so the state lives in device memory
// (much of it in the 50 MB L2) and each iteration streams about a dozen
// such arrays. The inner products and the tol exit need all rows, and
// blocks cannot carry sums between them as the sequential TPU grid does.
//
// Design: one cooperative launch with the grid sized to co-residency;
// phases are separated by cooperative_groups grid syncs. Elementwise phases
// map each thread to one RHS column and a row lane (coalesced over the
// contiguous column axis). Inner products reduce per block in a fixed
// order into per-block partials, and after the grid sync every block sums
// the partials in the same order, so all blocks hold identical scalars and
// take the same loop exits. The banded solves with half-width w >= 1 run
// the block cyclic reduction device function (cr.cuh), one block per
// dimension; w = 0 is a division. The thread map and the gathered matvec
// come from sweep.cuh, shared with the relaxation kernels; PIVOT selects the
// pivoted block solves (SolveConfig.pivot).
#include <cooperative_groups.h>

#include "sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = repro::SWEEP_NT;  // threads per block; also the largest B
constexpr int MAX_BLOCKS_PER_SM = 4;

struct Args : repro::SweepDims {
  const double* a;
  const double* phi;
  const double* saphi;
  const double* sigma2;
  const double* v;
  const double* x0;
  double* x;
  double* r;
  double* p;
  double* ap;
  double* z;
  double* t1;
  double* tp;
  double* Ab;
  double* Bb;
  double* Cb;
  double* part0;
  double* part1;
  int* iters_out;
  long long sstride;  // CR scratch doubles per dimension
  int w_a, w_p, w_s, iters, warm;
  double tol;
};

using repro::gather_mv;
using repro::make_map;
using repro::Map;

// tp[i,b] = sum_d u[d,i,b]
__device__ void sum_dims(const Args& A, const Map& m, const double* u) {
  if (!m.on) return;
  const int B = A.B;
  for (long long i = m.r0; i < A.npad; i += m.rs) {
    double acc = 0.0;
    for (int d = 0; d < A.D; ++d)
      acc += u[((long long)d * A.npad + i) * B + m.b];
    A.tp[i * B + m.b] = acc;
  }
}

// t <- band^{-1} t per dimension (band half-width w, symmetric)
template <bool PIVOT>
__device__ void solve_phase(const Args& A, const Map& m, double* t,
                            const double* band, int w) {
  const int B = A.B;
  if (w == 0) {
    if (!m.on) return;
    const long long rows = (long long)A.D * A.npad;
    for (long long row = m.r0; row < rows; row += m.rs)
      t[row * B + m.b] /= band[row];
    return;
  }
  const long long per = (long long)A.npad * B;
  const long long bper = (long long)A.npad * (2 * w + 1);
  for (int d = blockIdx.x; d < A.D; d += gridDim.x) {
    const double* bd = band + d * bper;
    double* td = t + d * per;
    double* ab = A.Ab + d * A.sstride;
    double* bb = A.Bb + d * A.sstride;
    double* cb = A.Cb + d * A.sstride;
    switch (w) {
      case 1: repro::cr_block_solve<1, PIVOT>(bd, td, ab, bb, cb, A.npad, B); break;
      case 2: repro::cr_block_solve<2, PIVOT>(bd, td, ab, bb, cb, A.npad, B); break;
      default: repro::cr_block_solve<3, PIVOT>(bd, td, ab, bb, cb, A.npad, B); break;
    }
  }
}

// per-block partial sums of one column-wise inner product (fixed order)
__device__ void block_partial(const Args& A, const Map& m, double acc,
                              double* part, double* sh) {
  sh[threadIdx.x] = m.on ? acc : 0.0;
  __syncthreads();
  if (threadIdx.x < A.B) {
    const int rp = NT / A.B;
    double s = 0.0;
    for (int k = 0; k < rp; ++k) s += sh[k * A.B + threadIdx.x];
    part[(long long)blockIdx.x * A.B + threadIdx.x] = s;
  }
  __syncthreads();
}

// every block sums all partials in the same order -> identical totals
__device__ void grid_total(const Args& A, const double* part, double* out) {
  if (threadIdx.x < A.B) {
    double s = 0.0;
    for (int k = 0; k < (int)gridDim.x; ++k)
      s += part[(long long)k * A.B + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

template <bool PIVOT>
__global__ void __launch_bounds__(NT) mega_pcg_kernel(Args A) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh[NT];
  __shared__ double rz[NT], thresh[NT], coef[NT], tot[NT];
  const Map m = make_map(A.B);
  const int B = A.B;
  const long long rows = (long long)A.D * A.npad;
  const double s2 = *A.sigma2;

  // x = x0; cold start: r = v (Mhat 0 = 0); warm start: tp, t1 from x0
  if (m.on) {
    for (long long row = m.r0; row < rows; row += m.rs) {
      const long long e = row * B + m.b;
      A.x[e] = A.x0[e];
      if (!A.warm) A.r[e] = A.v[e];
    }
  }
  if (A.warm) {
    sum_dims(A, m, A.x0);
    gather_mv(A, m, A.t1, A.x0, A.a, A.w_a);
  }
  grid.sync();
  if (A.warm) {
    solve_phase<PIVOT>(A, m, A.t1, A.phi, A.w_p);
    grid.sync();
    if (m.on) {
      for (long long row = m.r0; row < rows; row += m.rs) {
        const int d = (int)(row / A.npad);
        const long long i = row - (long long)d * A.npad;
        const long long e = row * B + m.b;
        const long long src = ((long long)d * A.npad + A.rank[row]) * B + m.b;
        A.r[e] = A.v[e] - (A.t1[src] + A.tp[i * B + m.b] / s2);
      }
    }
    grid.sync();
  }

  // z = M_pre^{-1} r; p = z; rz = <r, z>
  gather_mv(A, m, A.t1, A.r, A.phi, A.w_p);
  grid.sync();
  solve_phase<PIVOT>(A, m, A.t1, A.saphi, A.w_s);
  grid.sync();
  {
    double acc = 0.0;
    if (m.on) {
      for (long long row = m.r0; row < rows; row += m.rs) {
        const int d = (int)(row / A.npad);
        const long long e = row * B + m.b;
        const double zz =
            s2 * A.t1[((long long)d * A.npad + A.rank[row]) * B + m.b];
        A.z[e] = zz;
        A.p[e] = zz;
        acc += A.r[e] * zz;
      }
    }
    block_partial(A, m, acc, A.part0, sh);
  }
  grid.sync();
  grid_total(A, A.part0, rz);
  if (threadIdx.x < B) thresh[threadIdx.x] = A.tol * A.tol * fabs(rz[threadIdx.x]);
  __syncthreads();

  int it = 0;
  while (true) {
    bool go = it < A.iters;
    if (go && A.tol > 0.0) {
      bool any = false;
      for (int b = 0; b < B; ++b) any = any || (fabs(rz[b]) > thresh[b]);
      go = any;
    }
    if (!go) break;

    // ap = Mhat p
    sum_dims(A, m, A.p);
    gather_mv(A, m, A.t1, A.p, A.a, A.w_a);
    grid.sync();
    solve_phase<PIVOT>(A, m, A.t1, A.phi, A.w_p);
    grid.sync();
    {
      double acc = 0.0;
      if (m.on) {
        for (long long row = m.r0; row < rows; row += m.rs) {
          const int d = (int)(row / A.npad);
          const long long i = row - (long long)d * A.npad;
          const long long e = row * B + m.b;
          const double apv =
              A.t1[((long long)d * A.npad + A.rank[row]) * B + m.b] +
              A.tp[i * B + m.b] / s2;
          A.ap[e] = apv;
          acc += A.p[e] * apv;
        }
      }
      block_partial(A, m, acc, A.part1, sh);
    }
    grid.sync();
    grid_total(A, A.part1, tot);
    if (threadIdx.x < B) {
      const double dn = tot[threadIdx.x];
      coef[threadIdx.x] = rz[threadIdx.x] / (dn == 0.0 ? 1.0 : dn);
    }
    __syncthreads();
    if (m.on) {
      const double al = coef[m.b];
      for (long long row = m.r0; row < rows; row += m.rs) {
        const long long e = row * B + m.b;
        A.x[e] = A.x[e] + al * A.p[e];
        A.r[e] = A.r[e] - al * A.ap[e];
      }
    }
    grid.sync();

    // z = M_pre^{-1} r, rz_new = <r, z>
    gather_mv(A, m, A.t1, A.r, A.phi, A.w_p);
    grid.sync();
    solve_phase<PIVOT>(A, m, A.t1, A.saphi, A.w_s);
    grid.sync();
    {
      double acc = 0.0;
      if (m.on) {
        for (long long row = m.r0; row < rows; row += m.rs) {
          const int d = (int)(row / A.npad);
          const long long e = row * B + m.b;
          const double zz =
              s2 * A.t1[((long long)d * A.npad + A.rank[row]) * B + m.b];
          A.z[e] = zz;
          acc += A.r[e] * zz;
        }
      }
      block_partial(A, m, acc, A.part0, sh);
    }
    grid.sync();
    grid_total(A, A.part0, tot);
    if (threadIdx.x < B) {
      const double rr = rz[threadIdx.x];
      coef[threadIdx.x] = tot[threadIdx.x] / (rr == 0.0 ? 1.0 : rr);
    }
    __syncthreads();
    if (threadIdx.x < B) rz[threadIdx.x] = tot[threadIdx.x];
    if (m.on) {
      const double be = coef[m.b];
      for (long long row = m.r0; row < rows; row += m.rs) {
        const long long e = row * B + m.b;
        A.p[e] = A.z[e] + be * A.p[e];
      }
    }
    __syncthreads();
    ++it;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *A.iters_out = it;
}

int grid_blocks(bool pivot, int* out) {
  return pivot ? repro::cooperative_blocks(mega_pcg_kernel<true>,
                                           MAX_BLOCKS_PER_SM, out)
               : repro::cooperative_blocks(mega_pcg_kernel<false>,
                                           MAX_BLOCKS_PER_SM, out);
}

long long scratch_stride(int npad, int w_p, int w_s) {
  int w = w_p > w_s ? w_p : w_s;
  return (long long)npad * (w > 1 ? w : 1);
}

}  // namespace

// Number of float64 workspace entries the solve needs (negative: -error).
extern "C" long long repro_mega_pcg_workspace(int D, int npad, int B, int w_p,
                                              int w_s, int pivot) {
  int grid = 0;
  const int err = grid_blocks(pivot != 0, &grid);
  if (err) return -(long long)err;
  const long long N = (long long)D * npad * B;
  return 4 * N + (long long)npad * B + 3 * D * scratch_stride(npad, w_p, w_s) +
         2 * (long long)grid * B;
}

extern "C" int repro_mega_pcg_f64(const double* a, const double* phi,
                                  const double* saphi, const int* sort,
                                  const int* rank, const double* sigma2,
                                  const double* v, const double* x0, double* x,
                                  double* r, int* iters_out, double* work,
                                  int D, int npad, int B, int w_a, int w_p,
                                  int w_s, int iters, double tol, int warm,
                                  int pivot, void* stream) {
  if (D < 1 || npad < 1 || B < 1 || B > NT || w_a < 0 || w_p < 0 ||
      w_s < 0 || w_a > 3 || w_p > 3 || w_s > 3 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if ((w_p > 0 && npad % w_p) || (w_s > 0 && npad % w_s))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = grid_blocks(pivot != 0, &grid);
  if (err) return err;
  const long long N = (long long)D * npad * B;
  const long long ss = scratch_stride(npad, w_p, w_s);
  Args A;
  A.a = a; A.phi = phi; A.saphi = saphi; A.sort = sort; A.rank = rank;
  A.sigma2 = sigma2; A.v = v; A.x0 = x0; A.x = x; A.r = r;
  A.p = work;
  A.ap = A.p + N;
  A.z = A.ap + N;
  A.t1 = A.z + N;
  A.tp = A.t1 + N;
  A.Ab = A.tp + (long long)npad * B;
  A.Bb = A.Ab + D * ss;
  A.Cb = A.Bb + D * ss;
  A.part0 = A.Cb + D * ss;
  A.part1 = A.part0 + (long long)grid * B;
  A.iters_out = iters_out;
  A.sstride = ss;
  A.D = D; A.npad = npad; A.B = B; A.w_a = w_a; A.w_p = w_p; A.w_s = w_s;
  A.iters = iters; A.warm = warm; A.tol = tol;
  void* params[] = {&A};
  const void* fn = pivot ? (const void*)mega_pcg_kernel<true>
                         : (const void*)mega_pcg_kernel<false>;
  REPRO_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(NT), params, 0, (cudaStream_t)stream));
  return (int)cudaGetLastError();
}
