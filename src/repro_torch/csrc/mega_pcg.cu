// Preconditioned-CG backfitting in one launch: the whole solve, or one
// iteration on a carried state, float64.
//
// Replaces: src/repro/kernels/mega_solve.py, mega_pcg_solve_pallas (kernel
// body `_pcg_solve_kernel`), which runs every Mhat solve of the serving
// path: the fit's mean cache (B = 1) and each 32-column chunk of the
// posterior variance (fused="auto"/"whole"); and
// src/repro/kernels/fused_sweep.py, fused_pcg_iter_pallas (kernel body
// `_pcg_kernel`), one iteration per launch (fused="on").
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
// take the same loop exits. The thread map, the gathered matvec, the
// cross-dimension total and the banded solves come from sweep.cuh; the
// solves run sweep.cuh's solve_cols with one slot per dimension (block
// cyclic reduction at w >= 1, a division at w = 0); PIVOT selects the
// pivoted block solves (SolveConfig.pivot).
//
// Modes: a seed launch (cold: r = v; warm: r = v - Mhat x0) forms z, p and
// rz and then runs up to `iters` iterations with the tol exit; that is the
// whole solve. A carry launch starts from the (x, r, p, rz) its caller
// hands back and runs `iters` iterations without a tol check. fused="on"
// is one seed launch for 0 iterations and then one carry launch per
// iteration, with the tol exit checked on the host: the same machine code
// as the whole solve, so the two agree bit for bit.
#include <cooperative_groups.h>

#include "sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = repro::SWEEP_NT;  // threads per block; also the largest B
constexpr int MAX_BLOCKS_PER_SM = 4;

// how the launch starts: the seed of a cold or warm solve, or a carried
// (x, r, p, rz)
enum Mode { SEED_COLD = 0, SEED_WARM = 1, CARRY = 2 };

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
  double* rz_io;
  double* ap;
  double* z;
  double* t1;
  double* tp;
  double* scratch;
  double* part0;
  double* part1;
  int* iters_out;
  long long sstride;  // CR scratch doubles per slot and array
  int w_a, w_p, w_s, iters, mode, nslots;
  double tol;
};

using repro::gather_mv;
using repro::make_map;
using repro::Map;

// t <- band^{-1} t per dimension, one solve_cols slot per dimension
template <bool PIVOT>
__device__ void solve(const Args& A, const Map& m, double* t,
                      const double* band, int w) {
  repro::solve_cols<PIVOT>(A, m, t, band, w, 0, A.D, A.scratch, A.sstride,
                           A.nslots);
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
  const bool warm = A.mode == SEED_WARM;

  if (A.mode == CARRY) {
    if (threadIdx.x < B) {
      rz[threadIdx.x] = A.rz_io[threadIdx.x];
      thresh[threadIdx.x] = 0.0;  // carry launches take no tol exit
    }
    __syncthreads();
  } else {
    // x = x0; cold start: r = v (Mhat 0 = 0); warm start: tp, t1 from x0
    if (m.on) {
      for (long long row = m.r0; row < rows; row += m.rs) {
        const long long e = row * B + m.b;
        A.x[e] = A.x0[e];
        if (!warm) A.r[e] = A.v[e];
      }
    }
    if (warm) {
      repro::sum_dims(A, m, A.tp, A.x0);
      gather_mv(A, m, A.t1, A.x0, A.a, A.w_a);
    }
    grid.sync();
    if (warm) {
      solve<PIVOT>(A, m, A.t1, A.phi, A.w_p);
      grid.sync();
      if (m.on) {
        for (long long row = m.r0; row < rows; row += m.rs) {
          const int d = (int)(row / A.npad);
          const long long i = row - (long long)d * A.npad;
          const long long e = row * B + m.b;
          const long long src =
              ((long long)d * A.npad + A.rank[row]) * B + m.b;
          A.r[e] = A.v[e] - (A.t1[src] + A.tp[i * B + m.b] / s2);
        }
      }
      grid.sync();
    }

    // z = M_pre^{-1} r; p = z; rz = <r, z>
    gather_mv(A, m, A.t1, A.r, A.phi, A.w_p);
    grid.sync();
    solve<PIVOT>(A, m, A.t1, A.saphi, A.w_s);
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
    if (threadIdx.x < B)
      thresh[threadIdx.x] = A.tol * A.tol * fabs(rz[threadIdx.x]);
    __syncthreads();
  }

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
    repro::sum_dims(A, m, A.tp, A.p);
    gather_mv(A, m, A.t1, A.p, A.a, A.w_a);
    grid.sync();
    solve<PIVOT>(A, m, A.t1, A.phi, A.w_p);
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
    solve<PIVOT>(A, m, A.t1, A.saphi, A.w_s);
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
  if (blockIdx.x == 0) {
    if (threadIdx.x < B) A.rz_io[threadIdx.x] = rz[threadIdx.x];
    if (threadIdx.x == 0) *A.iters_out = it;
  }
}

int grid_blocks(bool pivot, int* out) {
  return pivot ? repro::cooperative_blocks(mega_pcg_kernel<true>,
                                           MAX_BLOCKS_PER_SM, out)
               : repro::cooperative_blocks(mega_pcg_kernel<false>,
                                           MAX_BLOCKS_PER_SM, out);
}

// grid size and solve slots (one per dimension, at most one per block)
int layout(int D, int pivot, int* grid, int* nslots) {
  const int err = grid_blocks(pivot != 0, grid);
  if (err) return err;
  *nslots = D < *grid ? D : *grid;
  return 0;
}

long long scratch_stride(int npad, int w_p, int w_s) {
  int w = w_p > w_s ? w_p : w_s;
  return (long long)npad * (w > 1 ? w : 1);
}

}  // namespace

// Number of float64 workspace entries a launch needs (negative: -error).
extern "C" long long repro_mega_pcg_workspace(int D, int npad, int B, int w_p,
                                              int w_s, int pivot) {
  int grid = 0, nslots = 0;
  const int err = layout(D, pivot, &grid, &nslots);
  if (err) return -(long long)err;
  const long long N = (long long)D * npad * B;
  return 3 * N + (long long)npad * B +
         3LL * nslots * scratch_stride(npad, w_p, w_s) +
         2 * (long long)grid * B;
}

// Seed modes read v and x0 and write x, r, p and rz (1, B); the carry mode
// reads and updates x, r, p and rz in place (v and x0 unused, tol must be
// 0). iters_out receives the iterations run.
extern "C" int repro_mega_pcg_f64(const double* a, const double* phi,
                                  const double* saphi, const int* sort,
                                  const int* rank, const double* sigma2,
                                  const double* v, const double* x0, double* x,
                                  double* r, double* p, double* rz,
                                  int* iters_out, double* work, int D,
                                  int npad, int B, int w_a, int w_p, int w_s,
                                  int iters, double tol, int mode, int pivot,
                                  void* stream) {
  if (D < 1 || npad < 1 || B < 1 || B > NT || w_a < 0 || w_p < 0 ||
      w_s < 0 || w_a > 3 || w_p > 3 || w_s > 3 || iters < 0 ||
      mode < SEED_COLD || mode > CARRY || (mode == CARRY && tol != 0.0))
    return (int)cudaErrorInvalidValue;
  if ((w_p > 0 && npad % w_p) || (w_s > 0 && npad % w_s))
    return (int)cudaErrorInvalidValue;
  int grid = 0, nslots = 0;
  const int err = layout(D, pivot, &grid, &nslots);
  if (err) return err;
  const long long N = (long long)D * npad * B;
  const long long ss = scratch_stride(npad, w_p, w_s);
  Args A;
  A.a = a; A.phi = phi; A.saphi = saphi; A.sort = sort; A.rank = rank;
  A.sigma2 = sigma2; A.v = v; A.x0 = x0; A.x = x; A.r = r; A.p = p;
  A.rz_io = rz;
  A.ap = work;
  A.z = A.ap + N;
  A.t1 = A.z + N;
  A.tp = A.t1 + N;
  A.scratch = A.tp + (long long)npad * B;
  A.part0 = A.scratch + 3LL * nslots * ss;
  A.part1 = A.part0 + (long long)grid * B;
  A.iters_out = iters_out;
  A.sstride = ss;
  A.D = D; A.npad = npad; A.B = B; A.w_a = w_a; A.w_p = w_p; A.w_s = w_s;
  A.iters = iters; A.mode = mode; A.nslots = nslots; A.tol = tol;
  void* params[] = {&A};
  const void* fn = pivot ? (const void*)mega_pcg_kernel<true>
                         : (const void*)mega_pcg_kernel<false>;
  REPRO_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(NT), params, 0, (cudaStream_t)stream));
  return (int)cudaGetLastError();
}
