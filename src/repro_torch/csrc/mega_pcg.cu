// Preconditioned-CG backfitting in one launch: the whole solve, or one
// iteration on a carried state, float64.
//
// Replaces: src/repro/kernels/mega_solve.py, mega_pcg_solve_pallas (kernel
// body `_pcg_solve_kernel`), which runs every Mhat solve of the serving
// path: the fit's mean cache (B = 1) and each 32-column chunk of the
// posterior variance (fused="auto"/"whole"); and
// src/repro/kernels/fused_sweep.py, fused_pcg_iter_pallas (kernel body
// `_pcg_kernel`), one iteration per launch (fused="on"); both also under
// jax.vmap over a fleet's tenants (the pallas_call batching rule prepends
// the tenants to the grid), here the tenant axis below.
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
// Design: one cooperative launch, one block per SM (the inner products'
// per-block partials, and so their rounding, follow the grid size);
// phases are separated by cooperative_groups grid syncs. Elementwise phases
// map each thread to one RHS column and a row lane (coalesced over the
// contiguous column axis). Inner products reduce per block in a fixed
// order into per-block partials, and after the grid sync every block sums
// the partials in the same order, so all blocks hold identical scalars and
// take the same loop exits. The thread map, the gathered matvec, the
// cross-dimension total and the banded solves come from sweep.cuh. The
// Phi and SAPhi bands are the same in every iteration, column and launch,
// so their block-CR elimination (w >= 1) is factored once by the caller
// (cr_block_factor, block_cr.cu) and every solve here only replays the
// right-hand-side half of it from the factor (sweep.cuh apply_cols, the
// same operations in the same order as the per-solve elimination, so the
// same bits); the (dimension, chunk of `cpc` columns) items spread over the
// whole grid instead of one block per dimension. At w = 0 a solve is a
// division. PIVOT selects the pivoted block solves (SolveConfig.pivot);
// MAXW the widest band: 3 (q <= 2), or 4 for q = 3's A and SAPhi, a
// second instantiation so that the first keeps its machine code.
// With one block of 256 threads per SM, the elementwise phases of an
// iteration are bound by memory latency (a gather is two dependent loads),
// so each thread takes ILP of its rows at a time, all their loads before
// their stores (sweep.cuh for_rows); each row's arithmetic and the inner
// products' row order stay those of a plain loop.
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
constexpr int MAX_BLOCKS_PER_SM = 1;
constexpr int ILP = repro::ROW_ILP;  // rows a thread takes at a time

// how the launch starts: the seed of a cold or warm solve, or a carried
// (x, r, p, rz)
enum Mode { SEED_COLD = 0, SEED_WARM = 1, CARRY = 2 };

using repro::gather_mv;
using repro::make_map;
using repro::Map;

// The tenant axis: T independent systems of Dt dimensions each (a fleet of
// GPs sharing one shape) in one launch. Bands, factors and permutations are
// stacked over (t Dt + d), so the launch's SweepDims.D = T Dt and the
// gathered matvecs and block-CR solves are those of one launch over T Dt
// dimensions (their items spread over the same grid); sigma2 is per
// tenant, the cross-dimension total sums within a tenant
// (sweep.cuh sum_dims_tenants), and the inner products, rz and the
// iteration counts are kept per (tenant, column). Each tenant's rows are
// walked with the thread map of a single-system launch and its partial
// sums reduced in the same order, so a tenant's scalars, and its results,
// are those of its own launch on the same grid. With tol > 0 each tenant
// exits on its own columns: a tenant that has exited keeps x, r, p and rz
// (its matvecs still run, into scratch), so its state and count are those
// of its own solve. The per-(tenant, column) scalars live in dynamic
// shared memory (4 T B doubles, at most MAX_TB (tenant, column) pairs).
// One system is the stack of T = 1.

constexpr int MAX_TB = repro::MAX_TB;  // tenants x columns of one launch

// the launch's operands; SweepDims::D is T Dt (every tenant's dimensions)
struct Args : repro::SweepDims {
  const double* a;
  const double* phi;
  const double* saphi;
  const double* fac_p;  // block-CR factors of phi (w_p >= 1) and saphi
  const double* fac_s;
  const double* sigma2;  // (T)
  const double* v;
  const double* x0;
  double* x;
  double* r;
  double* p;
  double* rz_io;  // (T, B)
  double* ap;
  double* z;
  double* t1;
  double* tp;
  double* part0;
  double* part1;
  int* iters_out;  // (T)
  int w_a, w_p, w_s, iters, mode, cpc;
  double tol;
  int T, Dt;
};

// t <- band^{-1} t per dimension (every tenant's), from the band's factor
template <bool PIVOT, int MAXW>
__device__ void solve(const Args& A, const Map& m, double* t,
                      const double* band, const double* fac, int w) {
  repro::apply_cols<PIVOT, false, MAXW>(A, m, t, band, fac, w, 0, A.D,
                                        A.cpc);
}

inline size_t pcg_smem(int T, int B) {
  return (size_t)4 * T * B * sizeof(double) + (size_t)2 * T * sizeof(int);
}

// per-block partial of tenant t's column-wise inner product
__device__ void block_partial_t(const Args& A, const Map& m, double acc,
                                double* part, double* sh, int t) {
  sh[threadIdx.x] = m.on ? acc : 0.0;
  __syncthreads();
  if (threadIdx.x < A.B) {
    const int rp = NT / A.B;
    double s = 0.0;
    for (int k = 0; k < rp; ++k) s += sh[k * A.B + threadIdx.x];
    part[((long long)blockIdx.x * A.T + t) * A.B + threadIdx.x] = s;
  }
  __syncthreads();
}

// every block sums every (tenant, column)'s partials in block order
__device__ void grid_total_t(const Args& A, const double* part,
                             double* out) {
  const int TB = A.T * A.B;
  for (int e = threadIdx.x; e < TB; e += NT) {
    double s = 0.0;
    for (int k = 0; k < (int)gridDim.x; ++k)
      s += part[(long long)k * TB + e];
    out[e] = s;
  }
  __syncthreads();
}

template <bool PIVOT, int MAXW>
__global__ void __launch_bounds__(NT, 1) mega_pcg_kernel(Args A) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh[NT];
  extern __shared__ double dyn[];
  const int B = A.B, T = A.T, TB = T * B;
  double* rz = dyn;
  double* thresh = rz + TB;
  double* coef = thresh + TB;
  double* tot = coef + TB;
  int* go = (int*)(tot + TB);
  int* its = go + T;
  const Map m = make_map(B);
  const long long npad = A.npad;
  const long long per_t = (long long)A.Dt * npad;  // rows of one tenant
  const long long rows = T * per_t;
  const bool warm = A.mode == SEED_WARM;

  for (int t = threadIdx.x; t < T; t += NT) its[t] = 0;
  if (A.mode == CARRY) {
    for (int e = threadIdx.x; e < TB; e += NT) {
      rz[e] = A.rz_io[e];
      thresh[e] = 0.0;  // carry launches take no tol exit
    }
    __syncthreads();
  } else {
    if (m.on) {
      for (long long row = m.r0; row < rows; row += m.rs) {
        const long long e = row * B + m.b;
        A.x[e] = A.x0[e];
        if (!warm) A.r[e] = A.v[e];
      }
    }
    if (warm) {
      repro::sum_dims_tenants(A, m, A.tp, A.x0, T, A.Dt);
      gather_mv(A, m, A.t1, A.x0, A.a, A.w_a);
    }
    grid.sync();
    if (warm) {
      solve<PIVOT, MAXW>(A, m, A.t1, A.phi, A.fac_p, A.w_p);
      grid.sync();
      if (m.on) {
        for (long long row = m.r0; row < rows; row += m.rs) {
          const long long t = T == 1 ? 0 : row / per_t;
          const long long d = row / npad;
          const long long i = row - d * npad;
          const long long e = row * B + m.b;
          const long long src = (d * npad + A.rank[row]) * B + m.b;
          A.r[e] = A.v[e] - (A.t1[src] + A.tp[(t * npad + i) * B + m.b] /
                                             A.sigma2[t]);
        }
      }
      grid.sync();
    }

    // z = M_pre^{-1} r; p = z; rz = <r, z> per tenant
    gather_mv(A, m, A.t1, A.r, A.phi, A.w_p);
    grid.sync();
    solve<PIVOT, MAXW>(A, m, A.t1, A.saphi, A.fac_s, A.w_s);
    grid.sync();
    for (int t = 0; t < T; ++t) {
      const double s2 = A.sigma2[t];
      double acc = 0.0;
      if (m.on) {
        for (long long row = t * per_t + m.r0; row < (t + 1) * per_t;
             row += m.rs) {
          const long long d = row / npad;
          const long long e = row * B + m.b;
          const double zz = s2 * A.t1[(d * npad + A.rank[row]) * B + m.b];
          A.z[e] = zz;
          A.p[e] = zz;
          acc += A.r[e] * zz;
        }
      }
      block_partial_t(A, m, acc, A.part0, sh, t);
    }
    grid.sync();
    grid_total_t(A, A.part0, rz);
    for (int e = threadIdx.x; e < TB; e += NT)
      thresh[e] = A.tol * A.tol * fabs(rz[e]);
    __syncthreads();
  }

  int it = 0;
  while (true) {
    // which tenants iterate: every block decides alike from its own copy
    // of the scalars; a tenant that has exited stays out
    for (int t = threadIdx.x; t < T; t += NT) {
      bool g = its[t] == it && it < A.iters;
      if (g && A.tol > 0.0) {
        bool any = false;
        for (int b = 0; b < B; ++b)
          any = any || (fabs(rz[t * B + b]) > thresh[t * B + b]);
        g = any;
      }
      go[t] = g;
    }
    __syncthreads();
    bool any_go = false;
    for (int t = 0; t < T; ++t) any_go = any_go || go[t];
    if (!any_go) break;

    // ap = Mhat p
    repro::sum_dims_tenants(A, m, A.tp, A.p, T, A.Dt);
    gather_mv<ILP>(A, m, A.t1, A.p, A.a, A.w_a);
    grid.sync();
    solve<PIVOT, MAXW>(A, m, A.t1, A.phi, A.fac_p, A.w_p);
    grid.sync();
    for (int t = 0; t < T; ++t) {
      const double s2 = A.sigma2[t];
      double acc = 0.0;
      if (m.on) {
        double tv[ILP], tpv[ILP], pv[ILP];
        repro::for_rows<ILP>(
            m, t * per_t, (t + 1) * per_t,
            [&](int u, long long row) {
              const long long d = row / npad;
              const long long i = row - d * npad;
              tv[u] = A.t1[(d * npad + A.rank[row]) * B + m.b];
              tpv[u] = A.tp[(t * npad + i) * B + m.b];
              pv[u] = A.p[row * B + m.b];
            },
            [&](int u, long long row) {
              const double apv = tv[u] + tpv[u] / s2;
              A.ap[row * B + m.b] = apv;
              acc += pv[u] * apv;
            });
      }
      block_partial_t(A, m, acc, A.part1, sh, t);
    }
    grid.sync();
    grid_total_t(A, A.part1, tot);
    for (int e = threadIdx.x; e < TB; e += NT) {
      const double dn = tot[e];
      coef[e] = rz[e] / (dn == 0.0 ? 1.0 : dn);
    }
    __syncthreads();
    // x += alpha p, r -= alpha Mhat p, tenant by tenant (an exited tenant
    // keeps its state)
    if (m.on) {
      for (int t = 0; t < T; ++t) {
        if (!go[t]) continue;
        const double al = coef[t * B + m.b];
        double xv[ILP], pv[ILP], rv[ILP], apv[ILP];
        repro::for_rows<ILP>(
            m, t * per_t, (t + 1) * per_t,
            [&](int u, long long row) {
              const long long e = row * B + m.b;
              xv[u] = A.x[e];
              pv[u] = A.p[e];
              rv[u] = A.r[e];
              apv[u] = A.ap[e];
            },
            [&](int u, long long row) {
              const long long e = row * B + m.b;
              A.x[e] = xv[u] + al * pv[u];
              A.r[e] = rv[u] - al * apv[u];
            });
      }
    }
    grid.sync();

    // z = M_pre^{-1} r, rz_new = <r, z> per tenant
    gather_mv<ILP>(A, m, A.t1, A.r, A.phi, A.w_p);
    grid.sync();
    solve<PIVOT, MAXW>(A, m, A.t1, A.saphi, A.fac_s, A.w_s);
    grid.sync();
    for (int t = 0; t < T; ++t) {
      const double s2 = A.sigma2[t];
      double acc = 0.0;
      if (m.on) {
        double tv[ILP], rv[ILP];
        repro::for_rows<ILP>(
            m, t * per_t, (t + 1) * per_t,
            [&](int u, long long row) {
              const long long d = row / npad;
              tv[u] = A.t1[(d * npad + A.rank[row]) * B + m.b];
              rv[u] = A.r[row * B + m.b];
            },
            [&](int u, long long row) {
              const double zz = s2 * tv[u];
              A.z[row * B + m.b] = zz;
              acc += rv[u] * zz;
            });
      }
      block_partial_t(A, m, acc, A.part0, sh, t);
    }
    grid.sync();
    grid_total_t(A, A.part0, tot);
    for (int e = threadIdx.x; e < TB; e += NT) {
      const double rr = rz[e];
      coef[e] = tot[e] / (rr == 0.0 ? 1.0 : rr);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TB; e += NT)
      if (go[e / B]) rz[e] = tot[e];
    if (m.on) {
      for (int t = 0; t < T; ++t) {
        if (!go[t]) continue;
        const double be = coef[t * B + m.b];
        double zv[ILP], pv[ILP];
        repro::for_rows<ILP>(
            m, t * per_t, (t + 1) * per_t,
            [&](int u, long long row) {
              zv[u] = A.z[row * B + m.b];
              pv[u] = A.p[row * B + m.b];
            },
            [&](int u, long long row) {
              A.p[row * B + m.b] = zv[u] + be * pv[u];
            });
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += NT)
      if (go[t]) its[t] = it + 1;
    ++it;
    grid.sync();
  }
  if (blockIdx.x == 0) {
    for (int e = threadIdx.x; e < TB; e += NT) A.rz_io[e] = rz[e];
    for (int t = threadIdx.x; t < T; t += NT) A.iters_out[t] = its[t];
  }
}

template <typename F>
int with_kernel(bool pivot, bool wide, F&& f) {
  if (wide)
    return pivot ? f(mega_pcg_kernel<true, 4>)
                 : f(mega_pcg_kernel<false, 4>);
  return pivot ? f(mega_pcg_kernel<true, 3>)
               : f(mega_pcg_kernel<false, 3>);
}

// the cooperative grid: one block a SM (the same for every T, so a tenant's
// partial sums are reduced alike), with the dynamic shared memory opted in
int grid_blocks(bool pivot, bool wide, int T, int B, int* out) {
  const size_t smem = pcg_smem(T, B);
  return with_kernel(pivot, wide, [&](auto k) {
    REPRO_RETURN_IF_ERR(cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    int dev = 0, sms = 0, coop = 0, per = 0;
    REPRO_RETURN_IF_ERR(cudaGetDevice(&dev));
    REPRO_RETURN_IF_ERR(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    REPRO_RETURN_IF_ERR(
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
    if (!coop) return (int)cudaErrorNotSupported;
    REPRO_RETURN_IF_ERR(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, NT, smem));
    if (per < 1) return (int)cudaErrorLaunchOutOfResources;
    *out = sms * MAX_BLOCKS_PER_SM;
    return 0;
  });
}

}  // namespace

// Number of float64 workspace entries a launch of T systems of D
// dimensions needs (negative: -error); maxw is the launch's widest band,
// which picks its instantiation.
extern "C" long long repro_mega_pcg_workspace(int T, int D, int npad, int B,
                                              int pivot, int maxw) {
  int grid = 0;
  const int err = grid_blocks(pivot != 0, maxw > 3, T, B, &grid);
  if (err) return -(long long)err;
  const long long N = (long long)T * D * npad * B;
  return 3 * N + (long long)T * npad * B + 2 * (long long)grid * T * B;
}

// Columns per solve item that a launch with cpc = 0 takes (sweep.cuh
// auto_cols over the T D dimensions' items; negative: -error).
extern "C" int repro_mega_pcg_cols(int T, int D, int B, int pivot, int maxw) {
  int grid = 0;
  const int err = grid_blocks(pivot != 0, maxw > 3, T, B, &grid);
  return err ? -err : repro::auto_cols(T * D, B, grid);
}

// T systems of D dimensions each: every array gains a leading T (bands,
// factors, permutations and states stacked over (t D + d)), sigma2 is (T),
// rz (T, B) and iters_out (T); T B <= 4096. Seed modes read v and x0 and
// write x, r, p and rz; the carry mode reads and updates x, r, p and rz in
// place (v and x0 unused, tol must be 0). iters_out receives the
// iterations each system ran. fac_p (w_p >= 1) and fac_s hold T D
// block-CR factors each (block_cr.cu repro_cr_factor_f64 of phi and
// saphi); cpc is the number of columns each solve item takes (0: chosen
// by sweep.cuh auto_cols). Bands of half-width up to 4; a launch with one
// of 4 runs the wide instantiation.
extern "C" int repro_mega_pcg_f64(
    const double* a, const double* phi, const double* saphi,
    const double* fac_p, const double* fac_s, const int* sort,
    const int* rank, const double* sigma2, const double* v, const double* x0,
    double* x, double* r, double* p, double* rz, int* iters_out, double* work,
    int T, int D, int npad, int B, int w_a, int w_p, int w_s, int iters,
    int cpc, double tol, int mode, int pivot, void* stream) {
  if (T < 1 || D < 1 || npad < 1 || B < 1 || B > NT ||
      (long long)T * B > MAX_TB || w_a < 0 || w_p < 0 || w_s < 0 ||
      w_a > 4 || w_p > 4 || w_s > 4 || iters < 0 || cpc < 0 ||
      mode < SEED_COLD || mode > CARRY || (mode == CARRY && tol != 0.0))
    return (int)cudaErrorInvalidValue;
  if ((w_p > 0 && (npad % w_p || !fac_p)) || (w_s > 0 && (npad % w_s || !fac_s)))
    return (int)cudaErrorInvalidValue;
  const bool wide = w_a > 3 || w_p > 3 || w_s > 3;
  int grid = 0;
  const int err = grid_blocks(pivot != 0, wide, T, B, &grid);
  if (err) return err;
  const long long N = (long long)T * D * npad * B;
  Args A;
  A.a = a; A.phi = phi; A.saphi = saphi; A.fac_p = fac_p; A.fac_s = fac_s;
  A.sort = sort; A.rank = rank; A.sigma2 = sigma2; A.v = v; A.x0 = x0;
  A.x = x; A.r = r; A.p = p; A.rz_io = rz;
  A.ap = work;
  A.z = A.ap + N;
  A.t1 = A.z + N;
  A.tp = A.t1 + N;
  A.part0 = A.tp + (long long)T * npad * B;
  A.part1 = A.part0 + (long long)grid * T * B;
  A.iters_out = iters_out;
  A.D = T * D; A.npad = npad; A.B = B; A.w_a = w_a; A.w_p = w_p;
  A.w_s = w_s; A.iters = iters; A.mode = mode; A.tol = tol;
  A.T = T; A.Dt = D;
  A.cpc = cpc == 0 ? repro::auto_cols(T * D, B, grid) : (cpc < B ? cpc : B);
  void* params[] = {&A};
  const size_t smem = pcg_smem(T, B);
  return with_kernel(pivot != 0, wide, [&](auto k) {
    REPRO_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
        (const void*)k, dim3(grid), dim3(NT), params, smem,
        (cudaStream_t)stream));
    return (int)cudaGetLastError();
  });
}
