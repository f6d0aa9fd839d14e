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

struct Args : repro::SweepDims {
  const double* a;
  const double* phi;
  const double* saphi;
  const double* fac_p;  // block-CR factors of phi (w_p >= 1) and saphi
  const double* fac_s;
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
  double* part0;
  double* part1;
  int* iters_out;
  int w_a, w_p, w_s, iters, mode, cpc;
  double tol;
};

using repro::gather_mv;
using repro::make_map;
using repro::Map;

// t <- band^{-1} t per dimension, from the band's factor
template <bool PIVOT, int MAXW>
__device__ void solve(const Args& A, const Map& m, double* t,
                      const double* band, const double* fac, int w) {
  repro::apply_cols<PIVOT, false, MAXW>(A, m, t, band, fac, w, 0, A.D,
                                        A.cpc);
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

template <bool PIVOT, int MAXW>
__global__ void __launch_bounds__(NT, 1) mega_pcg_kernel(Args A) {
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
      solve<PIVOT, MAXW>(A, m, A.t1, A.phi, A.fac_p, A.w_p);
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
    solve<PIVOT, MAXW>(A, m, A.t1, A.saphi, A.fac_s, A.w_s);
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
    gather_mv<ILP>(A, m, A.t1, A.p, A.a, A.w_a);
    grid.sync();
    solve<PIVOT, MAXW>(A, m, A.t1, A.phi, A.fac_p, A.w_p);
    grid.sync();
    {
      double acc = 0.0;
      if (m.on) {
        double tv[ILP], tpv[ILP], pv[ILP];
        repro::for_rows<ILP>(
            m, 0, rows,
            [&](int u, long long row) {
              const int d = (int)(row / A.npad);
              const long long i = row - (long long)d * A.npad;
              tv[u] = A.t1[((long long)d * A.npad + A.rank[row]) * B + m.b];
              tpv[u] = A.tp[i * B + m.b];
              pv[u] = A.p[row * B + m.b];
            },
            [&](int u, long long row) {
              const double apv = tv[u] + tpv[u] / s2;
              A.ap[row * B + m.b] = apv;
              acc += pv[u] * apv;
            });
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
      double xv[ILP], pv[ILP], rv[ILP], apv[ILP];
      repro::for_rows<ILP>(
          m, 0, rows,
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
    grid.sync();

    // z = M_pre^{-1} r, rz_new = <r, z>
    gather_mv<ILP>(A, m, A.t1, A.r, A.phi, A.w_p);
    grid.sync();
    solve<PIVOT, MAXW>(A, m, A.t1, A.saphi, A.fac_s, A.w_s);
    grid.sync();
    {
      double acc = 0.0;
      if (m.on) {
        double tv[ILP], rv[ILP];
        repro::for_rows<ILP>(
            m, 0, rows,
            [&](int u, long long row) {
              const int d = (int)(row / A.npad);
              tv[u] = A.t1[((long long)d * A.npad + A.rank[row]) * B + m.b];
              rv[u] = A.r[row * B + m.b];
            },
            [&](int u, long long row) {
              const double zz = s2 * tv[u];
              A.z[row * B + m.b] = zz;
              acc += rv[u] * zz;
            });
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
      double zv[ILP], pv[ILP];
      repro::for_rows<ILP>(
          m, 0, rows,
          [&](int u, long long row) {
            zv[u] = A.z[row * B + m.b];
            pv[u] = A.p[row * B + m.b];
          },
          [&](int u, long long row) {
            A.p[row * B + m.b] = zv[u] + be * pv[u];
          });
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

// f(kernel) for the instantiation of the pivot mode and the widest band
// (wide: w = 4)
template <typename F>
int with_kernel(bool pivot, bool wide, F&& f) {
  if (wide)
    return pivot ? f(mega_pcg_kernel<true, 4>) : f(mega_pcg_kernel<false, 4>);
  return pivot ? f(mega_pcg_kernel<true, 3>) : f(mega_pcg_kernel<false, 3>);
}

int grid_blocks(bool pivot, bool wide, int* out) {
  return with_kernel(pivot, wide, [&](auto k) {
    return repro::cooperative_blocks(k, MAX_BLOCKS_PER_SM, out);
  });
}

}  // namespace

// Number of float64 workspace entries a launch needs (negative: -error);
// maxw is the launch's widest band, which picks its instantiation.
extern "C" long long repro_mega_pcg_workspace(int D, int npad, int B,
                                              int pivot, int maxw) {
  int grid = 0;
  const int err = grid_blocks(pivot != 0, maxw > 3, &grid);
  if (err) return -(long long)err;
  const long long N = (long long)D * npad * B;
  return 3 * N + (long long)npad * B + 2 * (long long)grid * B;
}

// Columns per solve item that a launch with cpc = 0 takes (negative:
// -error).
extern "C" int repro_mega_pcg_cols(int D, int B, int pivot, int maxw) {
  int grid = 0;
  const int err = grid_blocks(pivot != 0, maxw > 3, &grid);
  return err ? -err : repro::auto_cols(D, B, grid);
}

// Seed modes read v and x0 and write x, r, p and rz (1, B); the carry mode
// reads and updates x, r, p and rz in place (v and x0 unused, tol must be
// 0). iters_out receives the iterations run. fac_p (w_p >= 1) and fac_s
// hold D block-CR factors each (block_cr.cu repro_cr_factor_f64 of phi and
// saphi); cpc is the number of columns each solve item takes (0: chosen
// by sweep.cuh auto_cols). Bands of half-width up to 4; a launch with one
// of 4 runs the wide instantiation.
extern "C" int repro_mega_pcg_f64(const double* a, const double* phi,
                                  const double* saphi, const double* fac_p,
                                  const double* fac_s, const int* sort,
                                  const int* rank, const double* sigma2,
                                  const double* v, const double* x0, double* x,
                                  double* r, double* p, double* rz,
                                  int* iters_out, double* work, int D,
                                  int npad, int B, int w_a, int w_p, int w_s,
                                  int iters, int cpc, double tol, int mode,
                                  int pivot, void* stream) {
  if (D < 1 || npad < 1 || B < 1 || B > NT || w_a < 0 || w_p < 0 ||
      w_s < 0 || w_a > 4 || w_p > 4 || w_s > 4 || iters < 0 || cpc < 0 ||
      mode < SEED_COLD || mode > CARRY || (mode == CARRY && tol != 0.0))
    return (int)cudaErrorInvalidValue;
  if ((w_p > 0 && (npad % w_p || !fac_p)) || (w_s > 0 && (npad % w_s || !fac_s)))
    return (int)cudaErrorInvalidValue;
  const bool wide = w_a > 3 || w_p > 3 || w_s > 3;
  int grid = 0;
  const int err = grid_blocks(pivot != 0, wide, &grid);
  if (err) return err;
  const long long N = (long long)D * npad * B;
  Args A;
  A.a = a; A.phi = phi; A.saphi = saphi; A.fac_p = fac_p; A.fac_s = fac_s;
  A.sort = sort; A.rank = rank; A.sigma2 = sigma2; A.v = v; A.x0 = x0;
  A.x = x; A.r = r; A.p = p; A.rz_io = rz;
  A.ap = work;
  A.z = A.ap + N;
  A.t1 = A.z + N;
  A.tp = A.t1 + N;
  A.part0 = A.tp + (long long)npad * B;
  A.part1 = A.part0 + (long long)grid * B;
  A.iters_out = iters_out;
  A.D = D; A.npad = npad; A.B = B; A.w_a = w_a; A.w_p = w_p; A.w_s = w_s;
  A.iters = iters; A.mode = mode; A.tol = tol;
  A.cpc = cpc == 0 ? repro::auto_cols(D, B, grid) : (cpc < B ? cpc : B);
  void* params[] = {&A};
  return with_kernel(pivot != 0, wide, [&](auto k) {
    REPRO_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
        (const void*)k, dim3(grid), dim3(NT), params, 0,
        (cudaStream_t)stream));
    return (int)cudaGetLastError();
  });
}
