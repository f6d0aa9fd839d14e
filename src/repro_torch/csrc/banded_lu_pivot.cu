// Banded LU solve with partial pivoting (LAPACK gbsv-style), plus log|det|,
// float64.
//
// Replaces no Pallas kernel: the reference runs this route as a lax.scan,
// src/repro/core/banded.py `_lu_pivot_scan` (:304) with
// `_solve_pivot_single` (:380) and `_logdet_scan` (:493), to which its
// kernels/ops.py (:597, :631) sends every pivot=True solve and
// log-determinant on the LU route (lo != hi, or solve alg "lu"). The port
// never hands a CUDA tensor to a plain version, and a scan on the hot path
// is a kernel, so the route has this one: with GPConfig(pivot=True,
// solve_alg="lu") every A, SAPhi and A Phi^T solve and log-determinant
// runs here.
//
// What bounds it on the H100: one dependent chain a matrix, n elimination
// steps (the pivot among lo + 1 candidates, lo divisions, the window's
// update) and n back-substitution steps: latency. The bytes (band and
// right-hand side read once, x written once) take ~0.05 ms at the main
// path's shapes; the chain takes milliseconds.
//
// Design: one block a matrix (grid G), factor then apply in one launch.
// Symmetric bands of half-width L = 1..8 (every band of a GP: A, Phi,
// SAPhi, the gradients' B, the Woodbury patches) run an instance whose
// loops are exactly as long as L asks; any other (lo, hi) <= 8 runs one
// instance that reads the widths at run time, its loops bounded by 8 and
// predicated, and so several times longer a step.
//   1. Warp 0 factors. Lane c holds column c of the working window (the
//      lo + 1 candidate rows of the current column) in registers. The
//      reference's window is 2 lo + hi + 1 wide, but its columns past
//      lo + hi only ever hold zeros, so lo + hi + 1 <= 17 lanes carry it.
//      A step broadcasts column 0 (shuffles); every lane picks the pivot
//      (the first largest magnitude, a NaN first, as argmax does), swaps
//      and eliminates its own column, and the window moves one lane down.
//      U's row, the lo multipliers and the pivot's offset go to scratch
//      the wrapper allocates; the entering rows are loaded a chunk of
//      steps ahead, off the chain.
//   2. Warp 0 sums log|U[k, 0]| over strided shares of the rows, then a
//      fixed shuffle tree (the same bits whatever the block's width).
//   3. One thread a right-hand-side column replays the swaps and the
//      multipliers on its own lo + 1 window values in registers, then
//      back-substitutes over U's rows (upper width lo + hi), in place in x;
//      each reads a chunk of steps' scratch and right-hand side at once,
//      so a load's latency is paid once a chunk, not once a step.
// Rounding: each product and difference is rounded on its own (__dmul_rn,
// __dsub_rn: no FMA contraction) and divisions are IEEE, in the plain
// version's order (kernels/banded_lu.py banded_lu_pivot_plain), so the
// pivot choices, U and x follow the plain version's arithmetic step for
// step. Were two candidates to differ only by rounding, the choices could
// part, and the backward error decides (chip_smoke.py gates on it). The
// log-determinant's sum has its own order.
#include "common.cuh"

namespace {

constexpr int MAXL = 8;      // lo, hi <= MAXL
constexpr int MAX_NT = 128;  // threads a block
constexpr unsigned FULL = 0xffffffffu;

// Compile-time bounds of an instance: LT = HT = L for a symmetric band of
// half-width L; LT = HT = -1 for widths read at run time (<= MAXL).
template <int LT, int HT>
struct Dims {
  static constexpr bool kFixed = LT >= 0;
  static constexpr int ML = kFixed ? LT : MAXL;  // lo <= ML
  static constexpr int MH = kFixed ? HT : MAXL;  // hi <= MH
  static constexpr int MR = ML + 1;              // window rows
  static constexpr int MU = ML + MH + 1;         // width of a U row
  static constexpr int CF = 8;                   // factor steps a chunk
  // replay and back-substitution steps a chunk: as many as ~40-50 doubles
  // of registers hold
  static constexpr int CA = 40 / (ML + 2) > 2 ? 40 / (ML + 2) : 2;
  static constexpr int CB = 48 / (MU + 1) > 2 ? 48 / (MU + 1) : 2;
};

// a - f * b with the product rounded first, as the plain version computes
__device__ __forceinline__ double mul_sub(double a, double f, double b) {
  return __dsub_rn(a, __dmul_rn(f, b));
}

// Warp 0: the pivoted elimination of one matrix (band bg, (n, wu)),
// writing U's rows (n, wu), the multipliers (n, lo) and the pivot offsets.
template <int LT, int HT>
__device__ void factor(const double* __restrict__ bg, double* __restrict__ ug,
                       double* __restrict__ fg, unsigned char* __restrict__ pg,
                       int n, int lo, int hi) {
  using S = Dims<LT, HT>;
  constexpr int MR = S::MR, CF = S::CF;
  const int c = threadIdx.x;  // the window column this lane holds
  const int wu = lo + hi + 1;
  double r[MR];  // rows 0..lo of the window, column c
#pragma unroll
  for (int j = 0; j < MR; ++j) {
    double v = 0.0;
    if (j <= lo) {
      if (j < n) {
        const int o = c - j + lo;  // row j's band offset of column c
        if (o < wu) v = bg[(long long)j * wu + o];
      } else {
        v = c == j ? 1.0 : 0.0;  // a row past n: 1 on its diagonal
      }
    }
    r[j] = v;
  }
  // the rows that enter at a chunk's steps: this chunk's and the next's
  auto load = [&](double(&dst)[CF], int k0) {
#pragma unroll
    for (int s = 0; s < CF; ++s) {
      const int row = k0 + s + lo + 1;
      dst[s] = row < n ? (c < wu ? bg[(long long)row * wu + c] : 0.0)
                       : (c == lo ? 1.0 : 0.0);
    }
  };
  double cur[CF], nxt[CF];
  load(cur, 0);
  for (int k0 = 0; k0 < n; k0 += CF) {
    load(nxt, k0 + CF);
#pragma unroll
    for (int s = 0; s < CF; ++s) {
      const int k = k0 + s;
      if (k < n) {          // uniform over the warp
        double a[MR];       // the window's column 0, on every lane
#pragma unroll
        for (int t = 0; t < MR; ++t)
          a[t] = t <= lo ? __shfl_sync(FULL, r[t], 0) : 0.0;
        int p = 0;
        double best = fabs(a[0]);
        bool found_nan = isnan(a[0]);
#pragma unroll
        for (int t = 1; t < MR; ++t) {
          if (t <= lo && !found_nan && (isnan(a[t]) || fabs(a[t]) > best)) {
            p = t;
            best = fabs(a[t]);
            found_nan = isnan(a[t]);
          }
        }
#pragma unroll
        for (int t = 1; t < MR; ++t) {
          if (t == p) {
            const double s0 = r[0];
            r[0] = r[t];
            r[t] = s0;
            const double s1 = a[0];
            a[0] = a[t];
            a[t] = s1;
          }
        }
#pragma unroll
        for (int t = 1; t < MR; ++t) {
          if (t <= lo) {
            const double f = a[t] / a[0];
            r[t] = mul_sub(r[t], f, r[0]);
            if (c == t - 1) fg[(long long)k * lo + c] = f;
          }
        }
        if (c < wu) ug[(long long)k * wu + c] = r[0];
        if (c == 0) pg[k] = (unsigned char)p;
        // drop column 0: lane c takes lane c + 1's rows 1..lo (lanes past
        // wu hold zeros), and the entering row becomes row lo
#pragma unroll
        for (int t = 0; t + 1 < MR; ++t)
          if (t < lo) r[t] = __shfl_down_sync(FULL, r[t + 1], 1);
#pragma unroll
        for (int t = 0; t < MR; ++t)
          if (t == lo) r[t] = cur[s];
      }
    }
#pragma unroll
    for (int s = 0; s < CF; ++s) cur[s] = nxt[s];
  }
}

// log|det| = sum_k log|U[k, 0]|, on warp 0: strided partial sums, then a
// fixed shuffle tree, so the bits do not depend on the block's width.
__device__ void log_sum(const double* ug, double* ld, int n, int wu) {
  const int t = threadIdx.x;
  if (t >= 32) return;
  double acc = 0.0;
  for (int k = t; k < n; k += 32) acc += log(fabs(ug[(long long)k * wu]));
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) acc += __shfl_down_sync(FULL, acc, h);
  if (t == 0) *ld = acc;
}

// One thread a column: replay the factor's swaps and multipliers on the
// right-hand side (forward solve into x), then back substitution in x.
template <int LT, int HT>
__device__ void apply(const double* __restrict__ rg, double* __restrict__ xg,
                      const double* ug, const double* fg,
                      const unsigned char* pg, int n, int lo, int hi, int B) {
  using S = Dims<LT, HT>;
  constexpr int ML = S::ML, MR = S::MR, MU = S::MU, CA = S::CA, CB = S::CB;
  const int wu = lo + hi + 1, ubw = wu - 1;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    double v[MR];
#pragma unroll
    for (int j = 0; j < MR; ++j)
      v[j] = (j <= lo && j < n) ? rg[(long long)j * B + b] : 0.0;
    for (int k0 = 0; k0 < n; k0 += CA) {
      double fs[CA][ML], rs[CA];  // a chunk's multipliers and entering rhs
      int ps[CA];                 // and pivot offsets
#pragma unroll
      for (int s = 0; s < CA; ++s) {
        const int k = k0 + s;
        if (k < n) {
#pragma unroll
          for (int t = 0; t < ML; ++t)
            if (t < lo) fs[s][t] = fg[(long long)k * lo + t];
          ps[s] = pg[k];
        }
        const int row = k + lo + 1;
        rs[s] = row < n ? rg[(long long)row * B + b] : 0.0;
      }
#pragma unroll
      for (int s = 0; s < CA; ++s) {
        const int k = k0 + s;
        if (k < n) {
#pragma unroll
          for (int t = 1; t < MR; ++t) {
            if (t == ps[s]) {
              const double s0 = v[0];
              v[0] = v[t];
              v[t] = s0;
            }
          }
#pragma unroll
          for (int t = 1; t < MR; ++t)
            if (t <= lo) v[t] = mul_sub(v[t], fs[s][t - 1], v[0]);
          xg[(long long)k * B + b] = v[0];
#pragma unroll
          for (int t = 0; t + 1 < MR; ++t)
            if (t < lo) v[t] = v[t + 1];
#pragma unroll
          for (int t = 0; t < MR; ++t)
            if (t == lo) v[t] = rs[s];
        }
      }
    }
    // back substitution, x[i] from x[i+1 .. i+ubw], a chunk of rows at once
    double nxt[MU - 1];
#pragma unroll
    for (int s = 0; s < MU - 1; ++s) nxt[s] = 0.0;
    for (int i0 = n - 1; i0 >= 0; i0 -= CB) {
      double us[CB][MU], ys[CB];
#pragma unroll
      for (int s = 0; s < CB; ++s) {
        const int i = i0 - s;
        if (i >= 0) {
#pragma unroll
          for (int t = 0; t < MU; ++t)
            if (t < wu) us[s][t] = ug[(long long)i * wu + t];
          ys[s] = xg[(long long)i * B + b];
        }
      }
#pragma unroll
      for (int s = 0; s < CB; ++s) {
        const int i = i0 - s;
        if (i >= 0) {
          double acc = ys[s];
#pragma unroll
          for (int t = 1; t < MU; ++t)
            if (t <= ubw) acc = mul_sub(acc, us[s][t], nxt[t - 1]);
          const double xi = acc / us[s][0];
#pragma unroll
          for (int t = MU - 2; t > 0; --t) nxt[t] = nxt[t - 1];
          nxt[0] = xi;
          xg[(long long)i * B + b] = xi;
        }
      }
    }
  }
}

template <int LT, int HT>
__global__ void __launch_bounds__(MAX_NT)
    lu_pivot_kernel(const double* __restrict__ band, const double* rhs,
                    double* x, double* ld, double* work,
                    unsigned char* picks, int n, int lo_rt, int hi_rt, int B) {
  const int lo = Dims<LT, HT>::kFixed ? LT : lo_rt;
  const int hi = Dims<LT, HT>::kFixed ? HT : hi_rt;
  const int g = blockIdx.x;
  const int wu = lo + hi + 1;
  double* ug = work + (long long)g * n * (wu + lo);
  double* fg = ug + (long long)n * wu;
  unsigned char* pg = picks + (long long)g * n;
  if (threadIdx.x < 32)
    factor<LT, HT>(band + (long long)g * n * wu, ug, fg, pg, n, lo, hi);
  __syncthreads();  // U, the multipliers and the pivots, for every thread
  if (ld != nullptr) log_sum(ug, ld + g, n, wu);
  if (rhs != nullptr)
    apply<LT, HT>(rhs + (long long)g * n * B, x + (long long)g * n * B, ug,
                  fg, pg, n, lo, hi, B);
}

template <int LT, int HT>
void launch(const double* band, const double* rhs, double* x, double* ld,
            double* work, unsigned char* picks, int G, int n, int lo, int hi,
            int B, int threads, cudaStream_t st) {
  lu_pivot_kernel<LT, HT><<<G, threads, 0, st>>>(band, rhs, x, ld, work,
                                                 picks, n, lo, hi, B);
}

}  // namespace

// band (G, n, lo+hi+1); rhs and x (G, n, B) (rhs == nullptr: factor only);
// ld (G,) or nullptr; work G * n * (2 lo + hi + 1) doubles and picks G * n
// bytes of scratch. lo, hi <= 8.
extern "C" int repro_banded_lu_pivot_f64(const double* band, const double* rhs,
                                         double* x, double* ld, double* work,
                                         unsigned char* picks, int G, int n,
                                         int lo, int hi, int B, void* stream) {
  if (lo < 0 || hi < 0 || lo > MAXL || hi > MAXL || G < 1 || G > 65535 ||
      n < 1 || work == nullptr || picks == nullptr ||
      (rhs == nullptr && ld == nullptr) ||
      (rhs != nullptr && (B < 1 || x == nullptr)))
    return (int)cudaErrorInvalidValue;
  int threads = 32;
  while (rhs != nullptr && threads < B && threads < MAX_NT) threads *= 2;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_LU_PIVOT_ARGS band, rhs, x, ld, work, picks, G, n, lo, hi, B, \
                            threads, st
  switch (lo == hi ? lo : -1) {
    case 1: launch<1, 1>(REPRO_LU_PIVOT_ARGS); break;
    case 2: launch<2, 2>(REPRO_LU_PIVOT_ARGS); break;
    case 3: launch<3, 3>(REPRO_LU_PIVOT_ARGS); break;
    case 4: launch<4, 4>(REPRO_LU_PIVOT_ARGS); break;
    case 5: launch<5, 5>(REPRO_LU_PIVOT_ARGS); break;
    case 6: launch<6, 6>(REPRO_LU_PIVOT_ARGS); break;
    case 7: launch<7, 7>(REPRO_LU_PIVOT_ARGS); break;
    case 8: launch<8, 8>(REPRO_LU_PIVOT_ARGS); break;
    default: launch<-1, -1>(REPRO_LU_PIVOT_ARGS); break;
  }
#undef REPRO_LU_PIVOT_ARGS
  return (int)cudaGetLastError();
}
