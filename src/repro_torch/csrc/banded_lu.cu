// Banded LU solve without pivoting, plus log|det|, float64.
//
// Replaces: src/repro/kernels/banded_lu.py, banded_lu_pallas (kernel body
// `_kernel`), which the serving path reaches for every solve with a
// diagonal band (Phi and Phi^T at q = 0).
//
// What bounds it on the H100: at lo = hi = 0 (the serving path) the solve
// is x = rhs / d, pure streaming: bytes (read band + rhs, write x) over the
// 3.35 TB/s memory rate; the log-determinant adds one log per row. The
// general (lo, hi) recurrence is sequential in the row index, so it is
// latency-bound: one dependent chain of n steps.
//
// Design at lo = hi = 0: one launch does both, in two kinds of blocks of
// one grid (blockIdx.y = the matrix g). The first `log_tiles` blocks of a
// matrix sum log|d| over fixed tiles of LOG_ROWS rows, 128 threads each, in
// a fixed order, into per-tile partials; the last of them to finish (a
// __threadfence and an integer counter, which it resets to 0 for the next
// launch) sums the partials in tile order. No float atomics, and the order
// does not depend on B: the log-determinant has the same bits in every run
// and whether or not the call also solves. The other blocks stream the
// solve: threadIdx.x runs over a row's columns in 16-byte double2 vectors
// (where B is even and the pointers aligned; else single doubles) and
// threadIdx.y over rows, DIAG_RPT rows each, so a warp reads and writes one
// contiguous stretch of the row-major (n, B) right-hand side, and each
// thread loads its rows' diagonals once, all loads before the stores; the
// right-hand side is read once and x written once, so both go through the
// streaming (evict-first) cache path. The
// log blocks come first in the grid, so they run beside the streaming ones
// instead of lengthening every solve block. rhs == nullptr skips the solve,
// ld == nullptr the log-determinant.
//
// The general case runs one block per matrix with one thread per
// right-hand-side column; every thread recomputes the (RHS-independent) U
// rows in registers, so the forward sweep needs no synchronisation, and
// thread 0 stores U for the back substitution that follows a single
// __syncthreads.
#include "common.cuh"

namespace {

constexpr int MAXW = 8;  // lo, hi <= MAXW - 1
constexpr int DIAG_NT = 256;   // threads per block at lo = hi = 0
constexpr int DIAG_RPT = 8;    // rows per thread and solve tile
constexpr int LOG_NT = 128;    // threads of a log tile (every block has them)
constexpr int LOG_ROWS = 1024; // rows per log tile

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = double;
  static __device__ __forceinline__ T div(T a, double d) { return a / d; }
};
template <>
struct Vec<2> {
  using T = double2;
  static __device__ __forceinline__ T div(T a, double d) {
    return make_double2(a.x / d, a.y / d);
  }
};

// Fixed-order sum of red[0, LOG_NT) into red[0] (every thread of the block
// calls it; threads t < LOG_NT hold the values).
__device__ __forceinline__ void tree_sum(double* red, int t) {
  __syncthreads();
  for (int h = LOG_NT / 2; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
}

// log|det| = sum_i log|d_i| of matrix g: this block's tile, then (in the
// last tile to finish) the sum of the tiles' partials
__device__ void log_tile(const double* bg, double* part, double* ld,
                         unsigned* count, int g, int tile, int log_tiles,
                         int n, int t) {
  __shared__ double red[LOG_NT];
  __shared__ bool last;
  double acc = 0.0;
  if (t < LOG_NT) {
    const int r0 = tile * LOG_ROWS;
    const int r1 = r0 + LOG_ROWS < n ? r0 + LOG_ROWS : n;
    for (int row = r0 + t; row < r1; row += LOG_NT) acc += log(fabs(bg[row]));
    red[t] = acc;
  }
  tree_sum(red, t);
  if (t == 0) {
    part[(long long)g * log_tiles + tile] = red[0];
    __threadfence();
    last = atomicAdd(count + g, 1u) == (unsigned)(log_tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  // the last tile of matrix g: every other tile's partial is visible
  __threadfence();
  if (t < LOG_NT) {
    acc = 0.0;
    for (int k = t; k < log_tiles; k += LOG_NT)
      acc += __ldcg(part + (long long)g * log_tiles + k);
    red[t] = acc;
  }
  tree_sum(red, t);
  if (t == 0) {
    ld[g] = red[0];
    count[g] = 0;
  }
}

// blockIdx.x < log_tiles: a log tile of matrix blockIdx.y; the rest: x =
// rhs / d over a solve tile of by * DIAG_RPT rows, V doubles per vector.
template <int V>
__global__ void __launch_bounds__(DIAG_NT)
    diag_kernel(const double* __restrict__ band,
                const double* __restrict__ rhs, double* __restrict__ x,
                double* __restrict__ part, double* __restrict__ ld,
                unsigned* __restrict__ count, int n, int B, int log_tiles) {
  using T = typename Vec<V>::T;
  const int g = blockIdx.y;
  const double* bg = band + (long long)g * n;
  if ((int)blockIdx.x < log_tiles) {
    log_tile(bg, part, ld, count, g, blockIdx.x, log_tiles, n,
             threadIdx.x + blockDim.x * threadIdx.y);
    return;
  }
  const int by = blockDim.y;
  const int r0 = ((int)blockIdx.x - log_tiles) * by * DIAG_RPT;
  const int cv = B / V;  // vectors per row
  const T* rg = reinterpret_cast<const T*>(rhs + (long long)g * n * B);
  T* xg = reinterpret_cast<T*>(x + (long long)g * n * B);
  for (int c = threadIdx.x; c < cv; c += blockDim.x) {
    double d[DIAG_RPT];
    T v[DIAG_RPT];
#pragma unroll
    for (int k = 0; k < DIAG_RPT; ++k) {
      const int row = r0 + threadIdx.y + k * by;
      if (row < n) {
        d[k] = bg[row];
        v[k] = __ldcs(rg + (long long)row * cv + c);
      }
    }
#pragma unroll
    for (int k = 0; k < DIAG_RPT; ++k) {
      const int row = r0 + threadIdx.y + k * by;
      if (row < n)
        __stcs(xg + (long long)row * cv + c, Vec<V>::div(v[k], d[k]));
    }
  }
}

int launch_diag(const double* band, const double* rhs, double* x, double* ld,
                double* part, unsigned* count, int G, int n, int B,
                cudaStream_t st) {
  const bool vec2 = rhs != nullptr && B % 2 == 0 &&
                    reinterpret_cast<size_t>(rhs) % 16 == 0 &&
                    reinterpret_cast<size_t>(x) % 16 == 0;
  const int cv = vec2 ? B / 2 : B;
  const int bx = cv < DIAG_NT ? cv : DIAG_NT;
  const int by = DIAG_NT / bx;
  const int tr = by * DIAG_RPT;
  const int log_tiles = ld != nullptr ? (n + LOG_ROWS - 1) / LOG_ROWS : 0;
  const int solve_tiles = rhs != nullptr ? (n + tr - 1) / tr : 0;
  const dim3 grid(log_tiles + solve_tiles, G);
  const dim3 block(rhs != nullptr ? bx : DIAG_NT, rhs != nullptr ? by : 1);
  if (vec2)
    diag_kernel<2><<<grid, block, 0, st>>>(band, rhs, x, part, ld, count, n,
                                           B, log_tiles);
  else
    diag_kernel<1><<<grid, block, 0, st>>>(band, rhs, x, part, ld, count, n,
                                           B, log_tiles);
  return (int)cudaGetLastError();
}

__global__ void lu_general_kernel(const double* __restrict__ band,
                                  const double* __restrict__ rhs,
                                  double* __restrict__ x,
                                  double* __restrict__ ld,
                                  double* __restrict__ ubuf, int n, int lo,
                                  int hi, int B) {
  const int g = blockIdx.x;
  const int wb = lo + hi + 1, wu = hi + 1;
  const double* bg = band + (long long)g * n * wb;
  const double* rg = rhs + (long long)g * n * B;
  double* xg = x + (long long)g * n * B;
  double* ug = ubuf + (long long)g * n * wu;

  // forward elimination; x holds the forward-substituted rhs afterwards
  for (int b0 = 0; b0 < B; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const bool col = b < B;
    const bool writer = (b0 == 0 && threadIdx.x == 0);
    double uprev[MAXW][MAXW];  // U rows i-lo .. i-1 (identity before row 0)
    double yprev[MAXW];
    for (int t = 0; t < lo; ++t) {
      for (int s = 0; s < wu; ++s) uprev[t][s] = (s == 0) ? 1.0 : 0.0;
      yprev[t] = 0.0;
    }
    double ldacc = 0.0;
    for (int i = 0; i < n; ++i) {
      double w[2 * MAXW];
      for (int k = 0; k < wb; ++k) w[k] = bg[(long long)i * wb + k];
      double y = col ? rg[(long long)i * B + b] : 0.0;
      for (int t = 0; t < lo; ++t) {
        const double f = w[t] / uprev[t][0];
        for (int s = 0; s < wu; ++s) w[t + s] -= f * uprev[t][s];
        y -= f * yprev[t];
      }
      for (int t = 0; t + 1 < lo; ++t) {
        for (int s = 0; s < wu; ++s) uprev[t][s] = uprev[t + 1][s];
        yprev[t] = yprev[t + 1];
      }
      if (lo > 0) {
        for (int s = 0; s < wu; ++s) uprev[lo - 1][s] = w[lo + s];
        yprev[lo - 1] = y;
      }
      if (writer) {
        for (int s = 0; s < wu; ++s) ug[(long long)i * wu + s] = w[lo + s];
      }
      ldacc += log(fabs(w[lo]));
      if (col) xg[(long long)i * B + b] = y;
    }
    if (writer) ld[g] = ldacc;
  }
  __syncthreads();

  // back substitution, in place over x
  for (int b0 = 0; b0 < B; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    if (b >= B) continue;
    double xnext[MAXW];  // x[i+1 .. i+hi], zero past the end
    for (int s = 0; s < hi; ++s) xnext[s] = 0.0;
    for (int i = n - 1; i >= 0; --i) {
      const double* u = ug + (long long)i * wu;
      double acc = xg[(long long)i * B + b];
      for (int s = 1; s <= hi; ++s) acc -= u[s] * xnext[s - 1];
      const double xi = acc / u[0];
      for (int s = hi - 1; s > 0; --s) xnext[s] = xnext[s - 1];
      if (hi > 0) xnext[0] = xi;
      xg[(long long)i * B + b] = xi;
    }
  }
}

}  // namespace

// band (G, n, lo+hi+1), rhs and x (G, n, B), ld (G,). At lo = hi = 0,
// rhs == nullptr skips the solve and ld == nullptr the log-determinant;
// part holds G * ceil(n / LOG_ROWS) doubles and count G zeroed counters
// (left zeroed); ubuf is unused. Otherwise rhs, ld and ubuf (G, n, hi+1)
// are required and part, count unused.
extern "C" int repro_banded_lu_f64(const double* band, const double* rhs,
                                   double* x, double* ld, double* ubuf,
                                   double* part, unsigned* count, int G,
                                   int n, int lo, int hi, int B,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (lo < 0 || hi < 0 || lo >= MAXW || hi >= MAXW || G < 1 || G > 65535 ||
      n < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  if (lo == 0 && hi == 0) {
    if ((rhs == nullptr && ld == nullptr) || (ld != nullptr && !count))
      return (int)cudaErrorInvalidValue;
    return launch_diag(band, rhs, x, ld, part, count, G, n, B, st);
  }
  if (rhs == nullptr || ld == nullptr || ubuf == nullptr)
    return (int)cudaErrorInvalidValue;
  int threads = B < 128 ? B : 128;
  threads = ((threads + 31) / 32) * 32;
  lu_general_kernel<<<G, threads, 0, st>>>(band, rhs, x, ld, ubuf, n, lo, hi,
                                           B);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
