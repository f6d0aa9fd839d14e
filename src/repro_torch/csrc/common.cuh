// Shared helpers of the port's CUDA kernels (float64 throughout).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define REPRO_RETURN_IF_ERR(expr)              \
  do {                                         \
    cudaError_t _e = (expr);                   \
    if (_e != cudaSuccess) return (int)_e;     \
  } while (0)

namespace repro {

// Grid size for a grid-stride loop over `total` items.
inline int stride_blocks(long long total, int threads, int cap = 8192) {
  long long b = (total + threads - 1) / threads;
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

// Gaussian elimination of a dense W x W block M against NR right-hand-side
// columns R (row-major arrays), one routine for every block solve:
//   PIVOT: at each step t the first row i >= t of largest |A[i][t]| is
//     swapped into row t (the rgf recurrences, and the reference block CR's
//     `_small_solve(pivot=True)`);
//   SAFE: a zero pivot is replaced by 1 (the reference block CR's
//     `_small_solve`, both modes);
//   BACK: back substitution into X; false when only log|det M| is wanted.
// Returns log|det M| = sum_t log|pivot_t| (-inf at a zero pivot, as in the
// reference); callers that only solve discard it.
template <int W, int NR, bool PIVOT, bool SAFE, bool BACK = true>
__device__ __forceinline__ double block_solve(const double (&M)[W][W],
                                              const double (&R)[W][NR],
                                              double (&X)[W][NR]) {
  double A[W][W], Rr[W][NR];
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) A[i][j] = M[i][j];
#pragma unroll
    for (int k = 0; k < NR; ++k) Rr[i][k] = R[i][k];
  }
  double ld = 0.0;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    if constexpr (PIVOT) {
      int p = t;
      double best = fabs(A[t][t]);
#pragma unroll
      for (int i = t + 1; i < W; ++i) {
        if (fabs(A[i][t]) > best) { best = fabs(A[i][t]); p = i; }
      }
#pragma unroll
      for (int i = t + 1; i < W; ++i) {
        if (i == p) {
#pragma unroll
          for (int j = 0; j < W; ++j) { double s = A[t][j]; A[t][j] = A[i][j]; A[i][j] = s; }
#pragma unroll
          for (int k = 0; k < NR; ++k) { double s = Rr[t][k]; Rr[t][k] = Rr[i][k]; Rr[i][k] = s; }
        }
      }
    }
    const double piv = A[t][t];
    ld += log(fabs(piv));
    const double safe = (SAFE && piv == 0.0) ? 1.0 : piv;
#pragma unroll
    for (int i = t + 1; i < W; ++i) {
      const double f = A[i][t] / safe;
#pragma unroll
      for (int j = 0; j < W; ++j) A[i][j] -= f * A[t][j];
#pragma unroll
      for (int k = 0; k < NR; ++k) Rr[i][k] -= f * Rr[t][k];
    }
  }
  if constexpr (BACK) {
#pragma unroll
    for (int t = W - 1; t >= 0; --t) {
      const double piv = A[t][t];
      const double safe = (SAFE && piv == 0.0) ? 1.0 : piv;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        double acc = Rr[t][k];
#pragma unroll
        for (int u = t + 1; u < W; ++u) acc -= A[t][u] * X[u][k];
        X[t][k] = acc / safe;
      }
    }
  }
  return ld;
}

// C = A B for W x W blocks, fixed k order.
template <int W>
__device__ __forceinline__ void mm(const double (&A)[W][W],
                                   const double (&B)[W][W],
                                   double (&C)[W][W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      double acc = A[i][0] * B[0][j];
#pragma unroll
      for (int k = 1; k < W; ++k) acc += A[i][k] * B[k][j];
      C[i][j] = acc;
    }
  }
}

template <int W>
__device__ __forceinline__ void load_block(const double* p, double (&M)[W][W]) {
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) M[i][j] = p[i * W + j];
}

template <int W>
__device__ __forceinline__ void store_block(double* p, const double (&M)[W][W]) {
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) p[i * W + j] = M[i][j];
}

}  // namespace repro
