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

// Solve M X = R for a dense W x W block against NR right-hand-side columns
// by Gaussian elimination with partial pivoting (row-major arrays). This is
// the rgf recurrences' block solve.
template <int W, int NR>
__device__ __forceinline__ void solve_pivot(const double (&M)[W][W],
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
#pragma unroll
  for (int t = 0; t < W; ++t) {
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
#pragma unroll
    for (int i = t + 1; i < W; ++i) {
      double f = A[i][t] / A[t][t];
#pragma unroll
      for (int j = t; j < W; ++j) A[i][j] -= f * A[t][j];
#pragma unroll
      for (int k = 0; k < NR; ++k) Rr[i][k] -= f * Rr[t][k];
    }
  }
#pragma unroll
  for (int t = W - 1; t >= 0; --t) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      double acc = Rr[t][k];
#pragma unroll
      for (int u = t + 1; u < W; ++u) acc -= A[t][u] * X[u][k];
      X[t][k] = acc / A[t][t];
    }
  }
}

// Unpivoted Gaussian elimination of a W x W block against NR columns; a
// zero pivot is replaced by 1 (the reference's block-CR `_small_solve`).
template <int W, int NR>
__device__ __forceinline__ void solve_nopivot(const double (&M)[W][W],
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
#pragma unroll
  for (int t = 0; t < W; ++t) {
    double piv = A[t][t];
    double safe = piv == 0.0 ? 1.0 : piv;
#pragma unroll
    for (int i = t + 1; i < W; ++i) {
      double f = A[i][t] / safe;
#pragma unroll
      for (int j = 0; j < W; ++j) A[i][j] -= f * A[t][j];
#pragma unroll
      for (int k = 0; k < NR; ++k) Rr[i][k] -= f * Rr[t][k];
    }
  }
#pragma unroll
  for (int t = W - 1; t >= 0; --t) {
    double piv = A[t][t];
    double safe = piv == 0.0 ? 1.0 : piv;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      double acc = Rr[t][k];
#pragma unroll
      for (int u = t + 1; u < W; ++u) acc -= A[t][u] * X[u][k];
      X[t][k] = acc / safe;
    }
  }
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
