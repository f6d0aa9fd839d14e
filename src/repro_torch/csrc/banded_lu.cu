// Banded LU solve without pivoting, plus log|det|, float64.
//
// Replaces: src/repro/kernels/banded_lu.py, banded_lu_pallas (kernel body
// `_kernel`), which the serving path reaches for every solve with a
// diagonal band (Phi and Phi^T at q = 0).
//
// What bounds it on the H100: at lo = hi = 0 (the serving path) the solve
// is x = rhs / d, pure streaming: bytes (read band + rhs, write x) over the
// 3.35 TB/s memory rate. The general (lo, hi) recurrence is sequential in
// the row index, so it is latency-bound: one dependent chain of n steps.
//
// Design: the diagonal case runs a grid-stride elementwise kernel over all
// G*n*B entries (coalesced, every SM busy) and a one-block-per-matrix
// fixed-order reduction for the log-determinant. The general case runs one
// block per matrix with one thread per right-hand-side column; every
// thread recomputes the (RHS-independent) U rows in registers, so the
// forward sweep needs no synchronisation, and thread 0 stores U for the
// back substitution that follows a single __syncthreads.
#include "common.cuh"

namespace {

constexpr int MAXW = 8;  // lo, hi <= MAXW - 1

__global__ void diag_solve_kernel(const double* __restrict__ band,
                                  const double* __restrict__ rhs,
                                  double* __restrict__ x, long long total,
                                  int B) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    x[e] = rhs[e] / band[e / B];
  }
}

__global__ void diag_logdet_kernel(const double* __restrict__ band,
                                   double* __restrict__ ld, int n) {
  __shared__ double s[256];
  const double* bg = band + (long long)blockIdx.x * n;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += log(fabs(bg[i]));
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) ld[blockIdx.x] = s[0];
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

extern "C" int repro_banded_lu_f64(const double* band, const double* rhs,
                                   double* x, double* ld, double* ubuf, int G,
                                   int n, int lo, int hi, int B,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (lo < 0 || hi < 0 || lo >= MAXW || hi >= MAXW || G < 1 || n < 1 ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  if (lo == 0 && hi == 0) {
    const long long total = (long long)G * n * B;
    diag_solve_kernel<<<repro::stride_blocks(total, 256), 256, 0, st>>>(
        band, rhs, x, total, B);
    REPRO_RETURN_IF_ERR(cudaGetLastError());
    diag_logdet_kernel<<<G, 256, 0, st>>>(band, ld, n);
    return (int)cudaGetLastError();
  }
  int threads = B < 128 ? B : 128;
  threads = ((threads + 31) / 32) * 32;
  lu_general_kernel<<<G, threads, 0, st>>>(band, rhs, x, ld, ubuf, n, lo, hi,
                                           B);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
