// Kernel Packet Gram band Phi = A K (paper Algorithm 2) without forming K,
// float64.
//
// Replaces: src/repro/kernels/kp_gram.py, kp_gram_pallas (kernel body
// `_kernel`), reached through the kernels layer's op kp_gram:
//
//   Phi[i,q+m] = sum_{t=-(q+1)..q+1} A[i,q+1+t] k_q(omega |x_{i+m} - x_{i+t}|)
//
// for m in [-q, q]; terms whose row i+t lies outside [0, n) are dropped and
// outputs whose i+m does are zero (the Pallas kernel's `valid` masks, not
// clipped indices). k_q(u) = exp(-u) * poly_q(2u) with the half-integer
// Matern coefficients handed in by the caller (core/matern.py).
//
// What bounds it on the H100: bytes, counting an exp as one operation. Per
// row it reads x and 2q+3 coefficients and writes 2q+1 outputs (104 bytes
// at q = 2, 136 at q = 3) and evaluates (2q+1)(2q+3) kernels, each an exp and
// a degree-q polynomial: ~4 operations a byte at q = 2, under the card's
// ~10 (FP64 rate over memory rate); an exp's real cost (a few dozen FP64
// instructions) would put q = 2 on the operations side. At the path's n
// one launch moves ~1-3 MB, so launch latency dominates.
//
// Design: one thread per row, 256 rows per block. The block stages its x
// window, with a halo of q+1 on each side (zero outside [0, n)), in shared
// memory; each thread evaluates its (2q+1) x (2q+3) kernels in registers in
// the Pallas kernel's order (t inner, ascending) and writes its row once.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXQ = 3;
constexpr int HALO = MAXQ + 1;

struct Coeffs {
  double c[MAXQ + 1];
};

template <int Q>
__global__ void __launch_bounds__(NT)
    kp_gram_kernel(const double* __restrict__ xs, const double* __restrict__ a,
                   double* __restrict__ phi, int n, double omega, Coeffs cf) {
  constexpr int LO = Q + 1, WA = 2 * Q + 3, WP = 2 * Q + 1;
  __shared__ double xw[NT + 2 * HALO];
  const int i0 = blockIdx.x * NT;
  for (int k = threadIdx.x; k < NT + 2 * LO; k += NT) {
    const int j = i0 - LO + k;
    xw[k] = (j >= 0 && j < n) ? xs[j] : 0.0;
  }
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= n) return;
  const double* arow = a + (long long)i * WA;
  double av[WA];
#pragma unroll
  for (int t = 0; t < WA; ++t) av[t] = arow[t];
  const double* xc = xw + LO + threadIdx.x;  // xc[k] = x_{i+k}
  double out[WP];
#pragma unroll
  for (int m = -Q; m <= Q; ++m) {
    const double xm = xc[m];
    double acc = 0.0;
#pragma unroll
    for (int t = -LO; t <= LO; ++t) {
      if (i + t < 0 || i + t >= n) continue;
      const double u = omega * fabs(xm - xc[t]);
      double poly = cf.c[Q];
#pragma unroll
      for (int k = Q - 1; k >= 0; --k) poly = poly * (2.0 * u) + cf.c[k];
      acc += av[LO + t] * (exp(-u) * poly);
    }
    out[Q + m] = (i + m >= 0 && i + m < n) ? acc : 0.0;
  }
  double* prow = phi + (long long)i * WP;
#pragma unroll
  for (int k = 0; k < WP; ++k) prow[k] = out[k];
}

}  // namespace

// xs (n,) sorted, a (n, 2q+3) -> phi (n, 2q+1); c0..c3 the Matern
// polynomial's coefficients (those above q unused). q in {0, 1, 2, 3}.
extern "C" int repro_kp_gram_f64(const double* xs, const double* a,
                                 double* phi, int n, int q, double omega,
                                 double c0, double c1, double c2, double c3,
                                 void* stream) {
  if (n < 1 || q < 0 || q > MAXQ) return (int)cudaErrorInvalidValue;
  const Coeffs cf{{c0, c1, c2, c3}};
  const int grid = (n + NT - 1) / NT;
  cudaStream_t s = (cudaStream_t)stream;
  switch (q) {
    case 0:
      kp_gram_kernel<0><<<grid, NT, 0, s>>>(xs, a, phi, n, omega, cf);
      break;
    case 1:
      kp_gram_kernel<1><<<grid, NT, 0, s>>>(xs, a, phi, n, omega, cf);
      break;
    case 2:
      kp_gram_kernel<2><<<grid, NT, 0, s>>>(xs, a, phi, n, omega, cf);
      break;
    default:
      kp_gram_kernel<3><<<grid, NT, 0, s>>>(xs, a, phi, n, omega, cf);
      break;
  }
  return (int)cudaGetLastError();
}
