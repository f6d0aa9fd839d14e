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
// What bounds it on the H100: bytes. Per row it reads x and 2q+3
// coefficients and writes 2q+1 outputs (136 bytes at q = 3). A row's pairs
// (i+m, i+t) are pairs of points at most 2q+1 apart, and each recurs in the
// neighbouring rows, so only 2q+1 distinct kernel values a point are needed
// (an exp and a degree-q polynomial each: ~20 FP64 operations), ~1 operation
// a byte, far under the card's ~10 (FP64 rate over memory rate). At the
// path's n one launch moves ~1-4 MB, under a microsecond at the memory
// rate, so the launch and the chain of dependent phases decide the time.
//
// Design: NT = 128 rows a block (235 blocks at n = 30000, so every one of
// the 132 SMs has work). Each thread issues all its global loads at once
// (its share of the x window, with a halo of q+1 on each side and zero
// outside [0, n), and of the block's A rows, read as whole sectors) before
// storing them to shared memory: a load loop with a run-time trip count
// waits out one memory latency an iteration. The block then evaluates the
// distinct kernel values once,
//   K[j, d] = k_q(omega |x_j - x_{j+d}|), d = 1..2q+1,
// over the window into shared memory, and each thread contracts its row's
// (2q+1)(2q+3) terms from K in the Pallas kernel's order (t ascending for
// each m); d = 0 is c0, which the expression gives at distance 0 for any
// finite omega. The rows'
// Phi is written back through the shared buffer of A, so the stores are
// whole sectors too.
//
// Bits: |x_a - x_b| == |x_b - x_a| exactly, and every rounding is pinned
// (the Horner step and the accumulation as fused multiply-adds, the exp
// times the polynomial as a product), so Phi equals, bit for bit, a
// thread-per-row evaluation of every (2q+1)(2q+3) term with those roundings.
#include "common.cuh"

namespace {

constexpr int NT = 128;
constexpr int MAXQ = 3;

struct Coeffs {
  double c[MAXQ + 1];
};

template <int Q>
__device__ __forceinline__ double matern(double u, const Coeffs& cf) {
  double poly = cf.c[Q];
#pragma unroll
  for (int k = Q - 1; k >= 0; --k) poly = __fma_rn(poly, 2.0 * u, cf.c[k]);
  return __dmul_rn(exp(-u), poly);
}

template <int Q>
__global__ void __launch_bounds__(NT)
    kp_gram_kernel(const double* __restrict__ xs, const double* __restrict__ a,
                   double* __restrict__ phi, int n, double omega, Coeffs cf) {
  constexpr int LO = Q + 1, WA = 2 * Q + 3, WP = 2 * Q + 1;
  constexpr int NX = NT + 2 * LO;  // x_j, j = i0 - LO + r
  constexpr int ND = 2 * Q + 1;    // distances 1..2Q+1
  constexpr int NK = NT + 2 * Q + 1;  // rows of K: the lower points of pairs
  constexpr int SX = (NX + NT - 1) / NT, SK = (NK * ND + NT - 1) / NT;
  __shared__ double xw[NX];
  __shared__ double kw[NK * ND];  // kw[r ND + d - 1] = K[i0 - LO + r, d]
  __shared__ double rows_s[NT * WA];  // the block's A rows, then its Phi rows
  const int tid = threadIdx.x, i0 = blockIdx.x * NT, i = i0 + tid;
  const int nr = min(NT, n - i0);
  // every global load of the block in flight at once, then into shared
  const double* ab = a + (long long)i0 * WA;
  double xv[SX], av[WA];
#pragma unroll
  for (int s = 0; s < SX; ++s) {
    const int k = tid + s * NT, j = i0 - LO + k;
    xv[s] = (k < NX && j >= 0 && j < n) ? xs[j] : 0.0;
  }
#pragma unroll
  for (int s = 0; s < WA; ++s) {
    const int k = tid + s * NT;
    av[s] = k < nr * WA ? ab[k] : 0.0;
  }
#pragma unroll
  for (int s = 0; s < SX; ++s)
    if (tid + s * NT < NX) xw[tid + s * NT] = xv[s];
#pragma unroll
  for (int s = 0; s < WA; ++s) rows_s[tid + s * NT] = av[s];
  __syncthreads();
  // the pairs the rows use: lower point r, upper r + d within the window
#pragma unroll
  for (int s = 0; s < SK; ++s) {
    const int k = tid + s * NT, r = k / ND, d = k - r * ND + 1;
    if (k < NK * ND && r + d < NX)
      kw[k] = matern<Q>(omega * fabs(xw[r] - xw[r + d]), cf);
  }
  __syncthreads();
  double out[WP];
  if (tid < nr) {
#pragma unroll
    for (int t = 0; t < WA; ++t) av[t] = rows_s[tid * WA + t];
    // K row of the pair (i + min(m, t), i + max(m, t)): tid + LO + min(m, t)
    const double* kr = kw + (tid + LO) * ND - 1;
#pragma unroll
    for (int m = -Q; m <= Q; ++m) {
      double acc = 0.0;
#pragma unroll
      for (int t = -LO; t <= LO; ++t) {
        if (i + t < 0 || i + t >= n) continue;
        const int lo = m < t ? m : t, d = m < t ? t - m : m - t;
        const double kv = d == 0 ? cf.c[0] : kr[lo * ND + d];
        acc = __fma_rn(av[LO + t], kv, acc);
      }
      out[Q + m] = (i + m >= 0 && i + m < n) ? acc : 0.0;
    }
  }
  __syncthreads();  // every A row read before Phi takes its place
  if (tid < nr) {
#pragma unroll
    for (int k = 0; k < WP; ++k) rows_s[tid * WP + k] = out[k];
  }
  __syncthreads();
  double* pb = phi + (long long)i0 * WP;
#pragma unroll
  for (int s = 0; s < WP; ++s) {
    const int k = tid + s * NT;
    if (k < nr * WP) pb[k] = rows_s[k];
  }
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
