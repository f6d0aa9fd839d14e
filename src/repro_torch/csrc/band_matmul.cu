// Band x band matrix product in band form, float64.
//
// Replaces: src/repro/kernels/band_matmul.py, band_matmul_pallas (kernel
// body `_kernel`), which forms H = A Phi^T for the posterior-variance band.
//
//   C[i, i+m] = sum_t A[i, i+t] * B[i+t, i+m],   t in [-a_lo, a_hi]
//
// What bounds it on the H100: bytes. Each output row reads one A row and
// wa rows of B (neighbours, mostly from L1/L2) and writes wa + wb - 1
// values; a few FMAs per byte, far below the card's compute rate.
//
// Design: one thread per output row over the flattened (G, n) rows, in a
// grid-stride loop; the output row is accumulated in registers in the
// reference's (t outer, s inner) order and written once. Rows of B outside
// [0, n) count as zero, as the Pallas kernel's zero halo blocks do.
#include "common.cuh"

namespace {

constexpr int MAXW = 9;            // wa, wb <= MAXW
constexpr int MAXWC = 2 * MAXW - 1;

__global__ void band_matmul_kernel(const double* __restrict__ a,
                                   const double* __restrict__ b,
                                   double* __restrict__ c, long long rows,
                                   int n, int a_lo, int a_hi, int b_lo,
                                   int b_hi) {
  const int wa = a_lo + a_hi + 1, wb = b_lo + b_hi + 1, wc = wa + wb - 1;
  const int lo = a_lo + b_lo;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < rows; row += stride) {
    const long long g = row / n;
    const int i = (int)(row - g * n);
    double acc[MAXWC];
    for (int k = 0; k < wc; ++k) acc[k] = 0.0;
    for (int t = -a_lo; t <= a_hi; ++t) {
      const int it = i + t;
      if (it < 0 || it >= n) continue;
      const double av = a[row * wa + a_lo + t];
      const double* brow = b + (g * n + it) * wb;
      for (int s = -b_lo; s <= b_hi; ++s) acc[lo + t + s] += av * brow[b_lo + s];
    }
    for (int k = 0; k < wc; ++k) c[row * wc + k] = acc[k];
  }
}

}  // namespace

extern "C" int repro_band_matmul_f64(const double* a, const double* b,
                                     double* c, int G, int n, int a_lo,
                                     int a_hi, int b_lo, int b_hi,
                                     void* stream) {
  if (a_lo < 0 || a_hi < 0 || b_lo < 0 || b_hi < 0 ||
      a_lo + a_hi + 1 > MAXW || b_lo + b_hi + 1 > MAXW || G < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)G * n;
  band_matmul_kernel<<<repro::stride_blocks(rows, 256), 256, 0,
                       (cudaStream_t)stream>>>(a, b, c, rows, n, a_lo, a_hi,
                                               b_lo, b_hi);
  return (int)cudaGetLastError();
}
