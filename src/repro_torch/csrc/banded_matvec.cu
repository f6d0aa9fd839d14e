// Banded matrix times a block of vectors, float64.
//
// Replaces: src/repro/kernels/banded_matvec.py, banded_matvec_pallas
// (kernel body `_kernel`):
//     y[g, i, b] = sum_{m=-lo..hi} band[g, i, lo+m] * x[g, i+m, b],
// with zero outside rows [0, n). The likelihood path runs it for A u and
// Phi u in every application of the Taylor log-determinant's operator and
// for Psi v in the gradients' dK applications.
//
// What bounds it on the H100: bytes. Each output reads lo+hi+1 band entries
// and as many x entries and does 2(lo+hi+1) flops, far below the card's
// ~10 flops per byte of float64 balance; one pass over band, x and y over
// the 3.35 TB/s memory rate is the floor.
//
// Design: one thread per output element, the column b fastest, so a warp
// reads neighbouring addresses of the row-major (G, n, B) x and y, and the
// threads of one row share its band entries through the cache. The halo
// rows i+m of a tile are plain loads from device memory (most of them L1/L2
// hits from the neighbouring threads): the reference's prev/cur/next VMEM
// tiles have no counterpart to build. Grid: (row tiles, g).
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int PER_THREAD = 4;  // outputs per thread (grid-stride)
constexpr int MAX_HALF = 8;    // lo, hi <= 8, as the reference documents

__global__ void __launch_bounds__(NT)
    banded_matvec_kernel(const double* __restrict__ band,
                         const double* __restrict__ x, double* __restrict__ y,
                         int n, int B, int lo, int hi) {
  const int g = blockIdx.y;
  const int w = lo + hi + 1;
  const long long per = (long long)n * B;
  const double* bg = band + (long long)g * n * w;
  const double* xg = x + (long long)g * per;
  double* yg = y + (long long)g * per;
  const long long stride = (long long)gridDim.x * NT;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < per;
       e += stride) {
    const int i = (int)(e / B);
    const int b = (int)(e - (long long)i * B);
    const double* brow = bg + (long long)i * w;
    double acc = 0.0;
    for (int m = -lo; m <= hi; ++m) {
      const int j = i + m;
      if (j >= 0 && j < n) acc += brow[lo + m] * xg[(long long)j * B + b];
    }
    yg[e] = acc;
  }
}

}  // namespace

extern "C" int repro_banded_matvec_f64(const double* band, const double* x,
                                       double* y, int G, int n, int lo,
                                       int hi, int B, void* stream) {
  if (G < 1 || G > 65535 || n < 1 || B < 1 || lo < 0 || hi < 0 ||
      lo > MAX_HALF || hi > MAX_HALF)
    return (int)cudaErrorInvalidValue;
  const long long per = (long long)n * B;
  const int tiles = repro::stride_blocks(per, NT * PER_THREAD, 1 << 20);
  banded_matvec_kernel<<<dim3(tiles, G), NT, 0, (cudaStream_t)stream>>>(
      band, x, y, n, B, lo, hi);
  return (int)cudaGetLastError();
}
