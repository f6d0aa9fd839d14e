// Band x band matrix product in band form, float64.
//
// Replaces: src/repro/kernels/band_matmul.py, band_matmul_pallas (kernel
// body `_kernel`), which forms H = A Phi^T for the posterior-variance band.
//
//   C[i, i+m] = sum_t A[i, i+t] * B[i+t, i+m],   t in [-a_lo, a_hi]
//
// What bounds it on the H100: bytes. Each output row reads one A row and
// wa rows of B (neighbours, shared with the next rows) and writes
// wa + wb - 1 values; a few FMAs per byte, far below the card's compute
// rate. At the serving path's widths (wa = 3, wb = 1, n = 30000, 10 bands)
// the bound is ~5 us.
//
// Design: a 2-D grid of (row tile, band) blocks, no 64-bit division. A
// block stages its tile's A rows and the B rows they reach (the halo,
// rows outside [0, n) never read) into shared memory with coalesced
// loads, computes each output row in registers (one thread a row, several
// rows a thread; the widths are template parameters, so the accumulator
// is unrolled into registers, not a local-memory array), stages C in
// shared memory and writes it back coalesced. Each output is accumulated
// in the reference's (t outer, s inner) order with the same expression as
// before, so its bits do not change; a term whose B row lies outside
// [0, n) is skipped, as the Pallas kernel's zero halo blocks leave it out.
#include "common.cuh"

namespace {

constexpr int MAXW = 9;  // wa, wb <= MAXW
constexpr int THREADS = 128;
constexpr int MAX_RPT = 4;            // rows a thread at most
constexpr int SMEM_BYTES = 48 * 1024;  // static shared-memory limit

// shared memory of a tile of R rows: A (R wa), B with its halo
// ((R + wa - 1) wb), C (R wc)
__host__ __device__ inline int tile_smem(int R, int wa, int wb) {
  return 8 * (R * wa + (R + wa - 1) * wb + R * (wa + wb - 1));
}

template <int WA, int WB>
__global__ void __launch_bounds__(THREADS)
    band_matmul_kernel(const double* __restrict__ a,
                       const double* __restrict__ b, double* __restrict__ c,
                       int n, int a_lo, int R) {
  constexpr int WC = WA + WB - 1;
  extern __shared__ double sm[];
  double* sa = sm;
  double* sb = sa + R * WA;
  double* sc = sb + (R + WA - 1) * WB;
  const int r0 = blockIdx.x * R;
  const int rows = min(R, n - r0);
  const long long base = (long long)blockIdx.y * n;
  const int h0 = max(r0 - a_lo, 0);
  const int h1 = min(r0 + rows + (WA - 1 - a_lo), n);
  const double* ag = a + (base + r0) * WA;
  const double* bg = b + (base + h0) * WB;
  for (int x = threadIdx.x; x < rows * WA; x += THREADS) sa[x] = ag[x];
  for (int x = threadIdx.x; x < (h1 - h0) * WB; x += THREADS) sb[x] = bg[x];
  __syncthreads();
  for (int li = threadIdx.x; li < rows; li += THREADS) {
    const int i = r0 + li;
    double acc[WC];
#pragma unroll
    for (int k = 0; k < WC; ++k) acc[k] = 0.0;
#pragma unroll
    for (int ta = 0; ta < WA; ++ta) {  // t = ta - a_lo
      const int it = i + ta - a_lo;
      if (it < 0 || it >= n) continue;
      const double av = sa[li * WA + ta];
      const double* brow = sb + (it - h0) * WB;
#pragma unroll
      for (int s = 0; s < WB; ++s) acc[ta + s] += av * brow[s];
    }
#pragma unroll
    for (int k = 0; k < WC; ++k) sc[li * WC + k] = acc[k];
  }
  __syncthreads();
  double* cg = c + (base + r0) * WC;
  for (int x = threadIdx.x; x < rows * WC; x += THREADS) cg[x] = sc[x];
}

template <int WA, int WB>
int launch(const double* a, const double* b, double* c, int G, int n,
           int a_lo, cudaStream_t st) {
  int rpt = MAX_RPT;
  while (rpt > 1 && tile_smem(rpt * THREADS, WA, WB) > SMEM_BYTES) rpt /= 2;
  const int R = rpt * THREADS;
  const dim3 grid((n + R - 1) / R, G);
  band_matmul_kernel<WA, WB><<<grid, THREADS, tile_smem(R, WA, WB), st>>>(
      a, b, c, n, a_lo, R);
  return (int)cudaGetLastError();
}

template <int WA>
int launch_wb(int wb, const double* a, const double* b, double* c, int G,
              int n, int a_lo, cudaStream_t st) {
  switch (wb) {
    case 1: return launch<WA, 1>(a, b, c, G, n, a_lo, st);
    case 2: return launch<WA, 2>(a, b, c, G, n, a_lo, st);
    case 3: return launch<WA, 3>(a, b, c, G, n, a_lo, st);
    case 4: return launch<WA, 4>(a, b, c, G, n, a_lo, st);
    case 5: return launch<WA, 5>(a, b, c, G, n, a_lo, st);
    case 6: return launch<WA, 6>(a, b, c, G, n, a_lo, st);
    case 7: return launch<WA, 7>(a, b, c, G, n, a_lo, st);
    case 8: return launch<WA, 8>(a, b, c, G, n, a_lo, st);
    case 9: return launch<WA, 9>(a, b, c, G, n, a_lo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_band_matmul_f64(const double* a, const double* b,
                                     double* c, int G, int n, int a_lo,
                                     int a_hi, int b_lo, int b_hi,
                                     void* stream) {
  const int wa = a_lo + a_hi + 1, wb = b_lo + b_hi + 1;
  if (a_lo < 0 || a_hi < 0 || b_lo < 0 || b_hi < 0 || wa > MAXW ||
      wb > MAXW || G < 1 || G > 65535 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (wa) {
    case 1: return launch_wb<1>(wb, a, b, c, G, n, a_lo, st);
    case 2: return launch_wb<2>(wb, a, b, c, G, n, a_lo, st);
    case 3: return launch_wb<3>(wb, a, b, c, G, n, a_lo, st);
    case 4: return launch_wb<4>(wb, a, b, c, G, n, a_lo, st);
    case 5: return launch_wb<5>(wb, a, b, c, G, n, a_lo, st);
    case 6: return launch_wb<6>(wb, a, b, c, G, n, a_lo, st);
    case 7: return launch_wb<7>(wb, a, b, c, G, n, a_lo, st);
    case 8: return launch_wb<8>(wb, a, b, c, G, n, a_lo, st);
    case 9: return launch_wb<9>(wb, a, b, c, G, n, a_lo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
