// Device functions shared by the backfitting solve kernels (mega_pcg.cu,
// jacobi.cu, gauss_seidel.cu), float64: the thread map, the gathered banded
// matvec and the cross-dimension total of the elementwise phases, the
// column-split block-CR solve, and the cooperative grid size. (mega_pcg.cu
// keeps its own inner products: the sweeps need none.)
//
// They act on (D, npad, B) state stacks in original point order, with the
// per-dimension bands (D, npad, 2w+1) and permutations (D, npad) of the
// padded operand stack (kernels/fused_sweep.py): sort[d, i] is the original
// row of sorted row i, rank its inverse. Elementwise phases map each thread
// to one RHS column and a row lane (coalesced over the contiguous column
// axis); every phase is called by every thread of a cooperative grid, and
// the caller separates phases that read each other's rows by a grid sync.
#pragma once

#include "common.cuh"
#include "cr.cuh"

namespace repro {

constexpr int SWEEP_NT = 256;  // threads per block of every solve kernel

// What every phase reads: the permutations and the stack's shape.
struct SweepDims {
  const int* sort;
  const int* rank;
  int D, npad, B;
};

// thread -> (column b, first row lane, row stride) for elementwise phases
struct Map {
  int b;
  long long r0, rs;
  bool on;
};

__device__ __forceinline__ Map make_map(int B) {
  const int rp = SWEEP_NT / B;
  Map m;
  m.on = threadIdx.x < rp * B;
  m.b = threadIdx.x % B;
  m.r0 = (long long)blockIdx.x * rp + threadIdx.x / B;
  m.rs = (long long)gridDim.x * rp;
  return m;
}

// dst[d,i,b] = sum_m band[d,i,w+m] * src[d, sort[d,i+m], b] for d in
// [d0, d1): the banded matvec of the sort-gathered state, in the
// reference's shift order m = -w..w
__device__ __forceinline__ void gather_mv(const SweepDims& S, const Map& m,
                                          double* dst, const double* src,
                                          const double* band, int w, int d0,
                                          int d1) {
  if (!m.on) return;
  const int B = S.B, wb = 2 * w + 1;
  const long long end = (long long)d1 * S.npad;
  for (long long row = (long long)d0 * S.npad + m.r0; row < end;
       row += m.rs) {
    const int d = (int)(row / S.npad);
    const int i = (int)(row - (long long)d * S.npad);
    const double* brow = band + row * wb;
    const int* sd = S.sort + (long long)d * S.npad;
    const double* sdim = src + (long long)d * S.npad * B;
    double acc = 0.0;
    for (int k = -w; k <= w; ++k) {
      const int ii = i + k;
      if (ii < 0 || ii >= S.npad) continue;
      acc += brow[w + k] * sdim[(long long)sd[ii] * B + m.b];
    }
    dst[row * B + m.b] = acc;
  }
}

__device__ __forceinline__ void gather_mv(const SweepDims& S, const Map& m,
                                          double* dst, const double* src,
                                          const double* band, int w) {
  gather_mv(S, m, dst, src, band, w, 0, S.D);
}

// dst[i,b] = sum_d src[d,i,b], d = 0..D-1 in order (each thread owns
// (row, column) pairs of the (npad, B) total)
__device__ __forceinline__ void sum_dims(const SweepDims& S, const Map& m,
                                         double* dst, const double* src) {
  if (!m.on) return;
  const int B = S.B;
  for (long long i = m.r0; i < S.npad; i += m.rs) {
    double acc = 0.0;
    for (int d = 0; d < S.D; ++d)
      acc += src[((long long)d * S.npad + i) * B + m.b];
    dst[i * B + m.b] = acc;
  }
}

// t <- band^{-1} t for the dimensions [d0, d1), with the columns spread over
// blocks: the (dimension, column chunk) items go to the first `nslots`
// blocks, each with its own 3 * sstride doubles of block scratch. The
// columns of a solve are independent and every block computes the same
// block values, so the result is the same as one block per dimension.
template <bool PIVOT>
__device__ void solve_cols(const SweepDims& S, const Map& m, double* t,
                           const double* band, int w, int d0, int d1,
                           double* scratch, long long sstride, int nslots) {
  const int B = S.B;
  if (w == 0) {
    if (!m.on) return;
    const long long end = (long long)d1 * S.npad;
    for (long long row = (long long)d0 * S.npad + m.r0; row < end;
         row += m.rs)
      t[row * B + m.b] /= band[row];
    return;
  }
  if ((int)blockIdx.x >= nslots) return;
  const int nd = d1 - d0;
  const int cpc = (nd * B + nslots - 1) / nslots;  // columns per item
  const int chunks = (B + cpc - 1) / cpc;
  const long long per = (long long)S.npad * B;
  const long long bper = (long long)S.npad * (2 * w + 1);
  double* ab = scratch + (long long)blockIdx.x * 3 * sstride;
  double* bb = ab + sstride;
  double* cb = bb + sstride;
  for (int item = blockIdx.x; item < nd * chunks; item += nslots) {
    const int d = d0 + item / chunks;
    const int c0 = (item % chunks) * cpc;
    const int nc = B - c0 < cpc ? B - c0 : cpc;
    const double* bd = band + d * bper;
    double* td = t + d * per + c0;
    switch (w) {
      case 1:
        cr_block_solve<1, PIVOT>(bd, td, ab, bb, cb, S.npad, nc, nullptr,
                                 nullptr, B);
        break;
      case 2:
        cr_block_solve<2, PIVOT>(bd, td, ab, bb, cb, S.npad, nc, nullptr,
                                 nullptr, B);
        break;
      default:
        cr_block_solve<3, PIVOT>(bd, td, ab, bb, cb, S.npad, nc, nullptr,
                                 nullptr, B);
        break;
    }
  }
}

// Cooperative grid size for `kernel`: every SM's co-resident blocks, at
// most `max_per_sm` each; an error code if the card cannot co-schedule one
// block per SM or does not support cooperative launches.
template <typename K>
inline int cooperative_blocks(K kernel, int max_per_sm, int* out) {
  int dev = 0, sms = 0, coop = 0, per = 0;
  REPRO_RETURN_IF_ERR(cudaGetDevice(&dev));
  REPRO_RETURN_IF_ERR(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  REPRO_RETURN_IF_ERR(
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return (int)cudaErrorNotSupported;
  REPRO_RETURN_IF_ERR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, kernel, SWEEP_NT, 0));
  if (per < 1) return (int)cudaErrorLaunchOutOfResources;
  *out = sms * (per < max_per_sm ? per : max_per_sm);
  return 0;
}

}  // namespace repro
