// Device functions shared by the backfitting solve kernels (mega_pcg.cu,
// jacobi.cu, gauss_seidel.cu), float64: the thread map, the gathered banded
// matvec and the cross-dimension total of the elementwise phases, the
// column-split block-CR solve from a stored factor (apply_cols), the
// column-chunked layout of its operand (chunk_col), the chunk width of
// apply_cols (auto_cols) and the cooperative grid size.
// (mega_pcg.cu keeps its own inner products: the sweeps need none.)
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
// (tenant, column) pairs of one launch over a stack of T systems
constexpr int MAX_TB = 4096;

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

// rows each thread of the PCG kernel's elementwise phases takes at a time
// (for_rows)
constexpr int ROW_ILP = 2;

// The thread's rows of [begin, end) in order, U at a time: load(u, row) for
// each of the U rows first, then use(u, row) for each in row order. The U
// rows' loads are in flight together (the compiler may not move one row's
// loads above the previous row's stores, which it cannot tell apart), while
// every row's arithmetic, and any sum over the rows, keeps the row order of
// a plain loop. U = 1 is that plain loop.
template <int U, typename Load, typename Use>
__device__ __forceinline__ void for_rows(const Map& m, long long begin,
                                         long long end, Load&& load,
                                         Use&& use) {
  for (long long r0 = begin + m.r0; r0 < end; r0 += U * m.rs) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * m.rs < end) load(u, r0 + u * m.rs);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * m.rs < end) use(u, r0 + u * m.rs);
  }
}

// store(row, sum_m band[d,i,w+m] * src[d, sort[d,i+m], b]) for the rows
// d * npad + i of the dimensions [d0, d1), column b = m.b: the banded
// matvec of the sort-gathered state, in the reference's shift order
// m = -w..w; U rows at a time (for_rows)
template <int U = 1, typename Store>
__device__ __forceinline__ void gather_mv_to(const SweepDims& S,
                                             const Map& m, const double* src,
                                             const double* band, int w,
                                             int d0, int d1, Store&& store) {
  if (!m.on) return;
  const int B = S.B, wb = 2 * w + 1;
  double acc[U];
  for_rows<U>(
      m, (long long)d0 * S.npad, (long long)d1 * S.npad,
      [&](int u, long long row) {
        const int d = (int)(row / S.npad);
        const int i = (int)(row - (long long)d * S.npad);
        const double* brow = band + row * wb;
        const int* sd = S.sort + (long long)d * S.npad;
        const double* sdim = src + (long long)d * S.npad * B;
        double a = 0.0;
        for (int k = -w; k <= w; ++k) {
          const int ii = i + k;
          if (ii < 0 || ii >= S.npad) continue;
          a += brow[w + k] * sdim[(long long)sd[ii] * B + m.b];
        }
        acc[u] = a;
      },
      [&](int u, long long row) { store(row, acc[u]); });
}

// dst[d,i,b] = the gathered matvec of gather_mv_to, dst (D, npad, B)
template <int U = 1>
__device__ __forceinline__ void gather_mv(const SweepDims& S, const Map& m,
                                          double* dst, const double* src,
                                          const double* band, int w, int d0,
                                          int d1) {
  gather_mv_to<U>(S, m, src, band, w, d0, d1, [&](long long row, double a) {
    dst[row * S.B + m.b] = a;
  });
}

template <int U = 1>
__device__ __forceinline__ void gather_mv(const SweepDims& S, const Map& m,
                                          double* dst, const double* src,
                                          const double* band, int w) {
  gather_mv<U>(S, m, dst, src, band, w, 0, S.D);
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

// dst[t,i,b] = sum_d src[t,d,i,b], d = 0..Dt-1 in order, for every tenant
// t of a stack of T tenants of Dt dimensions each (S.D = T Dt): sum_dims
// within each tenant, tenant by tenant (T = 1 is sum_dims)
__device__ __forceinline__ void sum_dims_tenants(const SweepDims& S,
                                                 const Map& m, double* dst,
                                                 const double* src, int T,
                                                 int Dt) {
  if (!m.on) return;
  const int B = S.B;
  for (int t = 0; t < T; ++t)
    for (long long i = m.r0; i < S.npad; i += m.rs) {
      double acc = 0.0;
      for (int d = 0; d < Dt; ++d)
        acc += src[(((long long)t * Dt + d) * S.npad + i) * B + m.b];
      dst[((long long)t * S.npad + i) * B + m.b] = acc;
    }
}

// t <- t / band over the rows of the dimensions [d0, d1): the solve with a
// diagonal band (w = 0); U rows at a time (for_rows)
template <int U = 1>
__device__ __forceinline__ void div_rows(const SweepDims& S, const Map& m,
                                         double* t, const double* band,
                                         int d0, int d1) {
  if (!m.on) return;
  double tv[U], bv[U];
  for_rows<U>(
      m, (long long)d0 * S.npad, (long long)d1 * S.npad,
      [&](int u, long long row) {
        tv[u] = t[row * S.B + m.b];
        bv[u] = band[row];
      },
      [&](int u, long long row) { t[row * S.B + m.b] = tv[u] / bv[u]; });
}

// Where element (i, b) of one dimension's (npad, B) block lies when the
// block is stored in column chunks of cpc (CHUNKED below): chunk c holds the
// columns c0 = c cpc ... c0 + nc - 1, nc = min(cpc, B - c0), as an (npad,
// nc) row-major block at offset c0 npad, so a chunk's rows are nc
// contiguous doubles (one at cpc = 1, where the block is column-major).
// Returns the column's offset; the element is at offset + i * *nc.
__device__ __forceinline__ long long chunk_col(int b, int npad, int B,
                                               int cpc, int* nc) {
  const int c0 = b - b % cpc;
  *nc = B - c0 < cpc ? B - c0 : cpc;
  return (long long)c0 * npad + (b - c0);
}

// t <- band^{-1} t for the dimensions [d0, d1) from the bands' block-CR
// factors (`fac`: one cr_block_factor per dimension, cr_factor_size(npad /
// w, w) doubles each), with the (dimension, chunk of `cpc` columns) items
// spread over every block of the grid; w = 0 divides by the diagonal. The
// factor is read only, so the blocks need no scratch, and each item's
// result has the bits of eliminating the band itself (cr.cuh). The
// division takes ROW_ILP rows at a time. CHUNKED: each dimension of t is
// stored in column chunks of cpc (chunk_col), so an item reads and writes
// whole rows of its own chunk rather than cpc of every row's B doubles;
// it takes w >= 1 only (the division reads t row-major). MAXW is the
// widest band the instantiation solves: 3 (every band up to q = 2) or 4
// (q = 3's A and SAPhi). Each has its own switch, so the narrow kernels'
// machine code holds no w = 4 case. dstep > 1 solves the dimensions d0,
// d0 + dstep, ... below d1 only (one dimension of each tenant of a stack
// whose tenants have dstep dimensions each).
template <bool PIVOT, bool CHUNKED = false, int MAXW = 3>
__device__ void apply_cols(const SweepDims& S, const Map& m, double* t,
                           const double* band, const double* fac, int w,
                           int d0, int d1, int cpc, int dstep = 1) {
  static_assert(MAXW == 3 || MAXW == 4, "MAXW is 3 or 4");
  const int B = S.B;
  if (w == 0) {
    if (dstep == 1) {
      div_rows<ROW_ILP>(S, m, t, band, d0, d1);
    } else {
      for (int d = d0; d < d1; d += dstep)
        div_rows<ROW_ILP>(S, m, t, band, d, d + 1);
    }
    return;
  }
  const int chunks = (B + cpc - 1) / cpc;
  const int nd = (d1 - d0 + dstep - 1) / dstep;
  const long long per = (long long)S.npad * B;
  const long long fper = cr_factor_size(S.npad / w, w);
  for (int item = blockIdx.x; item < nd * chunks; item += gridDim.x) {
    const int d = d0 + (item / chunks) * dstep;
    const int c0 = (item % chunks) * cpc;
    const int nc = B - c0 < cpc ? B - c0 : cpc;
    const double* fd = fac + d * fper;
    double* td = t + d * per + (CHUNKED ? (long long)c0 * S.npad : c0);
    const long long L = CHUNKED ? nc : B;
    if constexpr (MAXW == 3) {
      switch (w) {
        case 1: cr_block_apply<1, PIVOT>(fd, td, S.npad, nc, L); break;
        case 2: cr_block_apply<2, PIVOT>(fd, td, S.npad, nc, L); break;
        default: cr_block_apply<3, PIVOT>(fd, td, S.npad, nc, L); break;
      }
    } else {
      switch (w) {
        case 1: cr_block_apply<1, PIVOT>(fd, td, S.npad, nc, L); break;
        case 2: cr_block_apply<2, PIVOT>(fd, td, S.npad, nc, L); break;
        case 3: cr_block_apply<3, PIVOT>(fd, td, S.npad, nc, L); break;
        default: cr_block_apply<4, PIVOT>(fd, td, S.npad, nc, L); break;
      }
    }
  }
}

// Columns per apply_cols item when the caller leaves it open: the narrowest
// power of two (at most B) that gives every one of the D * ceil(B / c)
// (dimension, chunk) items a block of its own, so a solve is one round of
// items. Narrower items cost a second round; wider ones put more columns on
// fewer blocks (widths measured in PERF.md). A column's arithmetic does not
// depend on its item, so the width does not change the bits.
inline int auto_cols(int D, int B, int grid) {
  int c = 1;
  while (c < B && (long long)D * ((B + c - 1) / c) > grid) c <<= 1;
  return c < B ? c : B;
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
