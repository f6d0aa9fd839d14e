// Block-tridiagonal band inverse (paper Algorithm 5) by block cyclic
// reduction with selected inversion, float64.
//
// Replaces: src/repro/kernels/rgf.py, rgf_blocks_pallas (kernel body
// `_rgf_kernel`), which computes the posterior-variance band G = band(H^-1)
// by the RGF recurrences: two chains of T dependent w x w block solves.
//
// The same band of G in another elimination order (rgf_blocks_cr_plain in
// kernels/rgf.py replays it in plain torch). With A, B, C the blocks of H
// (A_i = L_i couples node i to i-1, B_i = D_i, C_i = U_i to i+1), level k
// (stride s = 2^k) eliminates the odd nodes e = s (mod 2s) of the nodes
// still alive; each even node i folds
//   alpha = -A_i B_{i-s}^{-1},  beta = -C_i B_{i+s}^{-1},
//   B_i += alpha C_{i-s} + beta A_{i+s},  A_i = alpha A_{i-s},
//   C_i = beta C_{i+s}.
// The inverse of the Schur complement on the survivors is the matching
// block of H^-1, so after the top (G_00 = B_0^{-1}) each level back down
// gives, with a = e - s, b = e + s, Ua = C_a and Lb = A_b at that level:
//   G_ea = -B_e^{-1} (A_e G_aa + C_e G_ba)
//   G_eb = -B_e^{-1} (A_e G_ab + C_e G_bb)
//   G_ae = -(G_aa Ua + G_ab Lb) B_e^{-1}
//   G_be = -(G_ba Ua + G_bb Lb) B_e^{-1}
//   G_ee = B_e^{-1} - (G_ea Ua + G_eb Lb) B_e^{-1}
// where G_ab, G_ba came from the level above; at level 0 G_ea, G_eb, G_ae,
// G_be are the first off-diagonal blocks. The w x w inverses keep the RGF
// kernel's within-block partial pivoting (block_solve<W, 1, true, false>).
//
// What bounds it on the H100: latency. The bytes (3 T w^2 doubles in, 3
// out) take ~4 us at T = 30000, w = 1, G = 10; the work is a chain of
// 2 ceil(log2 T) levels, each a few dependent block products.
//
// Design: three launches from one call; each level's nodes over the grid
// (on an H100 at w = 1, T = 30000, G = 10: ~0.056 ms of device time, where
// the two RGF chains took 4.6 ms).
// 1. tile_fwd: a block per (tile of P = tile_rows(w) rows, band) runs the
//    levels below log2 P on its tile, a __syncthreads between phases. A
//    node on a tile edge (a multiple of P) belongs to two tiles: the tile
//    on its right folds its right side into dR, the one on its left its
//    left side into dL (each tile writes only its own edge fields).
// 2. top: a block per band sets each edge's B = (D + dL) + dR, runs the
//    levels above on the T / P survivors, inverts B_0 and runs the
//    selected inversion back down to log2 P.
// 3. tile_bwd: the tiles' levels back down to 0.
// Each level has two phases (inverses of the odd nodes, then the folds;
// back down: G_ea, G_eb, G_ae, G_be, then G_ee). A node's w x w algebra is
// spread over w lanes, each one row or one column of the result, reading
// the other blocks from global memory (L1/L2), so no thread keeps more
// than a block and a few rows live: at w = 7 nothing spills (the RGF
// kernel kept six 7 x 7 blocks in registers and spilled 2 KB).
#include "common.cuh"

namespace {

using repro::load_block;

// (node, lane) items of a tile's first level, one thread each
constexpr int TILE_THREADS = 128;
constexpr int TOP_THREADS = 256;

// rows of a tile: the largest power of two P with (P / 2) w <= TILE_THREADS
__host__ __device__ inline int tile_rows(int w) {
  int p = 2;
  while (p * w <= TILE_THREADS) p *= 2;
  return p;
}

__host__ __device__ inline int levels(int nb) {
  int k = 0;
  while ((1 << k) < nb) ++k;
  return k;
}

__host__ __device__ inline int log2i(int p) {
  int k = 0;
  while ((1 << k) < p) ++k;
  return k;
}

// Scratch of one band, in blocks: A, B, C, Binv, Ua, Lb (nb each); the
// couplings of the levels >= 1 (Xea, Xeb, Xae, Xbe; nodes even, at e / 2);
// the edges' dL and dR (at i / P).
__host__ __device__ inline long long half_blocks(int nb) {
  return (nb + 2) / 2;
}
__host__ __device__ inline long long edge_blocks(int nb, int P) {
  return (nb + P - 1) / P;
}
__host__ __device__ inline long long scratch_blocks(int nb, int P) {
  return 6LL * nb + 4 * half_blocks(nb) + 2 * edge_blocks(nb, P);
}

struct Work {
  const double *D, *U, *L;
  double *A, *B, *C, *Binv, *Ua, *Lb, *Xea, *Xeb, *Xae, *Xbe, *dL, *dR;
  double *Gd, *Gu, *Gl;
};

// band g's pointers; scratch holds each array for all G bands in turn
__device__ inline Work band_work(const double* D, const double* U,
                                 const double* L, double* Gd, double* Gu,
                                 double* Gl, double* S, int G, int nb, int ww,
                                 int P, int g) {
  const long long full = (long long)nb * ww;
  const long long half = half_blocks(nb) * ww;
  const long long edge = edge_blocks(nb, P) * ww;
  Work w;
  const long long o = (long long)g * full;
  w.D = D + o;
  w.U = U + o;
  w.L = L + o;
  w.Gd = Gd + o;
  w.Gu = Gu + o;
  w.Gl = Gl + o;
  double** f[] = {&w.A, &w.B, &w.C, &w.Binv, &w.Ua, &w.Lb};
  for (double** p : f) {
    *p = S + (long long)g * full;
    S += (long long)G * full;
  }
  double** h[] = {&w.Xea, &w.Xeb, &w.Xae, &w.Xbe};
  for (double** p : h) {
    *p = S + (long long)g * half;
    S += (long long)G * half;
  }
  w.dL = S + (long long)g * edge;
  S += (long long)G * edge;
  w.dR = S + (long long)g * edge;
  return w;
}

template <int W>
__device__ __forceinline__ double* blk(double* p, long long i) {
  return p + i * (W * W);
}
template <int W>
__device__ __forceinline__ const double* blk(const double* p, long long i) {
  return p + i * (W * W);
}

// out[c] = sum_k v[k] M[k][c] (a row times a block), fixed k order
template <int W>
__device__ __forceinline__ void row_mm(const double (&v)[W], const double* M,
                                       double (&out)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    double acc = v[0] * M[c];
#pragma unroll
    for (int k = 1; k < W; ++k) acc += v[k] * M[k * W + c];
    out[c] = acc;
  }
}

// out[r] = sum_k M[r][k] v[k] (a block times a column), fixed k order
template <int W>
__device__ __forceinline__ void mm_col(const double* M, const double (&v)[W],
                                       double (&out)[W]) {
#pragma unroll
  for (int r = 0; r < W; ++r) {
    double acc = M[r * W] * v[0];
#pragma unroll
    for (int k = 1; k < W; ++k) acc += M[r * W + k] * v[k];
    out[r] = acc;
  }
}

template <int W>
__device__ __forceinline__ void load_row(const double* M, int r,
                                         double (&v)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] = M[r * W + c];
}

template <int W>
__device__ __forceinline__ void load_col(const double* M, int c,
                                         double (&v)[W]) {
#pragma unroll
  for (int r = 0; r < W; ++r) v[r] = M[r * W + c];
}

// column c of M^{-1} (the pivoted elimination of M against e_c)
template <int W>
__device__ __forceinline__ void inverse_col(const double* Mp, int c,
                                            double (&x)[W]) {
  double M[W][W], R[W][1], X[W][1];
  load_block<W>(Mp, M);
#pragma unroll
  for (int r = 0; r < W; ++r) R[r][0] = (r == c) ? 1.0 : 0.0;
  repro::block_solve<W, 1, true, false>(M, R, X);
#pragma unroll
  for (int r = 0; r < W; ++r) x[r] = X[r][0];
}

// Phase 1 of level s over the nodes [i0, hi]: B_e^{-1} of each odd node,
// lane c its column c.
template <int W>
__device__ void invert_level(const Work& w, int i0, int hi, int s) {
  constexpr int WW = W * W;
  const int ne = hi - i0 >= s ? (hi - i0 - s) / (2 * s) + 1 : 0;
  for (int it = threadIdx.x; it < ne * W; it += blockDim.x) {
    const int j = it / W, c = it - j * W;
    const int e = i0 + s + 2 * s * j;
    double x[W];
    inverse_col<W>(blk<W>(w.B, e), c, x);
#pragma unroll
    for (int r = 0; r < W; ++r) w.Binv[(long long)e * WW + r * W + c] = x[r];
  }
}

// Phase 2 of level s over the nodes [i0, hi]: each even node folds its odd
// neighbours in, lane r its row r. With `tiled`, i0 and i1 are tile edges:
// i0 folds only its right side (into dR), i1 only its left (into dL).
template <int W>
__device__ void fold_level(const Work& w, int i0, int i1, int hi, int s,
                           int nb, int P, bool tiled) {
  constexpr int WW = W * W;
  const int nv = (hi - i0) / (2 * s) + 1;
  for (int it = threadIdx.x; it < nv * W; it += blockDim.x) {
    const int j = it / W, r = it - j * W;
    const int i = i0 + 2 * s * j;
    const bool edge_l = tiled && i == i0, edge_r = tiled && i == i1;
    const bool left = i - s >= 0 && !edge_l;
    const bool right = i + s < nb && !edge_r;
    const long long ro = (long long)i * WW + r * W;
    double t1[W], t2[W];
    if (left) {
      double arow[W], alpha[W], nA[W];
      load_row<W>(blk<W>(w.A, i), r, arow);
      row_mm<W>(arow, blk<W>(w.Binv, i - s), alpha);
#pragma unroll
      for (int c = 0; c < W; ++c) alpha[c] = -alpha[c];
      row_mm<W>(alpha, blk<W>(w.C, i - s), t1);
      row_mm<W>(alpha, blk<W>(w.A, i - s), nA);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        w.Lb[(long long)(i - s) * WW + r * W + c] = arow[c];
        w.A[ro + c] = nA[c];
      }
    }
    if (right) {
      double crow[W], beta[W], nC[W];
      load_row<W>(blk<W>(w.C, i), r, crow);
      row_mm<W>(crow, blk<W>(w.Binv, i + s), beta);
#pragma unroll
      for (int c = 0; c < W; ++c) beta[c] = -beta[c];
      row_mm<W>(beta, blk<W>(w.A, i + s), t2);
      row_mm<W>(beta, blk<W>(w.C, i + s), nC);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        w.Ua[(long long)(i + s) * WW + r * W + c] = crow[c];
        w.C[ro + c] = nC[c];
      }
    }
    const long long eo = (long long)(i / P) * WW + r * W;
    if (edge_l) {
      if (right) {
#pragma unroll
        for (int c = 0; c < W; ++c) w.dR[eo + c] = w.dR[eo + c] + t2[c];
      }
    } else if (edge_r) {
      if (left) {
#pragma unroll
        for (int c = 0; c < W; ++c) w.dL[eo + c] = w.dL[eo + c] + t1[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        double acc = w.B[ro + c];
        if (left) acc += t1[c];
        if (right) acc += t2[c];
        w.B[ro + c] = acc;
      }
    }
  }
}

// One level of the selected inversion over the nodes [i0, hi]: phase 1
// (lane l: column l of G_ea and G_eb, row l of G_ae and G_be), then phase
// 2 (lane l: row l of G_ee). Level 0 writes the off-diagonal blocks into
// Gu / Gl, higher levels into the X arrays. Every thread of the block
// must call this.
template <int W>
__device__ void back_level(const Work& w, int i0, int hi, int s, int nb) {
  constexpr int WW = W * W;
  const int ne = hi - i0 >= s ? (hi - i0 - s) / (2 * s) + 1 : 0;
  for (int it = threadIdx.x; it < ne * W; it += blockDim.x) {
    const int j = it / W, l = it - j * W;
    const int e = i0 + s + 2 * s * j, a = e - s, b = e + s;
    const bool hb = b < nb;
    double *gea, *geb, *gae, *gbe;
    if (s == 1) {
      gea = blk<W>(w.Gl, e - 1);
      gae = blk<W>(w.Gu, e - 1);
      geb = blk<W>(w.Gu, e);
      gbe = blk<W>(w.Gl, e);
    } else {
      gea = blk<W>(w.Xea, e / 2);
      geb = blk<W>(w.Xeb, e / 2);
      gae = blk<W>(w.Xae, e / 2);
      gbe = blk<W>(w.Xbe, e / 2);
    }
    const double* Gaa = blk<W>(w.Gd, a);
    const double* Bi = blk<W>(w.Binv, e);
    const double* Ae = blk<W>(w.A, e);
    const double* Ce = blk<W>(w.C, e);
    const double* Ua = blk<W>(w.Ua, e);
    if (!hb) {
      // G_eb = G_be = 0; G_ea = -B^{-1} A_e G_aa, G_ae = -G_aa Ua B^{-1}
      double g[W], x[W], y[W];
      load_col<W>(Gaa, l, g);
      mm_col<W>(Ae, g, x);
      mm_col<W>(Bi, x, y);
#pragma unroll
      for (int r = 0; r < W; ++r) {
        gea[r * W + l] = -y[r];
        geb[r * W + l] = 0.0;
      }
      load_row<W>(Gaa, l, g);
      row_mm<W>(g, Ua, x);
      row_mm<W>(x, Bi, y);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        gae[l * W + c] = -y[c];
        gbe[l * W + c] = 0.0;
      }
      continue;
    }
    const double* Gbb = blk<W>(w.Gd, b);
    const double *Gab, *Gba;  // from the odd node of the pair one level up
    if (a % (4 * s) == 2 * s) {
      Gab = blk<W>(w.Xeb, a / 2);
      Gba = blk<W>(w.Xbe, a / 2);
    } else {
      Gab = blk<W>(w.Xae, b / 2);
      Gba = blk<W>(w.Xea, b / 2);
    }
    const double* Lb = blk<W>(w.Lb, e);
    double g1[W], g2[W], x1[W], x2[W], y[W];
    // column l of G_ea = -B^{-1} (A_e G_aa + C_e G_ba)
    load_col<W>(Gaa, l, g1);
    load_col<W>(Gba, l, g2);
    mm_col<W>(Ae, g1, x1);
    mm_col<W>(Ce, g2, x2);
#pragma unroll
    for (int r = 0; r < W; ++r) x1[r] += x2[r];
    mm_col<W>(Bi, x1, y);
#pragma unroll
    for (int r = 0; r < W; ++r) gea[r * W + l] = -y[r];
    // column l of G_eb = -B^{-1} (A_e G_ab + C_e G_bb)
    load_col<W>(Gab, l, g1);
    load_col<W>(Gbb, l, g2);
    mm_col<W>(Ae, g1, x1);
    mm_col<W>(Ce, g2, x2);
#pragma unroll
    for (int r = 0; r < W; ++r) x1[r] += x2[r];
    mm_col<W>(Bi, x1, y);
#pragma unroll
    for (int r = 0; r < W; ++r) geb[r * W + l] = -y[r];
    // row l of G_ae = -(G_aa Ua + G_ab Lb) B^{-1}
    load_row<W>(Gaa, l, g1);
    load_row<W>(Gab, l, g2);
    row_mm<W>(g1, Ua, x1);
    row_mm<W>(g2, Lb, x2);
#pragma unroll
    for (int c = 0; c < W; ++c) x1[c] += x2[c];
    row_mm<W>(x1, Bi, y);
#pragma unroll
    for (int c = 0; c < W; ++c) gae[l * W + c] = -y[c];
    // row l of G_be = -(G_ba Ua + G_bb Lb) B^{-1}
    load_row<W>(Gba, l, g1);
    load_row<W>(Gbb, l, g2);
    row_mm<W>(g1, Ua, x1);
    row_mm<W>(g2, Lb, x2);
#pragma unroll
    for (int c = 0; c < W; ++c) x1[c] += x2[c];
    row_mm<W>(x1, Bi, y);
#pragma unroll
    for (int c = 0; c < W; ++c) gbe[l * W + c] = -y[c];
  }
  __syncthreads();
  for (int it = threadIdx.x; it < ne * W; it += blockDim.x) {
    const int j = it / W, l = it - j * W;
    const int e = i0 + s + 2 * s * j;
    const bool hb = e + s < nb;
    const double* gea = s == 1 ? blk<W>(w.Gl, e - 1) : blk<W>(w.Xea, e / 2);
    const double* geb = s == 1 ? blk<W>(w.Gu, e) : blk<W>(w.Xeb, e / 2);
    const double* Bi = blk<W>(w.Binv, e);
    double g[W], z[W], z2[W], y[W];
    // row l of G_ee = B^{-1} - (G_ea Ua + G_eb Lb) B^{-1}
    load_row<W>(gea, l, g);
    row_mm<W>(g, blk<W>(w.Ua, e), z);
    if (hb) {
      load_row<W>(geb, l, g);
      row_mm<W>(g, blk<W>(w.Lb, e), z2);
#pragma unroll
      for (int c = 0; c < W; ++c) z[c] += z2[c];
    }
    row_mm<W>(z, Bi, y);
#pragma unroll
    for (int c = 0; c < W; ++c)
      w.Gd[(long long)e * WW + l * W + c] = Bi[l * W + c] - y[c];
  }
  __syncthreads();
}

template <int W>
__global__ void __launch_bounds__(TILE_THREADS)
    tile_fwd_kernel(const double* __restrict__ D, const double* __restrict__ U,
                    const double* __restrict__ L, double* Gd, double* Gu,
                    double* Gl, double* S, int G, int nb) {
  constexpr int WW = W * W;
  const int P = tile_rows(W);
  const Work w = band_work(D, U, L, Gd, Gu, Gl, S, G, nb, WW, P, blockIdx.y);
  const int i0 = blockIdx.x * P, i1 = i0 + P;
  const int hi = min(i1, nb - 1);
  // the tile's blocks: interior nodes all of A, B, C; the left edge its
  // right side (C, dR), the right edge its left side (A, dL)
  for (int x = threadIdx.x; x < (hi - i0 + 1) * WW; x += blockDim.x) {
    const int i = i0 + x / WW, q = x % WW;
    const long long o = (long long)i * WW + q;
    const long long eo = (long long)(i / P) * WW + q;
    if (i == i0) {
      w.C[o] = w.U[o];
      w.dR[eo] = 0.0;
      if (i0 == 0) w.dL[eo] = 0.0;
    } else if (i == i1) {
      w.A[o] = w.L[o];
      w.dL[eo] = 0.0;
    } else {
      w.A[o] = w.L[o];
      w.B[o] = w.D[o];
      w.C[o] = w.U[o];
    }
  }
  __syncthreads();
  const int kt = min(log2i(P), levels(nb));
  for (int k = 0; k < kt; ++k) {
    invert_level<W>(w, i0, hi, 1 << k);
    __syncthreads();
    fold_level<W>(w, i0, i1, hi, 1 << k, nb, P, true);
    __syncthreads();
  }
}

template <int W>
__global__ void __launch_bounds__(TOP_THREADS)
    top_kernel(const double* __restrict__ D, const double* __restrict__ U,
               const double* __restrict__ L, double* Gd, double* Gu,
               double* Gl, double* S, int G, int nb) {
  constexpr int WW = W * W;
  const int P = tile_rows(W);
  const Work w = band_work(D, U, L, Gd, Gu, Gl, S, G, nb, WW, P, blockIdx.x);
  const int ne = (int)edge_blocks(nb, P);
  for (int x = threadIdx.x; x < ne * WW; x += blockDim.x) {
    const long long o = (long long)(x / WW) * P * WW + x % WW;
    w.B[o] = (w.D[o] + w.dL[x]) + w.dR[x];
  }
  __syncthreads();
  const int steps = levels(nb), kt = min(log2i(P), steps);
  for (int k = kt; k < steps; ++k) {
    invert_level<W>(w, 0, nb - 1, 1 << k);
    __syncthreads();
    fold_level<W>(w, 0, 0, nb - 1, 1 << k, nb, P, false);
    __syncthreads();
  }
  if (threadIdx.x < W) {
    double x[W];
    inverse_col<W>(w.B, threadIdx.x, x);
#pragma unroll
    for (int r = 0; r < W; ++r) w.Gd[r * W + threadIdx.x] = x[r];
  }
  // the last off-diagonal entries are zero; an even last node gets none
  // from level 0
  if ((nb - 1) % 2 == 0) {
    for (int q = threadIdx.x; q < WW; q += blockDim.x) {
      w.Gu[(long long)(nb - 1) * WW + q] = 0.0;
      w.Gl[(long long)(nb - 1) * WW + q] = 0.0;
    }
  }
  __syncthreads();
  for (int k = steps - 1; k >= kt; --k) back_level<W>(w, 0, nb - 1, 1 << k, nb);
}

template <int W>
__global__ void __launch_bounds__(TILE_THREADS)
    tile_bwd_kernel(const double* __restrict__ D, const double* __restrict__ U,
                    const double* __restrict__ L, double* Gd, double* Gu,
                    double* Gl, double* S, int G, int nb) {
  constexpr int WW = W * W;
  const int P = tile_rows(W);
  const Work w = band_work(D, U, L, Gd, Gu, Gl, S, G, nb, WW, P, blockIdx.y);
  const int i0 = blockIdx.x * P;
  const int hi = min(i0 + P, nb - 1);
  const int kt = min(log2i(P), levels(nb));
  for (int k = kt - 1; k >= 0; --k) back_level<W>(w, i0, hi, 1 << k, nb);
}

template <int W>
int launch(const double* D, const double* U, const double* L, double* Gd,
           double* Gu, double* Gl, double* S, int G, int nb,
           cudaStream_t st) {
  const int P = tile_rows(W);
  const dim3 tiles((nb + P - 1) / P, G);
  tile_fwd_kernel<W><<<tiles, TILE_THREADS, 0, st>>>(D, U, L, Gd, Gu, Gl, S,
                                                     G, nb);
  REPRO_RETURN_IF_ERR(cudaGetLastError());
  top_kernel<W><<<G, TOP_THREADS, 0, st>>>(D, U, L, Gd, Gu, Gl, S, G, nb);
  REPRO_RETURN_IF_ERR(cudaGetLastError());
  tile_bwd_kernel<W><<<tiles, TILE_THREADS, 0, st>>>(D, U, L, Gd, Gu, Gl, S,
                                                     G, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// doubles of scratch the kernel takes for G bands of T blocks of w x w
extern "C" long long repro_rgf_workspace(int G, int T, int w) {
  return (long long)G * scratch_blocks(T, tile_rows(w)) * w * w;
}

extern "C" int repro_rgf_blocks_f64(const double* Dg, const double* U,
                                    const double* L, double* Gd, double* Gu,
                                    double* Gl, double* scratch, int G, int T,
                                    int w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || G > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  switch (w) {
    case 1: return launch<1>(Dg, U, L, Gd, Gu, Gl, scratch, G, T, st);
    case 2: return launch<2>(Dg, U, L, Gd, Gu, Gl, scratch, G, T, st);
    case 3: return launch<3>(Dg, U, L, Gd, Gu, Gl, scratch, G, T, st);
    case 4: return launch<4>(Dg, U, L, Gd, Gu, Gl, scratch, G, T, st);
    case 5: return launch<5>(Dg, U, L, Gd, Gu, Gl, scratch, G, T, st);
    case 7: return launch<7>(Dg, U, L, Gd, Gu, Gl, scratch, G, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
