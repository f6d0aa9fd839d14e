// Block cyclic-reduction solve and log-determinant as a device function for
// one thread block.
//
// Replaces: src/repro/kernels/block_cr.py, cr_solve_values, the body that
// the standalone launch (block_cr.cu) and the backfitting kernels
// (mega_pcg.cu, jacobi.cu, gauss_seidel.cu, through sweep.cuh) call. The
// band (lo = hi = W) is
// viewed as block-tridiagonal with W x W blocks
//     A_i x_{i-1} + B_i x_i + C_i x_{i+1} = r_i,   i = 0..nb-1,
// and eliminated in ceil(log2 nb) levels: at stride s = 2^k every even row
// (i % 2s == 0) folds its odd neighbours i +- s into itself; back
// substitution replays the levels in reverse. An even row only reads its
// odd neighbours, which no thread writes at that level, so every level
// updates in place; a __syncthreads separates the levels.
//
// What bounds it: the log-depth chain of levels (one barrier each) and, per
// level, bytes of the working blocks and right-hand sides, which stay in
// L2 for the sizes the serving path uses. Each level first updates the
// right-hand sides of all (row, column) pairs from the old blocks, then
// (after a barrier) the blocks themselves, so no thread reads a block that
// another thread of the same level rewrites.
//
// Template flags: PIVOT swaps the unpivoted W x W block solves for the
// reference's partial-pivot block mode (in the coefficients, the reduced row
// 0 and the back substitution); SOLVE = false skips every right-hand-side
// update (log-determinant only); LOGDET reduces log|det| = sum_i log|det B_i|
// over the frozen blocks, per thread and then in a fixed tree order across
// the block, so the value does not depend on scheduling. The backfitting
// kernels use <W, PIVOT, true, false>.
#pragma once

#include "common.cuh"

namespace repro {

// The reference's `_small_solve`: a zero pivot is replaced by 1.
template <int W, int NR, bool PIVOT>
__device__ __forceinline__ void cr_small_solve(const double (&M)[W][W],
                                               const double (&R)[W][NR],
                                               double (&X)[W][NR]) {
  (void)block_solve<W, NR, PIVOT, true>(M, R, X);
}

// log|det M| from the same elimination as cr_small_solve (the pivots do not
// depend on the right-hand side), without the back substitution.
template <int W, bool PIVOT>
__device__ __forceinline__ double cr_block_logdet(const double (&M)[W][W]) {
  double R[W][1] = {}, X[W][1];
  return block_solve<W, 1, PIVOT, true, false>(M, R, X);
}

template <int W, bool PIVOT>
__device__ __forceinline__ void cr_coef(const double* Ab, const double* Bb,
                                        const double* Cb, int i, int s,
                                        int nb, double (&alpha)[W][W],
                                        double (&beta)[W][W]) {
  constexpr int WW = W * W;
  double Id[W][W];
#pragma unroll
  for (int r = 0; r < W; ++r)
#pragma unroll
    for (int c = 0; c < W; ++c) Id[r][c] = (r == c) ? 1.0 : 0.0;
  double Ai[W][W], Ci[W][W];
  load_block<W>(Ab + (long long)i * WW, Ai);
  load_block<W>(Cb + (long long)i * WW, Ci);
  if (i - s >= 0) {
    double Bm[W][W], Binv[W][W], P[W][W];
    load_block<W>(Bb + (long long)(i - s) * WW, Bm);
    cr_small_solve<W, W, PIVOT>(Bm, Id, Binv);
    mm<W>(Ai, Binv, P);
#pragma unroll
    for (int r = 0; r < W; ++r)
#pragma unroll
      for (int c = 0; c < W; ++c) alpha[r][c] = -P[r][c];
  } else {
#pragma unroll
    for (int r = 0; r < W; ++r)
#pragma unroll
      for (int c = 0; c < W; ++c) alpha[r][c] = 0.0;
  }
  if (i + s < nb) {
    double Bp[W][W], Binv[W][W], P[W][W];
    load_block<W>(Bb + (long long)(i + s) * WW, Bp);
    cr_small_solve<W, W, PIVOT>(Bp, Id, Binv);
    mm<W>(Ci, Binv, P);
#pragma unroll
    for (int r = 0; r < W; ++r)
#pragma unroll
      for (int c = 0; c < W; ++c) beta[r][c] = -P[r][c];
  } else {
#pragma unroll
    for (int r = 0; r < W; ++r)
#pragma unroll
      for (int c = 0; c < W; ++c) beta[r][c] = 0.0;
  }
}

// Solve with the band (npad, 2W+1) (row-aligned, identity-padded to whole
// blocks) against the B columns of R (npad rows, row stride ldr; ldr = 0
// means B), in place: R holds x on return (SOLVE only). The columns are
// independent, so a caller may hand disjoint column ranges of one system to
// different blocks, each with its own scratch: every block recomputes the
// same block values. Ab/Bb/Cb are (npad / W, W, W) scratch. With LOGDET,
// *ld receives log|det| and `red` is shared scratch of blockDim.x doubles (a
// power of two). Every thread of the block must call this.
template <int W, bool PIVOT = false, bool SOLVE = true, bool LOGDET = false>
__device__ void cr_block_solve(const double* band, double* R, double* Ab,
                               double* Bb, double* Cb, int npad, int B,
                               double* ld = nullptr, double* red = nullptr,
                               int ldr = 0) {
  constexpr int WW = W * W;
  constexpr int WB = 2 * W + 1;
  const int nb = npad / W;
  const long long L = ldr > 0 ? ldr : B;  // row stride of R
  const int steps = nb > 1 ? 32 - __clz(nb - 1) : 0;

  // band -> block triples
  for (int I = threadIdx.x; I < nb; I += blockDim.x) {
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const double* row = band + (long long)(I * W + r) * WB;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const int ja = c - r, jb = W + c - r, jc = 2 * W + c - r;
        const long long o = (long long)I * WW + r * W + c;
        Ab[o] = (ja >= 0 && ja <= 2 * W) ? row[ja] : 0.0;
        Bb[o] = (jb >= 0 && jb <= 2 * W) ? row[jb] : 0.0;
        Cb[o] = (jc >= 0 && jc <= 2 * W) ? row[jc] : 0.0;
      }
    }
  }
  __syncthreads();

  for (int k = 0; k < steps; ++k) {
    const int s = 1 << k;
    const int ne = (nb + 2 * s - 1) / (2 * s);  // even rows i = 2 s j < nb
    // right-hand sides: R_i += alpha R_{i-s} + beta R_{i+s}
    for (long long e = threadIdx.x; SOLVE && e < (long long)ne * B;
         e += blockDim.x) {
      const int j = (int)(e / B), b = (int)(e - (long long)j * B);
      const int i = 2 * s * j;
      double alpha[W][W], beta[W][W];
      cr_coef<W, PIVOT>(Ab, Bb, Cb, i, s, nb, alpha, beta);
      double ri[W], rm[W], rp[W];
#pragma unroll
      for (int r = 0; r < W; ++r) {
        ri[r] = R[(long long)(i * W + r) * L + b];
        rm[r] = (i - s >= 0) ? R[(long long)((i - s) * W + r) * L + b] : 0.0;
        rp[r] = (i + s < nb) ? R[(long long)((i + s) * W + r) * L + b] : 0.0;
      }
#pragma unroll
      for (int r = 0; r < W; ++r) {
        double am = 0.0, bp = 0.0;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          am += alpha[r][c] * rm[c];
          bp += beta[r][c] * rp[c];
        }
        R[(long long)(i * W + r) * L + b] = ri[r] + am + bp;
      }
    }
    __syncthreads();
    // blocks: B_i += alpha C_{i-s} + beta A_{i+s}; A_i = alpha A_{i-s};
    // C_i = beta C_{i+s}
    for (int j = threadIdx.x; j < ne; j += blockDim.x) {
      const int i = 2 * s * j;
      double alpha[W][W], beta[W][W];
      cr_coef<W, PIVOT>(Ab, Bb, Cb, i, s, nb, alpha, beta);
      double Bi[W][W], Cm[W][W], Ap[W][W], Am[W][W], Cp[W][W];
      double t1[W][W], t2[W][W], nA[W][W], nC[W][W];
      load_block<W>(Bb + (long long)i * WW, Bi);
#pragma unroll
      for (int r = 0; r < W; ++r)
#pragma unroll
        for (int c = 0; c < W; ++c) {
          Cm[r][c] = Am[r][c] = Ap[r][c] = Cp[r][c] = 0.0;
        }
      if (i - s >= 0) {
        load_block<W>(Cb + (long long)(i - s) * WW, Cm);
        load_block<W>(Ab + (long long)(i - s) * WW, Am);
      }
      if (i + s < nb) {
        load_block<W>(Ab + (long long)(i + s) * WW, Ap);
        load_block<W>(Cb + (long long)(i + s) * WW, Cp);
      }
      mm<W>(alpha, Cm, t1);
      mm<W>(beta, Ap, t2);
      mm<W>(alpha, Am, nA);
      mm<W>(beta, Cp, nC);
#pragma unroll
      for (int r = 0; r < W; ++r)
#pragma unroll
        for (int c = 0; c < W; ++c) Bi[r][c] = Bi[r][c] + t1[r][c] + t2[r][c];
      store_block<W>(Bb + (long long)i * WW, Bi);
      store_block<W>(Ab + (long long)i * WW, nA);
      store_block<W>(Cb + (long long)i * WW, nC);
    }
    __syncthreads();
  }

  // log|det| telescopes over the frozen blocks: per-thread partial sums,
  // then a fixed-order tree across the block
  if constexpr (LOGDET) {
    double acc = 0.0;
    for (int I = threadIdx.x; I < nb; I += blockDim.x) {
      double Bi[W][W];
      load_block<W>(Bb + (long long)I * WW, Bi);
      acc += cr_block_logdet<W, PIVOT>(Bi);
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int h = blockDim.x / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) *ld = red[0];
  }
  if constexpr (!SOLVE) return;

  // the fully reduced row 0
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    double B0[W][W], r0[W][1], x0[W][1];
    load_block<W>(Bb, B0);
#pragma unroll
    for (int r = 0; r < W; ++r) r0[r][0] = R[(long long)r * L + b];
    cr_small_solve<W, 1, PIVOT>(B0, r0, x0);
#pragma unroll
    for (int r = 0; r < W; ++r) R[(long long)r * L + b] = x0[r][0];
  }
  __syncthreads();

  // back substitution: odd rows of level k from the solved rows i +- s
  for (int k = steps - 1; k >= 0; --k) {
    const int s = 1 << k;
    const int no = nb > s ? (nb - s + 2 * s - 1) / (2 * s) : 0;
    for (long long e = threadIdx.x; e < (long long)no * B; e += blockDim.x) {
      const int j = (int)(e / B), b = (int)(e - (long long)j * B);
      const int i = s + 2 * s * j;
      double Ai[W][W], Ci[W][W], Bi[W][W], xm[W], xp[W], rk[W][1], xi[W][1];
      load_block<W>(Ab + (long long)i * WW, Ai);
      load_block<W>(Cb + (long long)i * WW, Ci);
      load_block<W>(Bb + (long long)i * WW, Bi);
#pragma unroll
      for (int r = 0; r < W; ++r) {
        xm[r] = R[(long long)((i - s) * W + r) * L + b];
        xp[r] = (i + s < nb) ? R[(long long)((i + s) * W + r) * L + b] : 0.0;
      }
#pragma unroll
      for (int r = 0; r < W; ++r) {
        double am = 0.0, cp = 0.0;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          am += Ai[r][c] * xm[c];
          cp += Ci[r][c] * xp[c];
        }
        rk[r][0] = R[(long long)(i * W + r) * L + b] - am - cp;
      }
      cr_small_solve<W, 1, PIVOT>(Bi, rk, xi);
#pragma unroll
      for (int r = 0; r < W; ++r) R[(long long)(i * W + r) * L + b] = xi[r][0];
    }
    __syncthreads();
  }
}

}  // namespace repro
