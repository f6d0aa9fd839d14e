// Block cyclic-reduction solve as a device function for one thread block.
//
// Replaces (as the body that the whole-solve kernel calls):
// src/repro/kernels/block_cr.py, cr_solve_values. The band (lo = hi = W) is
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
#pragma once

#include "common.cuh"

namespace repro {

template <int W>
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
    solve_nopivot<W, W>(Bm, Id, Binv);
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
    solve_nopivot<W, W>(Bp, Id, Binv);
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
// blocks) against R (npad, B), in place: R holds x on return. Ab/Bb/Cb are
// (npad / W, W, W) scratch. Every thread of the block must call this.
template <int W>
__device__ void cr_block_solve(const double* band, double* R, double* Ab,
                               double* Bb, double* Cb, int npad, int B) {
  constexpr int WW = W * W;
  constexpr int WB = 2 * W + 1;
  const int nb = npad / W;
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
    for (long long e = threadIdx.x; e < (long long)ne * B; e += blockDim.x) {
      const int j = (int)(e / B), b = (int)(e - (long long)j * B);
      const int i = 2 * s * j;
      double alpha[W][W], beta[W][W];
      cr_coef<W>(Ab, Bb, Cb, i, s, nb, alpha, beta);
      double ri[W], rm[W], rp[W];
#pragma unroll
      for (int r = 0; r < W; ++r) {
        ri[r] = R[(long long)(i * W + r) * B + b];
        rm[r] = (i - s >= 0) ? R[(long long)((i - s) * W + r) * B + b] : 0.0;
        rp[r] = (i + s < nb) ? R[(long long)((i + s) * W + r) * B + b] : 0.0;
      }
#pragma unroll
      for (int r = 0; r < W; ++r) {
        double am = 0.0, bp = 0.0;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          am += alpha[r][c] * rm[c];
          bp += beta[r][c] * rp[c];
        }
        R[(long long)(i * W + r) * B + b] = ri[r] + am + bp;
      }
    }
    __syncthreads();
    // blocks: B_i += alpha C_{i-s} + beta A_{i+s}; A_i = alpha A_{i-s};
    // C_i = beta C_{i+s}
    for (int j = threadIdx.x; j < ne; j += blockDim.x) {
      const int i = 2 * s * j;
      double alpha[W][W], beta[W][W];
      cr_coef<W>(Ab, Bb, Cb, i, s, nb, alpha, beta);
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

  // the fully reduced row 0
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    double B0[W][W], r0[W][1], x0[W][1];
    load_block<W>(Bb, B0);
#pragma unroll
    for (int r = 0; r < W; ++r) r0[r][0] = R[(long long)r * B + b];
    solve_nopivot<W, 1>(B0, r0, x0);
#pragma unroll
    for (int r = 0; r < W; ++r) R[(long long)r * B + b] = x0[r][0];
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
        xm[r] = R[(long long)((i - s) * W + r) * B + b];
        xp[r] = (i + s < nb) ? R[(long long)((i + s) * W + r) * B + b] : 0.0;
      }
#pragma unroll
      for (int r = 0; r < W; ++r) {
        double am = 0.0, cp = 0.0;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          am += Ai[r][c] * xm[c];
          cp += Ci[r][c] * xp[c];
        }
        rk[r][0] = R[(long long)(i * W + r) * B + b] - am - cp;
      }
      solve_nopivot<W, 1>(Bi, rk, xi);
#pragma unroll
      for (int r = 0; r < W; ++r) R[(long long)(i * W + r) * B + b] = xi[r][0];
    }
    __syncthreads();
  }
}

}  // namespace repro
