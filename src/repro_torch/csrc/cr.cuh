// Block cyclic-reduction solve and log-determinant as device functions for
// one thread block, in factored form: a factor made once per band, then
// applied to each right-hand side.
//
// Replaces: src/repro/kernels/block_cr.py, cr_solve_values, the body that
// the standalone launches (block_cr.cu: factor, then apply) and the
// backfitting kernels (mega_pcg.cu, jacobi.cu and gauss_seidel.cu, through
// sweep.cuh's apply_cols) call. The band (lo = hi = W) is viewed as
// block-tridiagonal with W x W blocks
//     A_i x_{i-1} + B_i x_i + C_i x_{i+1} = r_i,   i = 0..nb-1,
// and eliminated in ceil(log2 nb) levels: at stride s = 2^k every even row
// (i % 2s == 0) folds its odd neighbours i +- s into itself; back
// substitution replays the levels in reverse. An even row only reads its
// odd neighbours, which no thread writes at that level, so every level
// updates in place; a __syncthreads separates the levels.
//
// What bounds it: the log-depth chain of levels (one barrier each) and, per
// level, bytes of the factor's blocks and of the right-hand sides, which
// stay in L2 for the sizes the serving path uses. The factor folds each
// level's blocks, the apply each level's right-hand sides with the stored
// coefficients.
//
// Template flag PIVOT swaps the unpivoted W x W block solves for the
// reference's partial-pivot block mode (in the coefficients, the reduced row
// 0 and the back substitution). log|det| = sum_i log|det B_i| over the
// frozen blocks is cr_logdet_blocks: per-thread partials, then a fixed tree
// order across the block, so the value does not depend on scheduling. The
// pieces of the elimination (blocks from the band, one level's
// coefficients, one right-hand-side fold, one block fold, one back
// substitution row) are the functions below, so the factor and the apply
// together compute the expressions of the elimination of band and
// right-hand side in one pass, in its order.
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

// band (npad, 2W+1) -> block triples Ab, Bb, Cb (nb, W, W), block rows
// strided over the threads of the block
template <int W>
__device__ __forceinline__ void cr_to_blocks(const double* band, double* Ab,
                                             double* Bb, double* Cb, int nb) {
  constexpr int WW = W * W;
  constexpr int WB = 2 * W + 1;
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
}

// One column of an even row's right-hand side at stride s: the rows i, i-s
// and i+s (zero past either end) of column b.
template <int W>
__device__ __forceinline__ void cr_load_rhs(const double* R, long long L,
                                            int i, int s, int nb, int b,
                                            double (&ri)[W], double (&rm)[W],
                                            double (&rp)[W]) {
#pragma unroll
  for (int r = 0; r < W; ++r) {
    ri[r] = R[(long long)(i * W + r) * L + b];
    rm[r] = (i - s >= 0) ? R[(long long)((i - s) * W + r) * L + b] : 0.0;
    rp[r] = (i + s < nb) ? R[(long long)((i + s) * W + r) * L + b] : 0.0;
  }
}

// R_i + alpha R_{i-s} + beta R_{i+s} for one column, in the order every
// block-CR path of the port uses
template <int W>
__device__ __forceinline__ void cr_fold_rhs(const double (&alpha)[W][W],
                                            const double (&beta)[W][W],
                                            const double (&ri)[W],
                                            const double (&rm)[W],
                                            const double (&rp)[W],
                                            double (&out)[W]) {
#pragma unroll
  for (int r = 0; r < W; ++r) {
    double am = 0.0, bp = 0.0;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      am += alpha[r][c] * rm[c];
      bp += beta[r][c] * rp[c];
    }
    out[r] = ri[r] + am + bp;
  }
}

// B_i += alpha C_{i-s} + beta A_{i+s}; A_i = alpha A_{i-s};
// C_i = beta C_{i+s} (the even row i of level s)
template <int W>
__device__ __forceinline__ void cr_fold_blocks(const double (&alpha)[W][W],
                                               const double (&beta)[W][W],
                                               double* Ab, double* Bb,
                                               double* Cb, int i, int s,
                                               int nb) {
  constexpr int WW = W * W;
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

// The odd row i's solution from its solved neighbours xm = x_{i-s} and
// xp = x_{i+s} (zero past the end): B_i^{-1} (r_i - A_i xm - C_i xp)
template <int W, bool PIVOT>
__device__ __forceinline__ void cr_back_row(const double (&Ai)[W][W],
                                            const double (&Bi)[W][W],
                                            const double (&Ci)[W][W],
                                            const double (&xm)[W],
                                            const double (&xp)[W],
                                            const double (&ri)[W],
                                            double (&xi)[W][1]) {
  double rk[W][1];
#pragma unroll
  for (int r = 0; r < W; ++r) {
    double am = 0.0, cp = 0.0;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      am += Ai[r][c] * xm[c];
      cp += Ci[r][c] * xp[c];
    }
    rk[r][0] = ri[r] - am - cp;
  }
  cr_small_solve<W, 1, PIVOT>(Bi, rk, xi);
}

// log|det| of the eliminated band from its frozen blocks Bb (nb, W, W):
// per-thread partial sums over the block rows, then a fixed-order tree
// across the block, so the value does not depend on scheduling. `red` is
// shared scratch of blockDim.x doubles (a power of two); thread 0 writes
// *ld. Every thread of the block must call this.
template <int W, bool PIVOT>
__device__ void cr_logdet_blocks(const double* Bb, int nb, double* ld,
                                 double* red) {
  constexpr int WW = W * W;
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

// ---------------------------------------------------------------------------
// Factor once, then solve each right-hand side from the factor.
//
// Of what the elimination computes, only the right-hand-side updates
// depend on the right-hand side. cr_block_factor computes the rest once per band
// and stores it: for every level k (stride s = 2^k) and even row i = 2 s j
// the coefficients alpha and beta of cr_coef, and the block triples after
// the last level, where every row's A, B and C are those its back
// substitution reads (a row is frozen from the level at which it turns odd;
// row 0's B is the fully reduced row). cr_block_apply replays the
// right-hand-side half of the elimination on the stored values: the same
// operands in the same order, so the same bits. Nothing is re-rounded (no
// stored inverse): the pivoted small solves of row 0 and of the back
// substitution stay.
//
// One band's factor is cr_factor_size(nb, W) doubles: the A, B and C blocks
// (nb each), then alpha and beta (cr_even_rows(nb) blocks each, level by
// level, each level's even rows in order); each block W x W row-major.

// levels of the elimination: ceil(log2 nb)
__host__ __device__ inline int cr_levels(int nb) {
  int k = 0;
  while ((1 << k) < nb) ++k;
  return k;
}

// even rows (i = 2^{k+1} j < nb) summed over the levels k
__host__ __device__ inline long long cr_even_rows(int nb) {
  long long t = 0;
  for (int k = 0; (1 << k) < nb; ++k) t += (nb + (2 << k) - 1) / (2 << k);
  return t;
}

__host__ __device__ inline long long cr_factor_size(int nb, int W) {
  return (3LL * nb + 2 * cr_even_rows(nb)) * W * W;
}

// The factor F of the band (npad, 2W+1). Every thread of the block must
// call this.
template <int W, bool PIVOT>
__device__ void cr_block_factor(const double* band, double* F, int npad) {
  constexpr int WW = W * W;
  const int nb = npad / W;
  double* Ab = F;
  double* Bb = Ab + (long long)nb * WW;
  double* Cb = Bb + (long long)nb * WW;
  double* al = Cb + (long long)nb * WW;
  double* be = al + cr_even_rows(nb) * WW;

  cr_to_blocks<W>(band, Ab, Bb, Cb, nb);
  __syncthreads();
  const int steps = cr_levels(nb);
  long long off = 0;
  for (int k = 0; k < steps; ++k) {
    const int s = 1 << k;
    const int ne = (nb + 2 * s - 1) / (2 * s);
    for (int j = threadIdx.x; j < ne; j += blockDim.x) {
      const int i = 2 * s * j;
      double alpha[W][W], beta[W][W];
      cr_coef<W, PIVOT>(Ab, Bb, Cb, i, s, nb, alpha, beta);
      store_block<W>(al + (off + j) * WW, alpha);
      store_block<W>(be + (off + j) * WW, beta);
      cr_fold_blocks<W>(alpha, beta, Ab, Bb, Cb, i, s, nb);
    }
    off += ne;
    __syncthreads();
  }
}

// Solve with the factor F of a band (npad, 2W+1) against the B columns of R
// (row stride L), in place, as eliminating the band itself would. The columns
// are independent, so blocks may take disjoint column ranges of one system
// from the same factor. Every thread of the block must call this.
template <int W, bool PIVOT>
__device__ void cr_block_apply(const double* __restrict__ F, double* R,
                               int npad, int B, long long L) {
  constexpr int WW = W * W;
  // pairs of a level each thread takes per trip: all loads of a trip are
  // issued before its stores (the compiler cannot tell that a level's
  // stores and loads touch different rows)
  constexpr int U = W == 1 ? 4 : 1;
  const int nb = npad / W;
  const double* Ab = F;
  const double* Bb = Ab + (long long)nb * WW;
  const double* Cb = Bb + (long long)nb * WW;
  const double* al = Cb + (long long)nb * WW;
  const double* be = al + cr_even_rows(nb) * WW;
  const int steps = cr_levels(nb);
  const int nt = blockDim.x;

  // forward levels: R_i += alpha R_{i-s} + beta R_{i+s} on the even rows
  long long off = 0;
  for (int k = 0; k < steps; ++k) {
    const int s = 1 << k;
    const int ne = (nb + 2 * s - 1) / (2 * s);
    const int np = ne * B;
    for (int e0 = threadIdx.x; e0 < np; e0 += U * nt) {
      double alpha[U][W][W], beta[U][W][W], ri[U][W], rm[U][W], rp[U][W];
      int iu[U], bu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * nt;
        if (e < np) {
          const int j = e / B;
          iu[u] = 2 * s * j;
          bu[u] = e - j * B;
          load_block<W>(al + (off + j) * WW, alpha[u]);
          load_block<W>(be + (off + j) * WW, beta[u]);
          cr_load_rhs<W>(R, L, iu[u], s, nb, bu[u], ri[u], rm[u], rp[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e0 + u * nt < np) {
          double out[W];
          cr_fold_rhs<W>(alpha[u], beta[u], ri[u], rm[u], rp[u], out);
#pragma unroll
          for (int r = 0; r < W; ++r)
            R[(long long)(iu[u] * W + r) * L + bu[u]] = out[r];
        }
      }
    }
    off += ne;
    __syncthreads();
  }

  // the fully reduced row 0
  for (int b = threadIdx.x; b < B; b += nt) {
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
    const int np = no * B;
    for (int e0 = threadIdx.x; e0 < np; e0 += U * nt) {
      double Ai[U][W][W], Bi[U][W][W], Ci[U][W][W], xm[U][W], xp[U][W],
          ri[U][W];
      int iu[U], bu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * nt;
        if (e < np) {
          const int j = e / B;
          const int i = s + 2 * s * j, b = e - j * B;
          iu[u] = i;
          bu[u] = b;
          load_block<W>(Ab + (long long)i * WW, Ai[u]);
          load_block<W>(Cb + (long long)i * WW, Ci[u]);
          load_block<W>(Bb + (long long)i * WW, Bi[u]);
#pragma unroll
          for (int r = 0; r < W; ++r) {
            xm[u][r] = R[(long long)((i - s) * W + r) * L + b];
            xp[u][r] =
                (i + s < nb) ? R[(long long)((i + s) * W + r) * L + b] : 0.0;
            ri[u][r] = R[(long long)(i * W + r) * L + b];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e0 + u * nt < np) {
          double xi[W][1];
          cr_back_row<W, PIVOT>(Ai[u], Bi[u], Ci[u], xm[u], xp[u], ri[u], xi);
#pragma unroll
          for (int r = 0; r < W; ++r)
            R[(long long)(iu[u] * W + r) * L + bu[u]] = xi[r][0];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace repro
