// RGF block-tridiagonal inverse recurrences (paper Algorithm 5), float64.
//
// Replaces: src/repro/kernels/rgf.py, rgf_blocks_pallas (kernel body
// `_rgf_kernel`), which computes the posterior-variance band G = band(H^-1).
//
//   F_0 = D_0,          F_j = D_j - L_j F_{j-1}^{-1} U_{j-1}
//   W_{T-1} = D_{T-1},  W_j = D_j - U_j W_{j+1}^{-1} L_{j+1}
//   G_jj = (F_j + W_j - D_j)^{-1}
//   G_{j,j+1} = -F_j^{-1} U_j G_{j+1,j+1},  G_{j+1,j} = -W_{j+1}^{-1} L_{j+1} G_jj
//
// What bounds it on the H100: latency. Each recurrence is a chain of T
// dependent w x w block solves (T = n at q = 0), so its least time is T
// times the latency of one step, not the bytes (3 T w^2 doubles in, 3 out).
//
// Design: one block per batch item. The forward and backward recurrences
// run at once on two threads in different warps, with the running block in
// registers (w x w with w <= 5 or w = 7, unrolled by template; w = 2q + 1
// is H = A Phi^T at q; at w = 7 the running blocks no longer fit the
// registers and spill to local memory) and the Schur
// complements written to global scratch; the loads of D/U/L do not depend
// on the chain, so they issue ahead of it. After one __syncthreads every
// thread of the block combines independent j in parallel: G_jj first, then
// the off-diagonal blocks.
#include "common.cuh"

namespace {

template <int W>
__global__ void rgf_kernel(const double* __restrict__ Dg,
                           const double* __restrict__ U,
                           const double* __restrict__ L,
                           double* __restrict__ Gd, double* __restrict__ Gu,
                           double* __restrict__ Gl, double* __restrict__ F,
                           double* __restrict__ Wb, int T) {
  using repro::block_solve;
  using repro::load_block;
  using repro::mm;
  using repro::store_block;
  constexpr int WW = W * W;
  const long long base = (long long)blockIdx.x * T * WW;
  const double* D = Dg + base;
  const double* Ub = U + base;
  const double* Lb = L + base;
  double* Fb = F + base;
  double* Wk = Wb + base;
  double* Gdb = Gd + base;
  double* Gub = Gu + base;
  double* Glb = Gl + base;

  if (threadIdx.x == 0) {
    double Fp[W][W];
    load_block<W>(D, Fp);
    store_block<W>(Fb, Fp);
    for (int j = 1; j < T; ++j) {
      double Dj[W][W], Uj[W][W], Lj[W][W], X[W][W], LX[W][W];
      load_block<W>(D + (long long)j * WW, Dj);
      load_block<W>(Ub + (long long)(j - 1) * WW, Uj);
      load_block<W>(Lb + (long long)j * WW, Lj);
      block_solve<W, W, true, false>(Fp, Uj, X);
      mm<W>(Lj, X, LX);
#pragma unroll
      for (int r = 0; r < W; ++r)
#pragma unroll
        for (int c = 0; c < W; ++c) Fp[r][c] = Dj[r][c] - LX[r][c];
      store_block<W>(Fb + (long long)j * WW, Fp);
    }
  } else if (threadIdx.x == 32) {
    double Wn[W][W];
    load_block<W>(D + (long long)(T - 1) * WW, Wn);
    store_block<W>(Wk + (long long)(T - 1) * WW, Wn);
    for (int j = T - 2; j >= 0; --j) {
      double Dj[W][W], Uj[W][W], Ln[W][W], X[W][W], UX[W][W];
      load_block<W>(D + (long long)j * WW, Dj);
      load_block<W>(Ub + (long long)j * WW, Uj);
      load_block<W>(Lb + (long long)(j + 1) * WW, Ln);
      block_solve<W, W, true, false>(Wn, Ln, X);
      mm<W>(Uj, X, UX);
#pragma unroll
      for (int r = 0; r < W; ++r)
#pragma unroll
        for (int c = 0; c < W; ++c) Wn[r][c] = Dj[r][c] - UX[r][c];
      store_block<W>(Wk + (long long)j * WW, Wn);
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    double Fj[W][W], Wj[W][W], Dj[W][W], S[W][W], Id[W][W], G[W][W];
    load_block<W>(Fb + (long long)j * WW, Fj);
    load_block<W>(Wk + (long long)j * WW, Wj);
    load_block<W>(D + (long long)j * WW, Dj);
#pragma unroll
    for (int r = 0; r < W; ++r)
#pragma unroll
      for (int c = 0; c < W; ++c) {
        S[r][c] = Fj[r][c] + Wj[r][c] - Dj[r][c];
        Id[r][c] = (r == c) ? 1.0 : 0.0;
      }
    block_solve<W, W, true, false>(S, Id, G);
    store_block<W>(Gdb + (long long)j * WW, G);
  }
  __syncthreads();

  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    double Gu_[W][W], Gl_[W][W];
    if (j < T - 1) {
      double Fj[W][W], Uj[W][W], Gn[W][W], P[W][W];
      load_block<W>(Fb + (long long)j * WW, Fj);
      load_block<W>(Ub + (long long)j * WW, Uj);
      load_block<W>(Gdb + (long long)(j + 1) * WW, Gn);
      mm<W>(Uj, Gn, P);
      block_solve<W, W, true, false>(Fj, P, Gu_);
      double Wn[W][W], Ln[W][W], Gj[W][W], Q[W][W];
      load_block<W>(Wk + (long long)(j + 1) * WW, Wn);
      load_block<W>(Lb + (long long)(j + 1) * WW, Ln);
      load_block<W>(Gdb + (long long)j * WW, Gj);
      mm<W>(Ln, Gj, Q);
      block_solve<W, W, true, false>(Wn, Q, Gl_);
#pragma unroll
      for (int r = 0; r < W; ++r)
#pragma unroll
        for (int c = 0; c < W; ++c) {
          Gu_[r][c] = -Gu_[r][c];
          Gl_[r][c] = -Gl_[r][c];
        }
    } else {
#pragma unroll
      for (int r = 0; r < W; ++r)
#pragma unroll
        for (int c = 0; c < W; ++c) Gu_[r][c] = Gl_[r][c] = 0.0;
    }
    store_block<W>(Gub + (long long)j * WW, Gu_);
    store_block<W>(Glb + (long long)j * WW, Gl_);
  }
}

}  // namespace

extern "C" int repro_rgf_blocks_f64(const double* Dg, const double* U,
                                    const double* L, double* Gd, double* Gu,
                                    double* Gl, double* F, double* W, int G,
                                    int T, int w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || T < 1) return (int)cudaErrorInvalidValue;
  switch (w) {
    case 1: rgf_kernel<1><<<G, 256, 0, st>>>(Dg, U, L, Gd, Gu, Gl, F, W, T); break;
    case 2: rgf_kernel<2><<<G, 256, 0, st>>>(Dg, U, L, Gd, Gu, Gl, F, W, T); break;
    case 3: rgf_kernel<3><<<G, 256, 0, st>>>(Dg, U, L, Gd, Gu, Gl, F, W, T); break;
    case 4: rgf_kernel<4><<<G, 256, 0, st>>>(Dg, U, L, Gd, Gu, Gl, F, W, T); break;
    case 5: rgf_kernel<5><<<G, 256, 0, st>>>(Dg, U, L, Gd, Gu, Gl, F, W, T); break;
    case 7: rgf_kernel<7><<<G, 256, 0, st>>>(Dg, U, L, Gd, Gu, Gl, F, W, T); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
