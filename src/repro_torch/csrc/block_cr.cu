// Standalone block cyclic-reduction solve + exact log-determinant, float64,
// as two launches: factor once, then apply per right-hand side.
//
// Replaces: src/repro/kernels/block_cr.py, block_cr_pallas (kernel body
// `_kernel` around `cr_solve_values`), with its wrappers
// block_cr_solve_pallas and block_cr_logdet_pallas. The likelihood path
// reaches it for log|A| and log|A + Phi/s^2| (w = 1 at q = 0), for every
// SAPhi solve of the preconditioned Taylor log-determinant and of the kmg
// V-cycle (w = 1), and for the generalized-KP B solves of the gradients
// (w = 2); at q = 1 it also carries every Phi solve (w = 1). Widths
// 1 <= w <= 5 (w = 5: the generalized-KP B at q = 3) through the entry
// points repro_cr_factor_f64 / repro_cr_apply_f64, and 6 <= w <= 8 through
// repro_cr_factor_wide_f64 / repro_cr_apply_wide_f64: the windowed
// variance-band updates of a streaming insert or evict solve their
// Woodbury patches at half-width 2q + 2 (insert) and 2q + 1 (evict),
// pivoted, which at q = 2 and 3 is 6, 7 and 8. The wide entry points
// instantiate the same templates at W = 6..8; the w <= 5 instances (and
// their registers and bits) are untouched. They only have to be right: at
// W = 8 a block's solve holds several 8 x 8 blocks per thread and spills.
//
// What bounds it on the H100: not bytes (one pass over a band and its
// right-hand sides is ~0.03 ms at the path's shapes) but the log-depth
// chain of ceil(log2 nb) levels each way, one barrier per level, with the
// block algebra's latency inside each level. The reference runs one grid
// step per matrix on one TPU core.
//
// Design. Of the elimination, only the right-hand-side updates read the
// right-hand side, and a fitted GP solves the same bands many times (every
// V-cycle solves its SAPhi bands twice). So:
//   * the factor launch (repro_cr_factor_f64), one block per band, runs
//     cr.cuh's cr_block_factor: each level's coefficients alpha, beta and
//     the frozen block triples, stored (cr.cuh's layout). When asked it also
//     reduces log|det| over the frozen blocks with cr_logdet_blocks at
//     NT = 256 threads, the reduction the one-block solve used, so the
//     log-determinant keeps its bits. The whole-solve PCG kernel
//     (mega_pcg.cu) solves from the same factors;
//   * the apply launch (repro_cr_apply_f64) spreads (band, chunk of cpc
//     columns) items over the whole grid, one thread block each (not
//     cooperative: the items are independent). Each runs cr_block_apply on
//     its columns from the read-only factor, in place on x, with no
//     scratch. cr_block_apply replays the elimination's right-hand-side
//     expressions (cr_fold_rhs, cr_back_row), and a column's arithmetic does
//     not depend on its chunk, so factor plus apply gives the bits of one
//     block eliminating band and right-hand side together, at every chunk
//     width.
// The chunk width (cpc = 0: apply_cols) is the narrowest power of two that
// gives every item an SM of its own, mega_pcg.cu's rule: at G = 10 bands
// and B = 16 columns, two columns an item (80 items on 132 SMs). Wider
// items read more of each 32-byte sector of a row (B doubles a row), and
// with more items than SMs the ones that share an SM run behind each
// other; both cost more than the SMs left idle (widths 1-16 measured in
// PERF.md).
#include <climits>

#include "common.cuh"
#include "cr.cuh"

namespace {

constexpr int NT = 256;  // threads per block (a power of two: logdet tree)
constexpr int MAX_W = 5;
constexpr int MAX_WIDE_W = 8;

template <int W, bool PIVOT>
__global__ void __launch_bounds__(NT)
    cr_factor_kernel(const double* __restrict__ band, double* fac, double* ld,
                     int npad) {
  __shared__ double red[NT];
  const int g = blockIdx.x;
  const int nb = npad / W;
  double* F = fac + g * repro::cr_factor_size(nb, W);
  repro::cr_block_factor<W, PIVOT>(band + (long long)g * npad * (2 * W + 1),
                                   F, npad);
  // cr_block_factor ends on a barrier: every frozen block is written
  if (ld) repro::cr_logdet_blocks<W, PIVOT>(F + (long long)nb * W * W, nb,
                                            ld + g, red);
}

template <int W, bool PIVOT>
__global__ void __launch_bounds__(NT)
    cr_apply_kernel(const double* __restrict__ fac, double* x, int npad,
                    int B, int cpc, int chunks) {
  const int g = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - g * chunks) * cpc;
  const int nc = B - c0 < cpc ? B - c0 : cpc;
  repro::cr_block_apply<W, PIVOT>(
      fac + g * repro::cr_factor_size(npad / W, W),
      x + (long long)g * npad * B + c0, npad, nc, B);
}

template <int W>
cudaError_t launch_factor(const double* band, double* fac, double* ld, int G,
                          int npad, bool pivot, cudaStream_t st) {
  if (pivot)
    cr_factor_kernel<W, true><<<G, NT, 0, st>>>(band, fac, ld, npad);
  else
    cr_factor_kernel<W, false><<<G, NT, 0, st>>>(band, fac, ld, npad);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_apply(const double* fac, double* x, int items, int npad,
                         int B, int cpc, int chunks, bool pivot,
                         cudaStream_t st) {
  if (pivot)
    cr_apply_kernel<W, true><<<items, NT, 0, st>>>(fac, x, npad, B, cpc,
                                                   chunks);
  else
    cr_apply_kernel<W, false><<<items, NT, 0, st>>>(fac, x, npad, B, cpc,
                                                    chunks);
  return cudaGetLastError();
}

// The narrowest power of two c whose G * ceil(B / c) items fit on the SMs,
// one each (at most B).
int apply_cols(int G, int B, int sms) {
  int c = 1;
  while (c < B && (long long)G * ((B + c - 1) / c) > sms) c <<= 1;
  return c < B ? c : B;
}

int sm_count(int* sms) {
  int dev = 0;
  REPRO_RETURN_IF_ERR(cudaGetDevice(&dev));
  REPRO_RETURN_IF_ERR(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
  return 0;
}

}  // namespace

// The block-CR factors of G bands (G, npad, 2w+1), identity-padded to
// npad = nb * w rows, 1 <= w <= 5: fac holds G * cr_factor_size(nb, w)
// doubles (cr.cuh's layout); ld (G,) receives log|det| unless it is null.
extern "C" int repro_cr_factor_f64(const double* band, double* fac,
                                   double* ld, int G, int npad, int w,
                                   int pivot, void* stream) {
  if (G < 1 || npad < 1 || w < 1 || w > MAX_W || npad % w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
    case 1: return (int)launch_factor<1>(band, fac, ld, G, npad, pivot, st);
    case 2: return (int)launch_factor<2>(band, fac, ld, G, npad, pivot, st);
    case 3: return (int)launch_factor<3>(band, fac, ld, G, npad, pivot, st);
    case 4: return (int)launch_factor<4>(band, fac, ld, G, npad, pivot, st);
    default: return (int)launch_factor<5>(band, fac, ld, G, npad, pivot, st);
  }
}

// The wide instantiation of repro_cr_factor_f64: 6 <= w <= 8.
extern "C" int repro_cr_factor_wide_f64(const double* band, double* fac,
                                        double* ld, int G, int npad, int w,
                                        int pivot, void* stream) {
  if (G < 1 || npad < 1 || w <= MAX_W || w > MAX_WIDE_W || npad % w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
    case 6: return (int)launch_factor<6>(band, fac, ld, G, npad, pivot, st);
    case 7: return (int)launch_factor<7>(band, fac, ld, G, npad, pivot, st);
    default: return (int)launch_factor<8>(band, fac, ld, G, npad, pivot, st);
  }
}

// Columns per item that an apply launch with cpc = 0 takes (negative:
// -error).
extern "C" int repro_cr_apply_cols(int G, int B) {
  int sms = 0;
  const int err = sm_count(&sms);
  return err ? -err : apply_cols(G, B, sms);
}

// x (G, npad, B) holds the right-hand sides on entry and the solution on
// return: the solve with the factors fac of repro_cr_factor_f64 (the same
// G, npad, w and pivot), in items of cpc columns (0: apply_cols).
extern "C" int repro_cr_apply_f64(const double* fac, double* x, int G,
                                  int npad, int w, int B, int cpc, int pivot,
                                  void* stream) {
  if (G < 1 || npad < 1 || w < 1 || w > MAX_W || npad % w || B < 1 ||
      cpc < 0)
    return (int)cudaErrorInvalidValue;
  if (cpc == 0) {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err) return err;
    cpc = apply_cols(G, B, sms);
  }
  if (cpc > B) cpc = B;
  const int chunks = (B + cpc - 1) / cpc;
  if ((long long)G * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int items = G * chunks;
  cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
    case 1: return (int)launch_apply<1>(fac, x, items, npad, B, cpc, chunks, pivot, st);
    case 2: return (int)launch_apply<2>(fac, x, items, npad, B, cpc, chunks, pivot, st);
    case 3: return (int)launch_apply<3>(fac, x, items, npad, B, cpc, chunks, pivot, st);
    case 4: return (int)launch_apply<4>(fac, x, items, npad, B, cpc, chunks, pivot, st);
    default: return (int)launch_apply<5>(fac, x, items, npad, B, cpc, chunks, pivot, st);
  }
}

// The wide instantiation of repro_cr_apply_f64: 6 <= w <= 8.
extern "C" int repro_cr_apply_wide_f64(const double* fac, double* x, int G,
                                       int npad, int w, int B, int cpc,
                                       int pivot, void* stream) {
  if (G < 1 || npad < 1 || w <= MAX_W || w > MAX_WIDE_W || npad % w ||
      B < 1 || cpc < 0)
    return (int)cudaErrorInvalidValue;
  if (cpc == 0) {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err) return err;
    cpc = apply_cols(G, B, sms);
  }
  if (cpc > B) cpc = B;
  const int chunks = (B + cpc - 1) / cpc;
  if ((long long)G * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int items = G * chunks;
  cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
    case 6: return (int)launch_apply<6>(fac, x, items, npad, B, cpc, chunks, pivot, st);
    case 7: return (int)launch_apply<7>(fac, x, items, npad, B, cpc, chunks, pivot, st);
    default: return (int)launch_apply<8>(fac, x, items, npad, B, cpc, chunks, pivot, st);
  }
}
