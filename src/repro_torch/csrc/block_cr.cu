// Standalone block cyclic-reduction solve + exact log-determinant, float64.
//
// Replaces: src/repro/kernels/block_cr.py, block_cr_pallas (kernel body
// `_kernel` around `cr_solve_values`), with its wrappers
// block_cr_solve_pallas and block_cr_logdet_pallas. The likelihood path
// reaches it for log|A| and log|A + Phi/s^2| (w = 1 at q = 0), for every
// SAPhi solve of the preconditioned Taylor log-determinant (w = 1) and for
// the generalized-KP B solves of the gradients (w = 2); at q = 1 it also
// carries every Phi solve (w = 1).
//
// What bounds it on the H100: not bytes (one pass over a band and its
// right-hand sides is ~0.03 ms at the path's shapes) but the log-depth
// chain of ceil(log2 nb) levels each way, one barrier per level, with the
// block algebra's latency inside each level. The reference runs one grid
// step per matrix on one TPU core; here one thread block per matrix g runs
// the elimination of cr.cuh, so G = 10 matrices occupy 10 of the 132 SMs.
//
// Design: the elimination is the device function shared with the
// whole-solve kernels (cr.cuh), instantiated for W in {1, 2, 3, 4} (W = 4:
// the generalized-KP B at q = 2), pivoted or not, solving or
// log-determinant only. The wrapper pads n to whole blocks
// with identity rows and copies the right-hand sides into the output, which
// the elimination overwrites with x in place; the block triples live in a
// workspace the wrapper allocates.
//
// Also here: the factor launch of the whole-solve PCG kernel
// (repro_cr_factor_f64), one block per band running cr.cuh's
// cr_block_factor, which stores the right-hand-side-independent half of the
// elimination (coefficients per level, frozen block triples) for
// mega_pcg.cu to read in every solve. It replaces that half of the same
// reference body (`cr_solve_values` inside mega_pcg_solve_pallas's
// `_block_solve_dim`); like the solve, it is a log-depth chain of levels
// with one barrier each, run once per operand stack.
#include "common.cuh"
#include "cr.cuh"

namespace {

constexpr int NT = 256;  // threads per block (a power of two: logdet tree)

template <int W, bool PIVOT, bool SOLVE>
__global__ void __launch_bounds__(NT)
    block_cr_kernel(const double* __restrict__ band, double* x, double* ld,
                    double* work, int npad, int B) {
  __shared__ double red[NT];
  const int g = blockIdx.x;
  const long long nbw = (long long)npad * W;  // (nb, W, W) doubles
  const long long G = gridDim.x;
  double* ab = work + (long long)g * nbw;
  double* bb = work + (G + g) * nbw;
  double* cb = work + (2 * G + g) * nbw;
  double* xg = SOLVE ? x + (long long)g * npad * B : nullptr;
  repro::cr_block_solve<W, PIVOT, SOLVE, true>(
      band + (long long)g * npad * (2 * W + 1), xg, ab, bb, cb, npad, B,
      ld + g, red);
}

template <int W>
cudaError_t launch(const double* band, double* x, double* ld, double* work,
                   int G, int npad, int B, bool pivot, bool solve,
                   cudaStream_t st) {
  if (pivot && solve)
    block_cr_kernel<W, true, true><<<G, NT, 0, st>>>(band, x, ld, work, npad, B);
  else if (pivot)
    block_cr_kernel<W, true, false><<<G, NT, 0, st>>>(band, x, ld, work, npad, B);
  else if (solve)
    block_cr_kernel<W, false, true><<<G, NT, 0, st>>>(band, x, ld, work, npad, B);
  else
    block_cr_kernel<W, false, false><<<G, NT, 0, st>>>(band, x, ld, work, npad, B);
  return cudaGetLastError();
}

template <int W, bool PIVOT>
__global__ void __launch_bounds__(NT)
    cr_factor_kernel(const double* __restrict__ band, double* fac,
                     int npad) {
  const int g = blockIdx.x;
  repro::cr_block_factor<W, PIVOT>(
      band + (long long)g * npad * (2 * W + 1),
      fac + g * repro::cr_factor_size(npad / W, W), npad);
}

template <int W>
cudaError_t launch_factor(const double* band, double* fac, int G, int npad,
                          bool pivot, cudaStream_t st) {
  if (pivot)
    cr_factor_kernel<W, true><<<G, NT, 0, st>>>(band, fac, npad);
  else
    cr_factor_kernel<W, false><<<G, NT, 0, st>>>(band, fac, npad);
  return cudaGetLastError();
}

}  // namespace

// band (G, npad, 2w+1) identity-padded to npad = nb * w rows; x (G, npad, B)
// holds the right-hand sides on entry and the solution on return (unused
// when solve == 0); ld (G,); work 3 * G * npad * w doubles.
extern "C" int repro_block_cr_f64(const double* band, double* x, double* ld,
                                  double* work, int G, int npad, int w, int B,
                                  int pivot, int solve, void* stream) {
  if (G < 1 || npad < 1 || w < 1 || w > 4 || npad % w || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
    case 1: return (int)launch<1>(band, x, ld, work, G, npad, B, pivot, solve, st);
    case 2: return (int)launch<2>(band, x, ld, work, G, npad, B, pivot, solve, st);
    case 3: return (int)launch<3>(band, x, ld, work, G, npad, B, pivot, solve, st);
    default: return (int)launch<4>(band, x, ld, work, G, npad, B, pivot, solve, st);
  }
}

// The block-CR factors of G bands (G, npad, 2w+1), npad = nb * w, 1 <= w
// <= 3: fac holds G * cr_factor_size(nb, w) doubles (cr.cuh's layout).
extern "C" int repro_cr_factor_f64(const double* band, double* fac, int G,
                                   int npad, int w, int pivot, void* stream) {
  if (G < 1 || npad < 1 || w < 1 || w > 3 || npad % w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
    case 1: return (int)launch_factor<1>(band, fac, G, npad, pivot, st);
    case 2: return (int)launch_factor<2>(band, fac, G, npad, pivot, st);
    default: return (int)launch_factor<3>(band, fac, G, npad, pivot, st);
  }
}
