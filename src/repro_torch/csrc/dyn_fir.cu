// One DPD Poly actor on Hopper: the basis phi_k(x) = x * |x|^(2(k-1))
// fused with a causal 10-tap complex FIR.
//
// Replaces the TPU kernel src/repro/kernels/dyn_fir/kernel.py::dpd_branch_pallas.
//
// Bound: memory.  Each output sample reads one complex input (8 B) and
// writes one complex output (8 B) for about 2 * (40 + 2k) flop, so 6-9
// flop/B, far under the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s,
// about 20 flop/B).  At the main path's L = 32768 a firing moves about
// 0.5 MB, about 0.16 us at 3.35 TB/s: one launch per firing is bound by
// the launch itself, not by the card.
//
// Design for that bound: every input byte is read from device memory once
// and every output byte written once, coalesced.  A block owns a tile of
// TILE output samples; it stages the tile's TILE + 9 input samples (the
// 9-sample halo comes from the actor's history for the first tile) into
// shared memory as *basis* values, computing the basis once per staged
// sample instead of once per tap, then applies the 10 taps from shared
// memory.  History and window arrive through separate pointers, so a
// firing never materialises concat([hist, window]).  The kernel also writes
// the actor's next history (the stream's last 9 samples), so the firing
// needs no second launch to carry it.  Taps and the order are kernel
// arguments (the taps as device pointers, so nothing syncs to the host).
// The remaining cost, one launch per firing, is what kernel B2
// (megakernel.cu) removes: it runs the same arithmetic (dyn_fir.cuh)
// inside one launch per network run.
#include <cuda_runtime.h>

#include "dyn_fir.cuh"

namespace {

using dyn_fir::HALO;
using dyn_fir::N_TAPS;
constexpr int TILE = 256;  // output samples (and threads) per block

__global__ void __launch_bounds__(TILE)
dyn_fir_branch_kernel(const float* __restrict__ hist_re,
                      const float* __restrict__ hist_im,
                      const float* __restrict__ win_re,
                      const float* __restrict__ win_im,
                      const float* __restrict__ h_re,
                      const float* __restrict__ h_im,
                      float* __restrict__ y_re,
                      float* __restrict__ y_im,
                      float* __restrict__ next_re,
                      float* __restrict__ next_im,
                      int L, int order) {
  __shared__ float sb_re[TILE + HALO];
  __shared__ float sb_im[TILE + HALO];
  __shared__ float sh_re[N_TAPS];
  __shared__ float sh_im[N_TAPS];

  const int base = blockIdx.x * TILE;  // first output sample of the tile
  if (blockIdx.x == 0 && threadIdx.x < HALO) {
    // Next history: stream samples L .. L + 8 of hist ++ window.
    const int g = L + threadIdx.x;
    next_re[threadIdx.x] = g < HALO ? hist_re[g] : win_re[g - HALO];
    next_im[threadIdx.x] = g < HALO ? hist_im[g] : win_im[g - HALO];
  }
  // Staged index j is stream sample base + j of hist ++ window, whose
  // window part starts at stream index HALO.
  for (int j = threadIdx.x; j < TILE + HALO; j += TILE) {
    const int g = base + j;
    float xr = 0.f, xi = 0.f;
    if (g < HALO) {
      xr = hist_re[g];
      xi = hist_im[g];
    } else if (g - HALO < L) {
      xr = win_re[g - HALO];
      xi = win_im[g - HALO];
    }
    dyn_fir::basis(xr, xi, order, &sb_re[j], &sb_im[j]);
  }
  if (threadIdx.x < N_TAPS) {
    sh_re[threadIdx.x] = h_re[threadIdx.x];
    sh_im[threadIdx.x] = h_im[threadIdx.x];
  }
  __syncthreads();

  const int n = base + threadIdx.x;
  if (n >= L) return;
  dyn_fir::fir_mac(sb_re, sb_im, sh_re, sh_im, threadIdx.x, &y_re[n], &y_im[n]);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError().
// The output and next-history buffers must not alias the inputs.
extern "C" int dyn_fir_branch(const float* hist_re, const float* hist_im,
                              const float* win_re, const float* win_im,
                              const float* h_re, const float* h_im,
                              float* y_re, float* y_im, float* next_re,
                              float* next_im, int L, int order, void* stream) {
  const int blocks = (L + TILE - 1) / TILE;
  dyn_fir_branch_kernel<<<blocks, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      hist_re, hist_im, win_re, win_im, h_re, h_im, y_re, y_im, next_re,
      next_im, L, order);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dyn_fir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
