// One DPD Poly actor on Hopper: the basis phi_k(x) = x * |x|^(2(k-1))
// fused with a causal 10-tap complex FIR.
//
// Replaces the TPU kernel src/repro/kernels/dyn_fir/kernel.py::dpd_branch_pallas.
//
// Bound: memory.  Each output sample reads one complex input (8 B) and
// writes one complex output (8 B) for about 2 * (40 + 2k) flop, so 6-9
// flop/B, far under the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s,
// about 20 flop/B).  At the main path's L = 32768 a firing moves about
// 0.5 MB, about 0.16 us at 3.35 TB/s, so a launch takes about as long as
// its own start-up, one trip to device memory and back, and the
// instructions on its critical path: on an H100, by CUDA graph replay, an
// empty launch of this grid takes about 1.1 us, a copy_ of the same bytes
// about 1.4 us, and powf (orders 5..10) adds about 0.2 us (PERF.md).
//
// Design for that bound: one memory round trip per block and a short
// critical path.  Four outputs a thread with 16-byte loads measured slower
// (its longer serial path per thread outweighs the wider loads), as did a
// rolled FIR loop.  A block owns a tile of 256 outputs, one a thread, and a
// ninth warp that loads the tile's 9-sample halo (from the actor's history
// for the first tile) and the 10 complex taps; every load goes out before
// the first basis.  Each staged sample's basis is computed once, at one
// call site (powf is long code), into shared memory as (re, im) pairs;
// after one barrier each thread reads its 10 basis pairs and the taps as
// 8- and 16-byte shared loads and runs its FIR chain.  The threads that
// loaded the stream's last 9 samples also write the actor's next history,
// so the firing needs no second launch to carry it.  History and window
// arrive through separate pointers with a row stride each, so a firing
// never materialises concat([hist, window]) and any window view is taken
// as it is.  Taps and the order are kernel arguments (the taps as device
// pointers, so nothing syncs to the host).  The arithmetic (dyn_fir.cuh)
// is the plain version's, rounded per operation, shared with kernel B2
// (megakernel.cu), which runs it inside one launch per network run.
#include <cuda_runtime.h>

#include "dyn_fir.cuh"

namespace {

using dyn_fir::HALO;
using dyn_fir::N_TAPS;
constexpr int TILE = 256;               // outputs per block, one a thread
constexpr int THREADS = TILE + 32;      // and a warp for the halo and the taps
static_assert(HALO + 2 * N_TAPS <= 32, "the halo and the taps fit one warp");

__global__ void __launch_bounds__(THREADS)
dyn_fir_branch_kernel(const float* __restrict__ hist, long long hist_stride,
                      const float* __restrict__ win, long long win_stride,
                      const float* __restrict__ taps, long long taps_stride,
                      float* __restrict__ y, float* __restrict__ next,
                      int L, int order) {
  // Stream sample base + i of hist ++ window (window sample base + i - 9)
  // at sb[i]; tap t as (re, im) at sh[t].
  __shared__ float2 sb[TILE + HALO];
  __shared__ __align__(16) float2 sh[N_TAPS];

  const int tid = threadIdx.x;
  const int base = blockIdx.x * TILE;
  const bool tile_thread = tid < TILE;
  const int h = tid - TILE;             // the last warp: halo lanes, then taps
  const int i = tile_thread ? HALO + tid : h;  // staged index of this thread's sample
  const int g = base + i;               // its stream index
  const bool staged = tile_thread || h < HALO;

  // ---- every load of the tile, before any arithmetic ----------------- //
  // Predicated selects, not branches, which measured slower (PERF.md).
  const bool valid = staged && g - HALO < L;
  const float* p = g < HALO ? hist + g : win + (g - HALO);  // first tile's halo: history
  const long long ps = g < HALO ? hist_stride : win_stride;
  const float xr = valid ? __ldg(p) : 0.f;
  const float xi = valid ? __ldg(p + ps) : 0.f;
  const int t = h - HALO;               // tap tt of plane t / N_TAPS
  const bool tap = t >= 0 && t < 2 * N_TAPS;
  const int tt = t >= N_TAPS ? t - N_TAPS : t;
  const float hv = tap ? __ldg(taps + (t >= N_TAPS ? taps_stride : 0) + tt) : 0.f;

  // ---- the basis at one call site; the next history from registers -- //
  if (staged) {
    float br, bi;
    dyn_fir::basis(xr, xi, order, &br, &bi);
    sb[i] = make_float2(br, bi);
    // Stream samples L .. L + 8 are the next history; a window sample is
    // written by its tile thread, a history sample by the first tile's halo.
    if (g >= L && g - HALO < L && (tile_thread || blockIdx.x == 0)) {
      next[g - L] = xr;
      next[g - L + HALO] = xi;
    }
  }
  if (tap) reinterpret_cast<float*>(sh)[2 * tt + (t >= N_TAPS)] = hv;
  __syncthreads();
  const int n = base + tid;
  if (!tile_thread || n >= L) return;

  // ---- the FIR: y[n] = sum_t h[t] * b[n + 9 - t] --------------------- //
  float b_re[HALO + 1], b_im[HALO + 1], h_re[N_TAPS], h_im[N_TAPS];
#pragma unroll
  for (int k = 0; k <= HALO; ++k) {
    const float2 v = sb[tid + k];
    b_re[k] = v.x;
    b_im[k] = v.y;
  }
#pragma unroll
  for (int k = 0; k < N_TAPS; k += 2) {
    const float4 v = *reinterpret_cast<const float4*>(&sh[k]);
    h_re[k] = v.x;
    h_im[k] = v.y;
    h_re[k + 1] = v.z;
    h_im[k + 1] = v.w;
  }
  dyn_fir::fir_mac(b_re, b_im, h_re, h_im, 0, &y[n], &y[n + L]);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError().
// Each operand is a pair of float32 planes, the second `*_stride` floats
// after the first: hist (2, 9), win (2, L), taps (2, 10).  y is a
// contiguous (2, L) output and next a contiguous (2, 9) one; neither may
// alias an input.
extern "C" int dyn_fir_branch(const float* hist, long long hist_stride,
                              const float* win, long long win_stride,
                              const float* taps, long long taps_stride,
                              float* y, float* next, int L, int order,
                              void* stream) {
  const int blocks = (L + TILE - 1) / TILE;
  dyn_fir_branch_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, hist_stride, win, win_stride, taps, taps_stride, y, next, L, order);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dyn_fir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
