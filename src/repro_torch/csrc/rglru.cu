// The RG-LRU diagonal recurrence of RecurrentGemma on Hopper:
//   h_t = exp(log_a_t) * h_{t-1} + gx_t,   h_0 = 0,
// over (B, L, W) float32 planes; writes every h_t and the final state.
//
// Replaces the TPU kernel src/repro/kernels/rglru/kernel.py::rglru_pallas.
//
// Bound: bytes.  Each step reads two floats and writes one (plus the
// final state), and does one exp, one multiply and one add: about
// 12 B per 3 flop plus an exp, far under the card's ridge.  At the
// serving shape (4, 4096, 2560) that is 503 MB, about 0.15 ms at
// 3.35 TB/s.
//
// Design for that bound: one thread per (batch, channel), walking L in
// order with the state in a register, so neighbouring threads touch
// neighbouring channels and every load and store is coalesced.  Loads run
// UNROLL steps ahead of the dependent chain, which keeps several loads in
// flight per thread.  B * W = 4 * 2560 = 10 240 threads do not fill the
// card (132 SMs could hold about 270 000), so the bandwidth reached is
// limited by loads in flight; a chunked parallel scan over L would fix
// that and is work for a later change.  The arithmetic rounds as the
// plain version and the TPU kernel do: exp, then the product, then the
// sum, each rounded on its own (no fused multiply-add).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ gx,
             float* __restrict__ h_seq, float* __restrict__ h_last, int L, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const long long base = static_cast<long long>(b) * L * W + w;
  const float* la = log_a + base;
  const float* g = gx + base;
  float* hs = h_seq + base;
  float h = 0.0f;
  int t = 0;
  for (; t + UNROLL <= L; t += UNROLL) {
    float a_r[UNROLL], g_r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = static_cast<long long>(t + u) * W;
      a_r[u] = la[off];
      g_r[u] = g[off];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(expf(a_r[u]), h), g_r[u]);
      hs[static_cast<long long>(t + u) * W] = h;
    }
  }
  for (; t < L; ++t) {
    const long long off = static_cast<long long>(t) * W;
    h = __fadd_rn(__fmul_rn(expf(la[off]), h), g[off]);
    hs[off] = h;
  }
  h_last[static_cast<long long>(b) * W + w] = h;
}

}  // namespace

// log_a, gx, h_seq: contiguous (B, L, W) float32; h_last: (B, W) float32.
// Launches on `stream` (PyTorch's current stream); returns
// cudaGetLastError().
extern "C" int rglru_run(const void* log_a, const void* gx, void* h_seq,
                         void* h_last, int B, int L, int W, void* stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(gx),
      static_cast<float*>(h_seq), static_cast<float*>(h_last), L, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
