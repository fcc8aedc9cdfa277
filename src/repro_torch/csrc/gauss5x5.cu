// The Gauss actor of motion detection on Hopper: a 5x5 binomial blur with
// edge-padded neighbours and the 2-pixel border passed through, over a
// batch of frames.  On u8 frames it also rounds back to u8 (the actor's
// port contract), so one Gauss firing is one launch.
//
// Replaces the TPU kernel src/repro/kernels/gauss5x5/kernel.py::gauss5x5_pallas.
//
// Bound: bytes.  A pixel reads one input and writes one output; the blur
// needs its separable 5 + 5 multiply-adds, 20 flop per 2 B on u8 frames
// (10 flop/B, under the card's fp32 ridge of about 20 flop/B) and 20 flop
// per 8 B on f32.  The main path's (4, 240, 320) u8 window is 307 200 B in
// and 307 200 B out: about 0.18 us at 3.35 TB/s, against a few us of
// launch, so one launch per firing is bound by the launch, as B1 is.  The
// 25 taps this kernel runs (below) cost more flop than the bound charges.
//
// Design for that bound: every input byte is read from device memory once
// and every output written once, coalesced.  A block of 32 x 8 threads
// owns a 32 x 8 output tile of one frame (blockIdx.z) and stages the
// tile with its 2-pixel halo into shared memory as floats, with clamped
// (edge) indices, so the 25 taps read shared memory; the TPU kernel's
// separable passes over VMEM row slabs are not needed at this size.  The
// arithmetic (motion.cuh) is the plain version's 25-tap order, rounded
// per operation, so B3 and its plain version agree to the bit.
#include <cuda_runtime.h>

#include "motion.cuh"

namespace {

constexpr int TX = 32, TY = 8;  // output tile; one thread per pixel
constexpr int HALO = 2;

__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ unsigned char to_out(float v, unsigned char*) {
  return motion::to_u8(v);
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
gauss5x5_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W) {
  __shared__ float tile[TY + 2 * HALO][TX + 2 * HALO];
  const long long plane = static_cast<long long>(H) * W;
  x += blockIdx.z * plane;
  y += blockIdx.z * plane;
  const int y0 = blockIdx.y * TY - HALO;
  const int x0 = blockIdx.x * TX - HALO;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < (TY + 2 * HALO) * (TX + 2 * HALO); i += TX * TY) {
    const int ty = i / (TX + 2 * HALO), tx = i % (TX + 2 * HALO);
    const int gy = motion::clampi(y0 + ty, 0, H - 1);
    const int gx = motion::clampi(x0 + tx, 0, W - 1);
    tile[ty][tx] = static_cast<float>(x[static_cast<long long>(gy) * W + gx]);
  }
  __syncthreads();
  const int oy = blockIdx.y * TY + threadIdx.y;
  const int ox = blockIdx.x * TX + threadIdx.x;
  if (oy >= H || ox >= W) return;
  const int cy = threadIdx.y + HALO, cx = threadIdx.x + HALO;
  auto at = [&](int dy, int dx) { return tile[cy + dy][cx + dx]; };
  y[static_cast<long long>(oy) * W + ox] =
      to_out(motion::gauss_px(at, oy, ox, H, W), static_cast<T*>(nullptr));
}

}  // namespace

// Blur `n` frames of H x W, contiguous, from `x` into `y` (no aliasing) on
// `stream` (PyTorch's current stream): float32 frames when u8 == 0, uint8
// frames (rounded to u8) otherwise.  Returns cudaGetLastError().
extern "C" int gauss5x5_run(const void* x, void* y, int n, int H, int W, int u8,
                            void* stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, n);
  const dim3 block(TX, TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u8)
    gauss5x5_kernel<unsigned char><<<grid, block, 0, s>>>(
        static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), H, W);
  else
    gauss5x5_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gauss5x5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
