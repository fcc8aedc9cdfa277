// The fused Thres + Med tail of motion detection on Hopper:
// |cur - prev| > T -> {0, 255}, then a plus-shaped 5-point median over the
// edge-padded map, over a batch of float32 frame pairs.
//
// Replaces the TPU kernel
// src/repro/kernels/motion_post/kernel.py::motion_post_pallas.  The
// reference's graph runs its Thres and Med actors as two bodies instead
// (graphs/motion_detection.py); kernel B2 runs them so, with this kernel's
// arithmetic (motion.cuh).
//
// Bound: bytes.  A pixel reads two floats and writes one (12 B) for about
// a dozen compares: (4, 240, 320) frame pairs move 3.7 MB, about 1.1 us at
// 3.35 TB/s.
//
// Design for that bound: every input byte is read from device memory once
// and every output written once, coalesced.  A block of 32 x 8 threads
// owns a 32 x 8 output tile of one frame (blockIdx.z); it thresholds the
// tile with its 1-pixel halo (clamped, edge indices) into shared memory,
// so the difference map never reaches device memory, then takes the
// median from shared memory.  Only compares, fabsf, one subtraction and
// min/max: exact, equal to the plain version to the bit.
#include <cuda_runtime.h>

#include "motion.cuh"

namespace {

constexpr int TX = 32, TY = 8;  // output tile; one thread per pixel
constexpr int HALO = 1;

__global__ void __launch_bounds__(TX * TY)
motion_post_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                   float* __restrict__ out, int H, int W, float threshold) {
  __shared__ float map[TY + 2 * HALO][TX + 2 * HALO];
  const long long plane = static_cast<long long>(H) * W;
  cur += blockIdx.z * plane;
  prev += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int y0 = blockIdx.y * TY - HALO;
  const int x0 = blockIdx.x * TX - HALO;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < (TY + 2 * HALO) * (TX + 2 * HALO); i += TX * TY) {
    const int ty = i / (TX + 2 * HALO), tx = i % (TX + 2 * HALO);
    const long long g = static_cast<long long>(motion::clampi(y0 + ty, 0, H - 1)) * W +
                        motion::clampi(x0 + tx, 0, W - 1);
    map[ty][tx] = motion::thres_px(cur[g], prev[g], threshold);
  }
  __syncthreads();
  const int oy = blockIdx.y * TY + threadIdx.y;
  const int ox = blockIdx.x * TX + threadIdx.x;
  if (oy >= H || ox >= W) return;
  const int cy = threadIdx.y + HALO, cx = threadIdx.x + HALO;
  out[static_cast<long long>(oy) * W + ox] =
      motion::med_px([&](int dy, int dx) { return map[cy + dy][cx + dx]; });
}

}  // namespace

// Thres + Med over `n` float32 frame pairs of H x W, contiguous, into `out`
// (no aliasing) on `stream` (PyTorch's current stream).  Returns
// cudaGetLastError().
extern "C" int motion_post_run(const float* cur, const float* prev, float* out,
                               int n, int H, int W, float threshold, void* stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, n);
  motion_post_kernel<<<grid, dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      cur, prev, out, H, W, threshold);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* motion_post_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
