// The per-pixel arithmetic of the motion detection actors (paper §4.1):
// the Gauss actor's 5x5 binomial blur, the u8 rounding at every port, the
// Thres actor's frame difference and the Med actor's plus-shaped median.
//
// Shared by kernel B3 (gauss5x5.cu), kernel B4 (motion_post.cu) and kernel
// B2 (megakernel.cu, the gauss/thres/med bodies), so the three give the
// same bits.  Each stencil takes a loader `at(dy, dx)` that returns the
// pixel at offset (dy, dx) from the output pixel with edge (clamped)
// indices already applied: B3's float path and B4 read a staged tile, B2
// reads device memory.  Every float operation follows the plain PyTorch
// versions (kernels/gauss5x5/ref.py, kernels/motion_post/ref.py) in order
// and is rounded on its own (_rn intrinsics, so nvcc contracts nothing
// into FMAs).  B3's u8 path computes the same blur in integers
// (binomial5, rint_div256_pair), exact where the float sum is.
#pragma once

#include <cuda_runtime.h>

namespace motion {

// Binomial weights [1, 4, 6, 4, 1] / 16 per axis; a 2-D tap is their
// product c[dy] * c[dx] / 256, exact in float32.
__device__ __forceinline__ float gauss_weight(int dy, int dx) {
  const int c[5] = {1, 4, 6, 4, 1};
  return static_cast<float>(c[dy] * c[dx]) * (1.f / 256.f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The Gauss actor passes the 2-pixel border (rows and columns) through.
__device__ __forceinline__ bool gauss_border(int y, int x, int H, int W) {
  return y < 2 || y >= H - 2 || x < 2 || x >= W - 2;
}

// One output pixel of the blur: the 25 taps in row-major order, summed
// from 0 as the plain version's acc = acc + w * x; the border passes the
// centre pixel through.
template <typename At>
__device__ __forceinline__ float gauss_px(At at, int y, int x, int H, int W) {
  if (gauss_border(y, x, H, W)) return at(0, 0);
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy)
#pragma unroll
    for (int dx = 0; dx < 5; ++dx)
      acc = __fadd_rn(acc, __fmul_rn(gauss_weight(dy, dx), at(dy - 2, dx - 2)));
  return acc;
}

// The blur's separable form on u8 frames (B3): one 1-4-6-4-1 pass in
// integers, a + 4 b + 6 c + 4 d + e.  A row pass over bytes is at most
// 16 * 255 = 4 080 and a column pass over row sums at most 16 * 4 080 =
// 65 280, so the column pass also runs on two sums packed in a word's
// 16-bit halves, no half carrying into the other.  Its result S is 256
// times gauss_px's float32 sum exactly: every partial sum there is a
// multiple of 1/256 below 256, exact in float32.
__device__ __forceinline__ unsigned binomial5(unsigned a, unsigned b, unsigned c,
                                              unsigned d, unsigned e) {
  return a + e + ((b + d) << 2) + (c << 2) + (c << 1);
}

// to_u8(S * (1/256.f)) for two column-pass sums S <= 65 280 packed in a
// word's 16-bit halves, in integers: floor(S / 256) plus one where the
// remainder is above 128, or exactly 128 with an odd floor (half to even);
// the results land in bytes 0 and 2.  Never above 255, so no clamp.
__device__ __forceinline__ unsigned rint_div256_pair(unsigned s) {
  return ((s + 0x007f007fu + ((s >> 8) & 0x00010001u)) >> 8) & 0x00ff00ffu;
}

// jnp.clip(jnp.round(x), 0, 255).astype(uint8): round half to even (rintf;
// roundf would round ties away from zero), then clamp.
__device__ __forceinline__ unsigned char to_u8(float v) {
  return static_cast<unsigned char>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

// The Thres actor: |cur - prev| > T -> 255, else 0.
__device__ __forceinline__ float thres_px(float cur, float prev, float threshold) {
  return fabsf(__fsub_rn(cur, prev)) > threshold ? 255.f : 0.f;
}

// Median of 5 through the reference's min/max network:
// med3(e, max(min(a,b), min(c,d)), min(max(a,b), max(c,d))).
__device__ __forceinline__ float median5(float a, float b, float c, float d, float e) {
  const float f = fmaxf(fminf(a, b), fminf(c, d));
  const float g = fminf(fmaxf(a, b), fmaxf(c, d));
  return fmaxf(fminf(f, g), fminf(e, fmaxf(f, g)));
}

// The Med actor: plus-shaped median (up, down, left, right, centre).
template <typename At>
__device__ __forceinline__ float med_px(At at) {
  return median5(at(-1, 0), at(1, 0), at(0, -1), at(0, 1), at(0, 0));
}

}  // namespace motion
