// The fused Thres + Med tail of motion detection on Hopper:
// |cur - prev| > T -> {0, 255}, then a plus-shaped 5-point median over the
// edge-padded map, over a batch of frame pairs: float32 or uint8 frames
// in, the float32 map out.
//
// Replaces the TPU kernel
// src/repro/kernels/motion_post/kernel.py::motion_post_pallas.  The
// reference's graph runs its Thres and Med actors as two bodies instead
// (graphs/motion_detection.py); kernel B2 runs them so, with motion.cuh's
// arithmetic.
//
// Bound: bytes.  A float pixel reads two floats and writes one (12 B), a
// u8 pixel two bytes and one float (6 B), for a handful of operations:
// (4, 240, 320) frame pairs move 3 686 400 B (float), about 1.10 us at
// 3.35 TB/s, or 1 843 200 B (u8), about 0.55 us.  A launch this short costs
// the launch itself, one trip to device memory and back, and the
// instructions on one thread's path between them.
//
// Design for that.  Every map value is 0 or 255, and the median of five
// such values is 255 exactly where at least 3 of them are: a majority vote
// on the threshold bits (the plain version's min/max network returns the
// true median on every order, so this is exact, NaN differences included:
// they threshold to 0 on both sides).  The map lives in bits in registers,
// with no shared memory and no barrier.  A thread owns a strip of 4
// columns over R = 4 rows; a warp owns 32 adjacent strips (128 columns) of
// one band of R rows.  The thread issues all R + 2 row loads of cur and prev
// (rows clamped to the frame: edge padding) before any compare, one
// 16-byte load a row for float and one 4-byte word for u8, then thresholds
// each row into a nibble of one 32-bit word (row r at bits 4 r .. 4 r + 3).
// The up and down neighbours are that word shifted by a nibble, with the
// two halo rows' nibbles shifted in; the left and right neighbours come
// from the adjacent lanes by shuffles (the warp's edge lanes load the one
// column beyond; the frame's edge columns are their own neighbours).  The
// 5-input majority then takes a dozen bitwise operations for all R rows at
// once, and each row goes out as a float4 of 255.f / 0.f.
//
// Thresholds: float pixels as the plain version, fabsf(cur - prev) > T
// rounded on its own; u8 pixels four at a time in integers, |cur - prev|
// per byte (__vabsdiffu4, exact) against the least integer difference above
// T (floor(T) + 1, 0 below T = 0, none from T = 255 or NaN), which for
// integer differences 0..255 is the same test.
//
// Frames whose width is not a multiple of 4, or operands off the vector
// width's alignment, take the same kernel with element loads at clamped
// columns (so a column past the frame repeats the last one, which is then
// its own right neighbour) and element stores.
//
// R: more rows a thread read their halo rows again less often but
// lengthen each thread's path (PERF.md, PR 20, has R = 1, 2, 4 and 8 side
// by side).  A build may set another R with -DMOTION_POST_ROWS=R
// (chip_smoke.py --b4 builds and times each).
#include <cuda_runtime.h>

#ifndef MOTION_POST_ROWS
#define MOTION_POST_ROWS 4
#endif

namespace {

constexpr int R = MOTION_POST_ROWS;  // output rows a thread
constexpr int WARPS = 4;            // warps a block, a band of R rows each
constexpr int NT = 32 * WARPS;      // threads a block
constexpr unsigned FULL = 0xffffffffu;

// The threshold, for float pixels and as a byte compare for u8 pixels:
// |c - p| > t  <=>  |c - p| >= ge for integer differences 0..255.
struct Threshold {
  float t;
  unsigned ge4;   // ge in every byte
  unsigned keep;  // 0 where no difference passes (t >= 255 or NaN)
  __device__ explicit Threshold(float t_) : t(t_) {
    const bool none = !(t_ < 255.f);
    const float ge = t_ >= 0.f ? floorf(t_) + 1.f : 0.f;
    ge4 = none ? 0u : static_cast<unsigned>(ge) * 0x01010101u;
    keep = none ? 0u : FULL;
  }
};

// One row's 4 columns x .. x + 3 of a strip (x < W): one vector load, or
// element loads at columns clamped to the frame.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int x, int W) {
  if (kVec) return *reinterpret_cast<const float4*>(row + x);
  return make_float4(row[x], row[min(x + 1, W - 1)], row[min(x + 2, W - 1)],
                     row[min(x + 3, W - 1)]);
}

template <bool kVec>
__device__ __forceinline__ unsigned load4(const unsigned char* __restrict__ row, int x,
                                          int W) {
  if (kVec) return *reinterpret_cast<const unsigned*>(row + x);
  return static_cast<unsigned>(row[x]) | static_cast<unsigned>(row[min(x + 1, W - 1)]) << 8 |
         static_cast<unsigned>(row[min(x + 2, W - 1)]) << 16 |
         static_cast<unsigned>(row[min(x + 3, W - 1)]) << 24;
}

// Threshold bits of one pixel, and of a row's 4 pixels as a nibble.
__device__ __forceinline__ unsigned bit1(float c, float p, const Threshold& th) {
  return fabsf(__fsub_rn(c, p)) > th.t ? 1u : 0u;
}

__device__ __forceinline__ unsigned bit1(unsigned char c, unsigned char p,
                                         const Threshold& th) {
  return __vcmpgeu4(__vabsdiffu4(c, p), th.ge4) & th.keep & 1u;
}

__device__ __forceinline__ unsigned bits4(float4 c, float4 p, const Threshold& th) {
  return bit1(c.x, p.x, th) | bit1(c.y, p.y, th) << 1 | bit1(c.z, p.z, th) << 2 |
         bit1(c.w, p.w, th) << 3;
}

__device__ __forceinline__ unsigned bits4(unsigned c, unsigned p, const Threshold& th) {
  const unsigned ge = __vcmpgeu4(__vabsdiffu4(c, p), th.ge4) & th.keep;  // 0xff a byte
  return ((ge & 0x80808080u) * 0x00204081u) >> 28;  // bytes' top bits to bits 0..3
}

// At least 3 of the 5 bits set, bit by bit: a + b + c by a full adder,
// d + e by a half adder, then the sum of the two is at least 3.
__device__ __forceinline__ unsigned majority5(unsigned a, unsigned b, unsigned c,
                                              unsigned d, unsigned e) {
  const unsigned s1 = a ^ b ^ c, c1 = (a & b) | (c & (a ^ b));
  const unsigned s2 = d ^ e, c2 = d & e;
  return (c1 & c2) | ((c1 | c2) & (s1 | s2));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(NT)
motion_post_kernel(const T* __restrict__ cur, const T* __restrict__ prev,
                   float* __restrict__ out, int H, int W, float threshold) {
  static_assert(R >= 1 && R <= 8, "a strip's R nibbles fill at most one 32-bit word");
  using V = decltype(load4<kVec>(cur, 0, W));
  const int y0 = (blockIdx.y * WARPS + threadIdx.x / 32) * R;  // the warp's band
  if (y0 >= H) return;                                          // the whole warp
  const long long plane = static_cast<long long>(H) * W;
  cur += blockIdx.z * plane;
  prev += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int lane = threadIdx.x % 32;
  const int S = (W + 3) / 4;                  // strips a row
  const int s = blockIdx.x * 32 + lane;       // columns 4 s .. 4 s + 3
  const int x = 4 * s;
  const bool live = s < S;
  const bool edge_l = lane == 0 && s > 0;     // left column in another warp
  const bool edge_r = lane == 31 && s + 1 < S;
  const Threshold th(threshold);

  // ---- every load first: rows y0 - 1 .. y0 + R (clamped), and the edge
  // lanes' column beyond the warp for rows y0 .. y0 + R - 1 ------------- //
  V c[R + 2], p[R + 2];
  T ce[R], pe[R];
  if (live) {
#pragma unroll
    for (int i = 0; i < R + 2; ++i) {
      const long long off = static_cast<long long>(min(max(y0 - 1 + i, 0), H - 1)) * W;
      c[i] = load4<kVec>(cur + off, x, W);
      p[i] = load4<kVec>(prev + off, x, W);
    }
    if (edge_l || edge_r) {
      const int xe = edge_l ? x - 1 : x + 4;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long off = static_cast<long long>(min(y0 + r, H - 1)) * W + xe;
        ce[r] = cur[off];
        pe[r] = prev[off];
      }
    }
  }

  // ---- threshold bits: row r of the band at nibble r of m -------------- //
  unsigned m = 0, top = 0, bot = 0, ext = 0;
  if (live) {
    top = bits4(c[0], p[0], th);
#pragma unroll
    for (int r = 0; r < R; ++r) m |= bits4(c[r + 1], p[r + 1], th) << (4 * r);
    bot = bits4(c[R + 1], p[R + 1], th);
    if (edge_l || edge_r) {
#pragma unroll
      for (int r = 0; r < R; ++r) ext |= bit1(ce[r], pe[r], th) << (4 * r + (edge_l ? 3 : 0));
    }
  }
  const unsigned from_l = __shfl_up_sync(FULL, m, 1);
  const unsigned from_r = __shfl_down_sync(FULL, m, 1);
  if (!live) return;
  // Column 4 s - 1 at bit 3 of each nibble, column 4 s + 4 at bit 0; the
  // frame's edge columns are their own neighbours.
  const unsigned lw = s == 0 ? m << 3 : edge_l ? ext : from_l;
  const unsigned rw = s == S - 1 ? m >> 3 : edge_r ? ext : from_r;
  const unsigned left = ((m << 1) & 0xeeeeeeeeu) | ((lw >> 3) & 0x11111111u);
  const unsigned right = ((m >> 1) & 0x77777777u) | ((rw << 3) & 0x88888888u);
  const unsigned up = (m << 4) | top;
  const unsigned down = (m >> 4) | (bot << (4 * (R - 1)));
  const unsigned o = majority5(up, down, left, right, m);

  // ---- rows out as float4 of 255.f / 0.f -------------------------------- //
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (y0 + r >= H) break;
    const unsigned b = o >> (4 * r);
    const float4 v = make_float4(b & 1u ? 255.f : 0.f, b & 2u ? 255.f : 0.f,
                                 b & 4u ? 255.f : 0.f, b & 8u ? 255.f : 0.f);
    float* dst = out + static_cast<long long>(y0 + r) * W + x;
    if (kVec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const int n = min(4, W - x);
      dst[0] = v.x;
      if (n > 1) dst[1] = v.y;
      if (n > 2) dst[2] = v.z;
      if (n > 3) dst[3] = v.w;
    }
  }
}

template <typename T>
void launch(const void* cur, const void* prev, float* out, int n, int H, int W,
            float threshold, bool vec, cudaStream_t stream) {
  const dim3 grid(((W + 3) / 4 + 31) / 32, ((H + R - 1) / R + WARPS - 1) / WARPS, n);
  const T* c = static_cast<const T*>(cur);
  const T* p = static_cast<const T*>(prev);
  if (vec)
    motion_post_kernel<T, true><<<grid, NT, 0, stream>>>(c, p, out, H, W, threshold);
  else
    motion_post_kernel<T, false><<<grid, NT, 0, stream>>>(c, p, out, H, W, threshold);
}

}  // namespace

// Thres + Med over `n` frame pairs of H x W, contiguous, float32 (u8 == 0)
// or uint8 (u8 != 0), into the float32 `out` (no aliasing) on `stream`
// (PyTorch's current stream).  Returns cudaGetLastError().
extern "C" int motion_post_run(const void* cur, const void* prev, float* out, int n,
                               int H, int W, int u8, float threshold, void* stream) {
  const auto addr = [](const void* q) { return reinterpret_cast<unsigned long long>(q); };
  const unsigned long long in_align = u8 ? 3 : 15;
  const bool vec = W % 4 == 0 && ((addr(cur) | addr(prev)) & in_align) == 0 &&
                   (addr(out) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u8)
    launch<unsigned char>(cur, prev, out, n, H, W, threshold, vec, s);
  else
    launch<float>(cur, prev, out, n, H, W, threshold, vec, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* motion_post_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
