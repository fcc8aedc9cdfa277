// The Gauss actor of motion detection on Hopper: a 5x5 binomial blur with
// edge-padded neighbours and the 2-pixel border passed through, over a
// batch of frames.  On u8 frames it also rounds back to u8 (the actor's
// port contract), so one Gauss firing is one launch.
//
// Replaces the TPU kernel src/repro/kernels/gauss5x5/kernel.py::gauss5x5_pallas.
//
// Bound: bytes.  A pixel reads one input and writes one output; the blur
// needs its separable 5 + 5 multiply-adds, 20 operations per 2 B on u8
// frames and per 8 B on f32.  The main path's (4, 240, 320) u8 window is
// 307 200 B in and 307 200 B out: about 0.18 us at 3.35 TB/s, so a launch
// takes about as long as its own start-up, one trip to device memory and
// back, and the instructions on its critical path (on an H100, by CUDA
// graph replay, a copy_ of the same bytes takes about 1.3 us; PERF.md).
//
// u8 frames (the graph's case), one memory round trip and one barrier per
// block: a block owns a band of R rows of one frame over up to 512 columns
// (at (4, 240, 320) 120 blocks, one wave), a warp per staged row (the
// band's R + 4 rows, row indices clamped at the frame's edges) and 16
// columns a lane, read with one 16-byte load.  The separable 1-4-6-4-1
// passes run in integers, the TPU kernel's structure: the row pass in
// registers, the neighbouring lanes' edge columns by shuffles, two pixels
// to a 32-bit word (each sum at most 4 080), into shared memory; after the
// barrier the column pass over five rows of sums (at most 65 280), again
// two pixels a word.  A sum S equals 256 times the plain version's float32
// blur exactly (every partial sum of that blur is a multiple of 1/256
// below 256, exact in float32), so S / 256 rounded half to even, in
// integers, is the plain version's u8 pixel to the bit (motion.cuh).  The
// output goes out in 16-byte stores, the 2-pixel border passing the input
// through.  Frames whose width is not a multiple of 16, or that start off
// a 16-byte boundary, take the same passes with byte loads and stores.
//
// float32 frames (no graph path takes them) keep the 25-tap kernel: 32 x 8
// tiles staged as floats, the plain version's tap order rounded per
// operation (motion::gauss_px), so it too agrees with its plain version to
// the bit.
#include <cuda_runtime.h>

#include "motion.cuh"

namespace {

// ---- uint8 frames --------------------------------------------------------- //
constexpr int R = 8;             // output rows per block
constexpr int ROWS = R + 4;      // staged rows, 2 above and 2 below: a warp each
constexpr int NT = 32 * ROWS;    // threads per block
constexpr int CW = 32 * 16;      // columns per block at most: 16 a lane

__device__ __forceinline__ unsigned byte_of(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xffu;
}

// Columns c0 .. c0 + n - 1 of a row as bytes of a word, each clamped to the
// frame (the byte path).
__device__ __forceinline__ unsigned bytes_at(const unsigned char* row, int c0, int n,
                                             int W) {
  unsigned v = 0;
  for (int j = 0; j < n; ++j)
    v |= static_cast<unsigned>(row[motion::clampi(c0 + j, 0, W - 1)]) << (8 * (j & 3));
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(NT)
gauss5x5_u8_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ y,
                   int H, int W) {
  __shared__ uint4 px[ROWS][32];       // the staged rows, a lane's 16 columns each
  __shared__ uint4 hs[ROWS][64];       // their row sums, two pixels a word

  const long long plane = static_cast<long long>(H) * W;
  x += blockIdx.z * plane;
  y += blockIdx.z * plane;
  const int y0 = blockIdx.y * R, x0 = blockIdx.x * CW;
  const int cw = min(CW, W - x0);
  const int strips = (cw + 15) / 16;
  const int r = threadIdx.x / 32, s = threadIdx.x % 32;
  const int xs = x0 + 16 * s;          // this lane's first column
  const bool last = s == strips - 1;
  const unsigned char* row = x + static_cast<long long>(motion::clampi(y0 - 2 + r, 0, H - 1)) * W;

  // ---- loads: staged row y0 - 2 + r (clamped), a lane's 16 columns; lane 0
  // also the 4 before the block, the last lane the 4 after, where the frame
  // has them.  Columns past the frame's edges are clamped ---------------- //
  uint4 mid = make_uint4(0, 0, 0, 0);
  unsigned lo = 0, hi = 0;
  if (kVec) {
    if (s < strips) mid = *reinterpret_cast<const uint4*>(row + xs);
    if (s == 0 && x0 > 0) lo = *reinterpret_cast<const unsigned*>(row + x0 - 4);
    if (last && x0 + cw < W) hi = *reinterpret_cast<const unsigned*>(row + x0 + cw);
  } else {
    if (s < strips)
      mid = make_uint4(bytes_at(row, xs, 4, W), bytes_at(row, xs + 4, 4, W),
                       bytes_at(row, xs + 8, 4, W), bytes_at(row, xs + 12, 4, W));
    if (s == 0 && x0 > 0) lo = bytes_at(row, x0 - 4, 4, W);
    if (last && x0 + cw < W) hi = bytes_at(row, x0 + cw, 4, W);
  }
  if (s == 0 && x0 == 0) lo = (mid.x & 0xffu) * 0x01010101u;   // column 0, clamped
  if (last && x0 + cw == W) hi = byte_of(mid, W - 1 - xs) * 0x01010101u;

  // ---- row pass in registers: the neighbours' columns by shuffles ------- //
  const unsigned left = __shfl_up_sync(0xffffffffu, mid.w, 1);
  const unsigned right = __shfl_down_sync(0xffffffffu, mid.x, 1);
  // Columns xs - 4 .. xs + 19 as six words; column xs + c is byte c + 4.
  const unsigned w[6] = {s == 0 ? lo : left, mid.x, mid.y, mid.z, mid.w, last ? hi : right};
  // e[i]: columns xs + 2 i - 2 and + 2 i - 1 in a word's 16-bit halves;
  // o[i]: columns xs + 2 i - 1 and + 2 i.  Pixels 2 j and 2 j + 1 then
  // take the pass over e[j], o[j], e[j + 1], o[j + 1], e[j + 2] together.
  unsigned e[10], o[9];
#pragma unroll
  for (int i = 0; i < 10; ++i)
    e[i] = __byte_perm(w[(2 * i + 2) / 4], 0, (i & 1) ? 0x4140 : 0x4342);
#pragma unroll
  for (int i = 0; i < 9; ++i) o[i] = __funnelshift_r(e[i], e[i + 1], 16);
  unsigned sums[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    sums[j] = motion::binomial5(e[j], o[j], e[j + 1], o[j + 1], e[j + 2]);
  if (s < strips) {
    px[r][s] = mid;
    hs[r][2 * s] = make_uint4(sums[0], sums[1], sums[2], sums[3]);
    hs[r][2 * s + 1] = make_uint4(sums[4], sums[5], sums[6], sums[7]);
  }
  __syncthreads();

  // ---- column pass, rounding, border, store: warp r, output row y0 + r -- //
  const int oy = y0 + r;
  if (r >= R || s >= strips || oy >= H) return;
  uint4 v[5][2];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    v[d][0] = hs[r + d][2 * s];
    v[d][1] = hs[r + d][2 * s + 1];
  }
  unsigned q[8];  // rounded pixels 2 j and 2 j + 1 in bytes 0 and 2
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    auto word = [&](int d) {
      const uint4& u = v[d][j / 4];
      return (j & 3) == 0 ? u.x : (j & 3) == 1 ? u.y : (j & 3) == 2 ? u.z : u.w;
    };
    q[j] = motion::rint_div256_pair(
        motion::binomial5(word(0), word(1), word(2), word(3), word(4)));
  }
  const uint4 in = px[r + 2][s];
  uint4 out = in;                      // border rows pass through
  if (oy >= 2 && oy < H - 2) {
    out = make_uint4(__byte_perm(q[0], q[1], 0x6420), __byte_perm(q[2], q[3], 0x6420),
                     __byte_perm(q[4], q[5], 0x6420), __byte_perm(q[6], q[7], 0x6420));
    // The strip's border columns (below 2, from W - 2) pass through: a bit
    // per byte, then a byte mask per word.
    const int rb = W - 2 - xs;
    const unsigned m = (xs == 0 ? 0x3u : 0u) | (rb < 16 ? 0xffffu << max(rb, 0) : 0u);
    if (m & 0xffffu) {
      auto keep = [&](unsigned o, unsigned a, int k) {
        const unsigned b = ((((m >> (4 * k)) & 0xfu) * 0x00204081u) & 0x01010101u) * 0xffu;
        return (o & ~b) | (a & b);
      };
      out = make_uint4(keep(out.x, in.x, 0), keep(out.y, in.y, 1), keep(out.z, in.z, 2),
                       keep(out.w, in.w, 3));
    }
  }
  unsigned char* dst = y + static_cast<long long>(oy) * W + xs;
  if (kVec) {
    *reinterpret_cast<uint4*>(dst) = out;
  } else {
    const int n = min(16, W - xs);
    for (int j = 0; j < n; ++j) dst[j] = static_cast<unsigned char>(byte_of(out, j));
  }
}

// ---- float32 frames ------------------------------------------------------- //
constexpr int TX = 32, TY = 8;  // output tile; one thread per pixel
constexpr int HALO = 2;

__global__ void __launch_bounds__(TX * TY)
gauss5x5_f32_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W) {
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
    tile[ty][tx] = x[static_cast<long long>(gy) * W + gx];
  }
  __syncthreads();
  const int oy = blockIdx.y * TY + threadIdx.y;
  const int ox = blockIdx.x * TX + threadIdx.x;
  if (oy >= H || ox >= W) return;
  const int cy = threadIdx.y + HALO, cx = threadIdx.x + HALO;
  auto at = [&](int dy, int dx) { return tile[cy + dy][cx + dx]; };
  y[static_cast<long long>(oy) * W + ox] = motion::gauss_px(at, oy, ox, H, W);
}

}  // namespace

// Blur `n` frames of H x W, contiguous, from `x` into `y` (no aliasing) on
// `stream` (PyTorch's current stream): float32 frames when u8 == 0, uint8
// frames (rounded to u8) otherwise.  Returns cudaGetLastError().
extern "C" int gauss5x5_run(const void* x, void* y, int n, int H, int W, int u8,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u8) {
    const dim3 grid((W + CW - 1) / CW, (H + R - 1) / R, n);
    const bool vec = W % 16 == 0 && (reinterpret_cast<unsigned long long>(x) & 15) == 0 &&
                     (reinterpret_cast<unsigned long long>(y) & 15) == 0;
    const auto* src = static_cast<const unsigned char*>(x);
    auto* dst = static_cast<unsigned char*>(y);
    if (vec)
      gauss5x5_u8_kernel<true><<<grid, NT, 0, s>>>(src, dst, H, W);
    else
      gauss5x5_u8_kernel<false><<<grid, NT, 0, s>>>(src, dst, H, W);
  } else {
    const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, n);
    const dim3 block(TX, TY);
    gauss5x5_f32_kernel<<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gauss5x5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
