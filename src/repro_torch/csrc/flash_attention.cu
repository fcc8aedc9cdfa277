// Forward attention with a blocked online softmax on Hopper: GQA (query
// head h reads KV head h / G), causal and sliding-window masks, bf16 in and
// out, float32 accumulation.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
//
// Bound: operations.  The live (query, key) pairs each cost hd multiply-
// adds for the scores and hd for the output, 4 * hd flop; at
// recurrentgemma-2b's prefill shape (B 4, S 4096, 10 query heads on one KV
// head, hd 256, causal, window 2048) that is about 2.6e11 flop, 0.26 ms on
// the bf16 tensor cores (989 TFLOP/s), against about 0.06 ms for the
// 210 MB of q, k, v and out.
//
// Design.  One block of 4 warps owns 64 "rows" of one (batch, KV head):
// the query rows of all G heads that share that KV head, in (position,
// head) order, so one staged K/V tile serves G query heads at once (the
// TPU kernel re-reads it per head).  Each warp owns 16 rows.  The block
// walks the key tiles of 64 keys that hold a live key for any of its rows
// (below the causal diagonal, inside the window) and skips the rest, as
// the TPU kernel's pl.when does, so the window costs O(S * window).
// Scores and the output go through the tensor cores with
// mma.sync.m16n8k16 (bf16 operands, float32 sums); the score tile stays in
// registers and is reused, rounded to bf16, as the A operand of P @ V.
// Q, K and V tiles sit in dynamic shared memory (101 376 B at hd 256), rows
// padded by 16 B so the fragment loads hit distinct banks.  The softmax
// follows the TPU kernel's order and its finite NEG_INF = -1e30: a row
// whose keys in a tile are all masked gets exp(0) = 1 entries that the
// first unmasked key wipes (alpha = exp(-1e30 - m) = 0); keys past the end
// of the sequence, which the TPU kernel never has, get -inf and weight 0.
// wgmma, TMA and warp specialisation are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16;  // rows per block
constexpr int BK = 64;          // keys per tile
constexpr float NEG_INF = -1e30f;

template <int HDP>
__host__ __device__ constexpr int stride() { return HDP + 8; }  // bf16 elements per smem row

template <int HDP>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(BM + 2 * BK) * stride<HDP>() * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// d += a * b for one 16x8x16 tile (row-major A, column-major B).
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage `rows` rows of a (B, S, heads, hd) tensor into smem, 16 B at a
// time, zero past `hd` and past the last row.  `src_row(i)` is the element
// offset of row i, or -1 for a row that does not exist.
template <int HDP, typename RowFn>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      int rows, int hd, RowFn src_row) {
  constexpr int CH = HDP / 8;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int row = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const long long off = src_row(row);
    if (off >= 0 && c < hd) val = *reinterpret_cast<const uint4*>(src + off + c);
    *reinterpret_cast<uint4*>(dst + row * stride<HDP>() + c) = val;
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int S, int H, int Hkv, int hd, int causal, int window, float scale) {
  constexpr int STR = stride<HDP>();
  constexpr int NT = HDP / 8;  // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * STR;
  __nv_bfloat16* Vs = Ks + BK * STR;

  const int G = H / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const long long R = static_cast<long long>(S) * G;  // rows of this (b, hk)
  const long long r0 = static_cast<long long>(blockIdx.x) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  auto q_row = [&](int i) -> long long {
    const long long r = r0 + i;
    if (r >= R) return -1;
    const long long pos = r / G;
    return ((static_cast<long long>(b) * S + pos) * H + hk * G + r % G) * hd;
  };
  stage<HDP>(Qs, q, BM, hd, q_row);

  // Positions of this thread's two rows (row g and g + 8 of its warp);
  // rows past the end borrow the last position and are never stored.
  long long rr[2];
  int pos[2];
  for (int h = 0; h < 2; ++h) {
    rr[h] = r0 + warp * 16 + g + 8 * h;
    pos[h] = static_cast<int>((rr[h] < R ? rr[h] : R - 1) / G);
  }
  const int w_lo = static_cast<int>(min(r0 + warp * 16, R - 1) / G);
  const int w_hi = static_cast<int>(min(r0 + warp * 16 + 15, R - 1) / G);
  const int p_lo = static_cast<int>(r0 / G);
  const int p_hi = static_cast<int>(min(r0 + BM - 1, R - 1) / G);

  // Key tiles holding a live key for some row of the block.
  int k_lo = 0;
  if (window > 0) k_lo = max(0, p_lo - window + 1);
  const int k_hi = causal ? p_hi : S - 1;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.0f, 0.0f};
  const int qrow = warp * 16 + g;

  for (int kt = (k_lo / BK) * BK; kt <= k_hi; kt += BK) {
    __syncthreads();  // Q staged; the previous tile's K/V no longer read
    auto kv_row = [&](int i) -> long long {
      const int key = kt + i;
      if (key >= S) return -1;
      return ((static_cast<long long>(b) * S + key) * Hkv + hk) * hd;
    };
    stage<HDP>(Ks, k, BK, hd, kv_row);
    stage<HDP>(Vs, v, BK, hd, kv_row);
    __syncthreads();

    // This warp's rows see no live key in the tile: skip it (exact, as the
    // TPU kernel's block skip is).
    if ((causal && kt > w_hi) || (window > 0 && w_lo - (kt + BK - 1) >= window)) continue;

    // Scores S = Q K^T for 16 rows x 64 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + qrow * STR + kk * 16 + 2 * tq;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * STR);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * STR + 8);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * STR + kk * 16 + 2 * tq;
        mma(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    // Scale and mask, then the online softmax update of both rows.
    float m_cur[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = kt + j * 8 + 2 * tq + (e & 1);
        float val;
        if (key >= S) {
          val = -CUDART_INF_F;
        } else {
          const bool live = (!causal || key <= pos[h]) &&
                            (window <= 0 || pos[h] - key < window);
          val = live ? s[j][e] * scale : NEG_INF;
        }
        s[j][e] = val;
        m_cur[h] = fmaxf(m_cur[h], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 1));
      m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 2));
      const float m_new = fmaxf(m_run[h], m_cur[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float l_cur[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = expf(s[j][e] - m_run[h]);
        l_cur[h] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_cur[h] += __shfl_xor_sync(0xffffffffu, l_cur[h], 1);
      l_cur[h] += __shfl_xor_sync(0xffffffffu, l_cur[h], 2);
      l_run[h] = alpha[h] * l_run[h] + l_cur[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: the score registers, rounded to bf16, are the A operand.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_f2(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_f2(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vb = Vs + (kk * 16 + 2 * tq) * STR + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* vn = vb + n * 8;
        const uint32_t b0 = pack2(vn[0], vn[STR]);
        const uint32_t b1 = pack2(vn[8 * STR], vn[9 * STR]);
        mma(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // Normalise and store both rows, bf16.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rr[h] >= R) continue;
    const float l = fmaxf(l_run[h], 1e-20f);
    __nv_bfloat16* dst =
        o + ((static_cast<long long>(b) * S + pos[h]) * H + hk * G + rr[h] % G) * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * tq;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + d) =
            __floats2bfloat162_rn(acc[n][2 * h] / l, acc[n][2 * h + 1] / l);
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int Hkv, int hd, int causal, int window, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<HDP>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long rows = static_cast<long long>(S) * (H / Hkv);
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM), Hkv, B);
  flash_fwd_kernel<HDP><<<grid, THREADS, smem_bytes<HDP>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, Hkv,
      hd, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: contiguous (B, S, H, hd) bf16; k, v: contiguous (B, S, Hkv, hd)
// bf16, 16-byte aligned; H a multiple of Hkv; hd a multiple of 8, at most
// 256.  causal: 0 or 1; window: the sliding window, or 0 for none; scale:
// the score scale (1 / sqrt(hd)).  Launches on `stream`; returns a CUDA
// error code (0 on success).
extern "C" int flash_attention_run(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int Hkv, int hd, int causal,
                                   int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch<64>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
  if (hd <= 128) return launch<128>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
  return launch<256>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
