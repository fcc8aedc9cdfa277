// The RG-LRU diagonal recurrence of RecurrentGemma on Hopper:
//   h_t = exp(log_a_t) * h_{t-1} + gx_t,   h_0 = 0,
// over (B, L, W) float32 planes; writes every h_t and the final state.
//
// Replaces the TPU kernel src/repro/kernels/rglru/kernel.py::rglru_pallas.
//
// Bound: bytes.  Each step reads two floats and writes one (plus the
// final state), and does one exp, one multiply and one add: about
// 12 B per 3 flop plus an exp, far under the card's ridge.  At the
// serving shape (4, 4096, 2560) that is 503 MB, 0.1503 ms at 3.35 TB/s.
//
// Design for that bound: keep the time order, and take the parallelism
// from channels and from asynchronous copies.  The serial part of a step
// is one multiply and one add (the exp does not depend on h), so what the
// card needs is bytes in flight, not a shorter chain.
//   * One block per (batch, tile of TILE_W = 32 channels): one step of a
//     tile is one 128-byte row, and (4, 4096, 2560) makes 320 blocks, all
//     resident at once.
//   * Warp 0 is the producer.  It streams tiles of T = 32 steps x 32
//     channels of log_a and gx (8 KB a stage) into a ring of STAGES = 3
//     stages in shared memory, each with a full and an empty mbarrier.
//     Where the row stride W * 4 and the operands' addresses allow it (W a
//     multiple of 4, 16-byte aligned), one thread starts two TMA loads a
//     stage over 3-D tensor maps of (B, L, W), box (1, T, 32), zeros
//     outside the tensor; elsewhere each lane copies its channel with
//     cp.async, 4 bytes at a time, and the copies arrive on the full
//     barrier as they complete.
//   * Warp 1 is the consumer.  Each lane owns one channel and walks time
//     in order with h in a register: it takes the exps of a whole stage
//     from shared memory ahead of the chain, then runs the chain.  On the
//     TMA path each h_t goes over log_a_t in the stage, and one TMA store
//     per stage sends the tile to h_seq (clipped at L and W); the stage
//     before is freed once its store has read it.  On the cp.async path the lanes
//     store h_t straight to h_seq.  Rows past L and channels past W are
//     neither used nor stored.
// In flight: up to two stages of loads a block, 16 KB, about 5 MB across
// the card at the serving shape, against the 3-4 MB that 3.35 TB/s at a
// loaded latency of about a microsecond needs.  Deeper rings and longer
// stages measured slower at the serving shape (PERF.md section 6).
// The TMA store spares the consumer one global store per step, which cost
// it more than its exps.
// The arithmetic rounds as the plain version and the TPU kernel do: exp,
// then the product, then the sum, each rounded on its own (no fused
// multiply-add), in time order; so the kernel is bit-identical to the
// plain version on the card.
//
// Measured (chip_smoke.py --b7, CUDA graph replay, NVIDIA H100 80GB HBM3,
// 700.00 W): 0.1740 ms per call at (4, 4096, 2560), 86 % of the bound and
// 95 % of torch.add over the same bytes (0.1654-0.1660 ms), against
// 0.5178-0.5179 ms for the one-thread-per-channel design it replaced;
// 0.0933 ms at (1, 4096, 2560) against 0.4549-0.4552 ms.  ptxas: 32
// registers (40 on the cp.async path), no spills, 24 752 B of dynamic
// shared memory a block.
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's type; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int TILE_W = 32;     // channels per block, one lane each
constexpr int T = 32;          // steps per stage
constexpr int STAGES = 3;      // depth of the ring
constexpr int THREADS = 64;    // warp 0 the producer, warp 1 the consumer
constexpr uint32_t PLANE_BYTES = T * TILE_W * sizeof(float);  // one input's stage
constexpr uint32_t STAGE_BYTES = 2 * PLANE_BYTES;             // log_a, then gx
constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
// The ring, then STAGES full and STAGES empty barriers; 128 bytes of slack
// to align the base.
constexpr size_t SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 128;

// ---- PTX helpers ----------------------------------------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A wait that
// lasts 2^34 cycles (about ten seconds) traps, so a broken ring fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - start > (1LL << 34)) __trap();
}

// TMA: the box (TILE_W channels from c0, T steps from c1, batch c2) of a
// (B, L, W) tensor into shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA: the tile at src in shared memory to the same box of a (B, L, W)
// tensor, clipped to the tensor.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async of one float; `bytes` 0 reads nothing and writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// ---- the kernel -------------------------------------------------------------- //

template <bool TMA>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_g,
             const __grid_constant__ CUtensorMap tm_h, const float* __restrict__ log_a,
             const float* __restrict__ gx, float* __restrict__ h_seq,
             float* __restrict__ h_last, int L, int W) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  float* ring = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t bars = base + BAR_OFF;
  auto full = [&](int s) -> uint32_t { return bars + 8u * s; };
  auto empty = [&](int s) -> uint32_t { return bars + 8u * (STAGES + s); };

  const int w0 = blockIdx.x * TILE_W;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int n_chunks = (L + T - 1) / T;
  const long long batch_off = static_cast<long long>(b) * L * W;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), TMA ? 1 : 32);   // the TMA thread, or every lane's copies
      mbar_init(empty(s), TMA ? 1 : 32);  // the storing lane, or every consumer lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    // ---- producer ---------------------------------------------------------- //
    if (TMA && lane != 0) return;
    for (int j = 0; j < n_chunks; ++j) {
      const int s = j % STAGES;
      const uint32_t dst = base + s * STAGE_BYTES;
      const int t0 = j * T;
      mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);  // the first pass finds the stage free
      if (TMA) {
        mbar_expect_tx(full(s), STAGE_BYTES);  // a box past L or W still counts in full
        tma_load(dst, &tm_a, full(s), w0, t0, b);
        tma_load(dst + PLANE_BYTES, &tm_g, full(s), w0, t0, b);
      } else {
        // Lane `lane` copies column `lane` of the tile.
        const int n = min(T, L - t0);
        const int w = w0 + lane;
        const uint32_t bytes = w < W ? 4u : 0u;  // a zero past W
        const long long off = batch_off + static_cast<long long>(t0) * W + (w < W ? w : 0);
        const uint32_t d = dst + 4u * lane;
        for (int u = 0; u < n; ++u) {
          const long long at = off + static_cast<long long>(u) * W;
          cp_async4(d + u * TILE_W * 4u, log_a + at, bytes);
          cp_async4(d + PLANE_BYTES + u * TILE_W * 4u, gx + at, bytes);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(full(s)) : "memory");
      }
    }
    return;
  }

  // ---- consumer: lane `lane` owns channel w ------------------------------------ //
  const int w = w0 + lane;
  const bool live = w < W;
  float* hs = h_seq + batch_off + (live ? w : 0);
  float h = 0.0f;
  for (int j = 0; j < n_chunks; ++j) {
    const int s = j % STAGES;
    mbar_wait(full(s), (j / STAGES) & 1);
    float* sa = ring + s * (STAGE_BYTES / 4) + lane;
    const float* sg = sa + PLANE_BYTES / 4;
    const int t0 = j * T;
    float* out = hs + static_cast<long long>(t0) * W;
    // h_t goes over log_a_t in the stage, which a TMA store then sends to
    // h_seq; on the cp.async path, straight to h_seq.
    auto put = [&](int u, float v) {
      if (TMA) sa[u * TILE_W] = v;
      else if (live) out[static_cast<long long>(u) * W] = v;
    };
    if (t0 + T <= L) {
      // A whole stage: its exps first, then the chain.
      float e[T], g[T];
#pragma unroll
      for (int u = 0; u < T; ++u) {
        e[u] = expf(sa[u * TILE_W]);
        g[u] = sg[u * TILE_W];
      }
#pragma unroll
      for (int u = 0; u < T; ++u) {
        h = __fadd_rn(__fmul_rn(e[u], h), g[u]);
        put(u, h);
      }
    } else {
      for (int u = 0; u < L - t0; ++u) {
        h = __fadd_rn(__fmul_rn(expf(sa[u * TILE_W]), h), sg[u * TILE_W]);
        put(u, h);
      }
    }
    if (TMA) {
      // The tile of h out by one TMA store (rows past L and columns past W
      // are clipped); the stage before is free once its store has read it.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        tma_store(&tm_h, base + s * STAGE_BYTES, w0, t0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        if (j > 0) mbar_arrive(empty((j - 1) % STAGES));
      }
    } else {
      mbar_arrive(empty(s));
    }
  }
  if (TMA && lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  if (live) h_last[static_cast<long long>(b) * W + w] = h;
}

// ---- host ---------------------------------------------------------------------- //

typedef decltype(&cuTensorMapEncodeTiled) EncodeFn;

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library does not link libcuda).  0 on success, else a CUDA
// runtime error code.
int encoder(EncodeFn* fn) {
  static EncodeFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<EncodeFn>(p);
  }
  *fn = cached;
  return 0;
}

// Negative codes: cuTensorMapEncodeTiled refused a map (-1000 - CUresult).
constexpr int ENCODE_FAILED = -1000;

// The tensor map of a contiguous (B, L, W) float32 tensor: 3-D, W
// innermost, boxes of TILE_W channels x T steps x 1 batch, no swizzle, zeros
// outside the tensor.  Needs W a multiple of 4 and a 16-byte aligned base.
int make_map(EncodeFn encode, CUtensorMap* map, const void* ptr, int B, int L, int W) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(W) * sizeof(float);
  const cuuint64_t strides[2] = {row, row * L};
  const cuuint32_t box[3] = {TILE_W, T, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED - static_cast<int>(r);
}

template <bool TMA>
int launch(const CUtensorMap& ma, const CUtensorMap& mg, const CUtensorMap& mh,
           const float* log_a, const float* gx, float* h_seq, float* h_last, int B, int L, int W,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(rglru_kernel<TMA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(rglru_kernel<TMA>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((W + TILE_W - 1) / TILE_W, B);
  rglru_kernel<TMA><<<grid, THREADS, SMEM_BYTES, stream>>>(ma, mg, mh, log_a, gx, h_seq,
                                                            h_last, L, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// log_a, gx, h_seq: contiguous (B, L, W) float32; h_last: (B, W) float32;
// 1 <= B <= 65535, L >= 1, W >= 1.  Loads and stores h_seq by TMA when W
// is a multiple of 4 and log_a, gx and h_seq are 16-byte aligned, else
// loads by cp.async and stores by the consumer's lanes.  One launch on
// `stream` (PyTorch's current stream); returns 0, a CUDA runtime error
// code, or a negative code when a tensor map is refused.
extern "C" int rglru_run(const void* log_a, const void* gx, void* h_seq, void* h_last, int B,
                         int L, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(log_a);
  const float* g = static_cast<const float*>(gx);
  float* hs = static_cast<float*>(h_seq);
  float* ht = static_cast<float*>(h_last);
  CUtensorMap ma = {}, mg = {}, mh = {};
  const bool tma = W % 4 == 0 && reinterpret_cast<uintptr_t>(log_a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h_seq) % 16 == 0;
  if (!tma) return launch<false>(ma, mg, mh, a, g, hs, ht, B, L, W, s);
  EncodeFn encode;
  int err = encoder(&encode);
  if (err != 0) return err;
  if ((err = make_map(encode, &ma, log_a, B, L, W)) != 0) return err;
  if ((err = make_map(encode, &mg, gx, B, L, W)) != 0) return err;
  if ((err = make_map(encode, &mh, h_seq, B, L, W)) != 0) return err;
  return launch<true>(ma, mg, mh, a, g, hs, ht, B, L, W, s);
}

extern "C" const char* rglru_error_string(int code) {
  static char buf[96];
  if (code <= ENCODE_FAILED) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             ENCODE_FAILED - code);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
