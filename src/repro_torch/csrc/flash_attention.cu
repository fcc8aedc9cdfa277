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
// 185 MB of q, k, v and out.
//
// Design, after FlashAttention-3's forward.  One block of three warpgroups
// per (batch, query head, 128-query tile); the grid puts the H heads of one
// (batch, tile) side by side, so they run together and share each K/V tile
// through L2, and the highest (longest) tiles first.  Warpgroup 0 is the
// producer: after setmaxnreg.dec one thread starts TMA loads of the Q tile
// and then of the K and V tiles of 64 keys into a two-stage ring, each
// stage with its own full and empty mbarrier for K and for V.  It walks
// only the key tiles that hold a live key for some row of the block (the
// TPU kernel's pl.when skip), so a window costs O(S * window).
// Warpgroups 1 and 2 (setmaxnreg.inc) each own 64 query rows: S = Q K^T by
// wgmma.m64n64k16 with Q and K in shared memory, scale and online softmax
// in registers, and O += P V by wgmma.m64n{HDP}k16 with P, rounded to
// bf16, as the register A operand and V read from shared memory as a
// transposed (MN-major) B operand; float32 accumulators.  Within a
// warpgroup the next tile's Q K^T goes out before this tile's P V, so the
// softmax of one runs while the tensor cores do the other.  A warpgroup
// skips the tiles that are dead for all of its rows (exact: such a tile
// adds weights of 0, or weights that a later alpha = 0 wipes) and masks
// only the tiles that the causal diagonal, the window edge or the end of
// the sequence cuts.  The output goes through shared memory (the Q tile's
// place) and out by TMA stores.
//
// What this does about the limits of the earlier mma.sync design: V's
// B operand was gathered two bytes at a time, and is now read by the
// tensor cores from shared memory (transpose bit); no copy was in flight
// while the tensor cores worked, and now the producer keeps the next K and
// V tiles in flight; mma.sync gave way to wgmma; a block held 6.4
// positions of G heads and re-read each K/V tile per block, and now 128
// positions of one head, with the heads that share a KV head adjacent in
// the grid.
//
// Layout: every tile arrives by TMA with the 128-byte swizzle, hd split in
// panels of 64 columns (128 B rows, the swizzle's widest box), so a tile of
// R rows is HDP / 64 panels of R x 128 B.  The wgmma descriptors match it:
// Q and K K-major (SBO 1024 B between 8-row groups; a 16-column k step
// advances 32 B within the panel), V MN-major (LBO = one panel between
// 64-column blocks of hd, SBO 1024 B between 8-key groups).  hd below the
// padded width HDP (64, 128 or 256) and rows past S arrive as zeros; the
// TMA store writes only columns below hd and rows below S.
//
// Numerics, as the mma.sync design and the TPU kernel have them: a masked
// score is the finite NEG_INF = -1e30, so a row whose keys in a tile are
// all masked gets weights exp(0) = 1 that its first live key wipes (alpha =
// exp(NEG_INF - m) = 0); a key at or past S, which the TPU kernel never
// has, gets -inf and weight 0; alpha = exp(m_prev - m_new); P is rounded to
// bf16 before P V while l sums the unrounded weights; out = O / max(l,
// 1e-20).  Exponentials are taken base 2 on scores scaled by
// scale * log2(e) (ex2.approx), which is the same function.
//
// The float32 and f16 route (flash_fwd_ffma, flash_attention_ffma_run): the
// same blocked online softmax, GQA, causal and window masks and skipping of
// dead key tiles, with the arithmetic in float32 on the CUDA cores (FFMA),
// so a float32 input keeps float32 precision (a cast to bf16 would lose
// it).  Templated on the load type: f16 converts to float32 exactly in
// registers, so there is no cast kernel.  One block of 8 warps per (batch,
// query head, 64-query tile), ordered as above; the Q tile and each tile of
// 32 keys and values are staged in shared memory as float32.  A warp owns 8
// query rows: lane j computes the 8 scores of key j (float4 reads; K rows
// padded by 4 floats so the lanes' rows fall in different banks), the
// softmax takes warp max and sum, and for O += P V lane l holds columns l,
// l + 32, ... of the 8 rows' accumulators and takes each weight by a
// shuffle.  Any hd up to 256.  The numerics follow the TPU kernel: m starts
// at the finite NEG_INF and masked scores are NEG_INF; keys past S get -inf;
// out = O / max(l, 1e-20) in q's type.  Bound: operations, the FFMA peak
// (67 TFLOP/s) for 4 * hd flop per live (query, key) pair.
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's type; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int BM = 128;         // query rows per block: two consumer warpgroups of 64
constexpr int BN = 64;          // keys per tile
constexpr int STAGES = 2;       // depth of the K and V rings
constexpr int PANEL = 64;       // bf16 columns per 128-byte swizzled panel
constexpr int ROW_BYTES = 128;  // one panel row
constexpr int THREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the swizzle repeats every
// 8 rows of 128 B): the Q tile (later the output tile), STAGES K tiles,
// STAGES V tiles, then the mbarriers.
template <int HDP>
struct Smem {
  static constexpr int PANELS = HDP / PANEL;
  static constexpr uint32_t Q_PANEL = BM * ROW_BYTES;
  static constexpr uint32_t KV_PANEL = BN * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  static constexpr uint32_t KV_BYTES = PANELS * KV_PANEL;  // one K or V tile
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr size_t bytes = BAR_OFF + 16 * 8 + 1024;  // barriers, alignment slack
};

// mbarriers: Q full, then per stage K full, V full, K empty, V empty.
constexpr int BAR_Q = 0;
constexpr int BAR_K_FULL = 1;
constexpr int BAR_V_FULL = BAR_K_FULL + STAGES;
constexpr int BAR_K_EMPTY = BAR_V_FULL + STAGES;
constexpr int BAR_V_EMPTY = BAR_K_EMPTY + STAGES;
constexpr int CONSUMER_WARPS = 8;  // each arrives once on an empty barrier

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

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: box (c0 column, c1 head, c2 row, c3 batch) of a (B, S, heads, hd)
// tensor into shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// Pins registers that a wgmma writes asynchronously: after a wait, no read
// of them may move above it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma ----------------------------------------------------------------- //

// d (+)= A B for m64n64k16: A (64 x 16) and B (64 x 16), both K-major
// in shared memory (descriptors); d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for m64n64k16: A (64 x 16) from registers (mma.sync's A
// fragment layout, warp w holding rows 16w..16w+15), B (16 x 64) MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for m64n128k16: A (64 x 16) from registers (mma.sync's A
// fragment layout, warp w holding rows 16w..16w+15), B (16 x 128) MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for m64n256k16: A (64 x 16) from registers (mma.sync's A
// fragment layout, warp w holding rows 16w..16w+15), B (16 x 256) MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// O += P V for one 16-key step: the output width HDP in one instruction.
template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HDP == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HDP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// ---- the kernel -------------------------------------------------------------- //

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                int B, int S, int H, int Hkv, int causal, int window, float scale_log2) {
  using L = Smem<HDP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same place, generic address
  const uint32_t sq = base, sk = base + L::K_OFF, sv = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [&](int i) -> uint32_t { return bars + 8u * i; };

  // Work unit: heads fastest, then batch, then query tiles from the last.
  const int nq = (S + BM - 1) / BM;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int b = idx % B;
  const int q0 = (nq - 1 - idx / B) * BM;
  const int hk = h / (H / Hkv);

  // Key tiles holding a live key for some row of the block.
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(q0 + BM - 1, S - 1) : S - 1;
  const int t_first = k_lo / BN;
  const int n_tiles = k_hi / BN - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar(BAR_Q), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(BAR_K_FULL + s), 1);
      mbar_init(bar(BAR_V_FULL + s), 1);
      mbar_init(bar(BAR_K_EMPTY + s), CONSUMER_WARPS);
      mbar_init(bar(BAR_V_EMPTY + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ---------------------------------------------------------- //
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(bar(BAR_Q), L::Q_BYTES);
      for (int p = 0; p < L::PANELS; ++p)
        for (int half = 0; half < 2; ++half)
          tma_load(sq + p * L::Q_PANEL + half * 64 * ROW_BYTES, &tm_q, bar(BAR_Q), p * PANEL,
                   h, q0 + 64 * half, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t par = ((j / STAGES) & 1) ^ 1;  // the first pass finds the stage free
        const int key = (t_first + j) * BN;
        mbar_wait(bar(BAR_K_EMPTY + s), par);
        mbar_expect_tx(bar(BAR_K_FULL + s), L::KV_BYTES);
        for (int p = 0; p < L::PANELS; ++p)
          tma_load(sk + s * L::KV_BYTES + p * L::KV_PANEL, &tm_k, bar(BAR_K_FULL + s),
                   p * PANEL, hk, key, b);
        mbar_wait(bar(BAR_V_EMPTY + s), par);
        mbar_expect_tx(bar(BAR_V_FULL + s), L::KV_BYTES);
        for (int p = 0; p < L::PANELS; ++p)
          tma_load(sv + s * L::KV_BYTES + p * L::KV_PANEL, &tm_v, bar(BAR_V_FULL + s),
                   p * PANEL, hk, key, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows q0 + 64 c .. q0 + 64 c + 63 -------- //
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // The warpgroup and warp from a shuffle, so the compiler sees them
  // uniform across the warp (wgmma in a path it thinks divergent is
  // serialized).
  const int c = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0) - 1;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0) % 4;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r_lo = q0 + 64 * c;
  const int r_hi = min(r_lo + 63, S - 1);
  const int pos0 = r_lo + 16 * warp + g;  // this thread's rows: pos0 and pos0 + 8

  // This warpgroup's live tiles, i_lo..i_hi of the block's 0..n_tiles-1
  // (none when all its rows lie past S).
  int i_lo = n_tiles, i_hi = -1;
  if (r_lo < S) {
    const int lo_key = window > 0 ? max(0, r_lo - window + 1) : 0;
    i_lo = lo_key / BN - t_first;
    i_hi = (causal ? r_hi : S - 1) / BN - t_first;
  }

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
  float sc[BN / 2];            // this thread's scores of the 64 x 64 tile, then weights
  uint32_t pa[BN / 16][4];     // the weights in bf16, as A fragments of P V
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.0f, 0.0f};  // partial: this thread's columns only
  const uint32_t q_rows = sq + c * 64 * ROW_BYTES;

  auto start_qk = [&](int s) {
    const uint32_t kb = sk + s * L::KV_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns of the 128-byte row
      wgmma_ss_n64(sc, sw128_desc(q_rows + (kk / 4) * L::Q_PANEL + off, 16, 1024),
                   sw128_desc(kb + (kk / 4) * L::KV_PANEL + off, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  auto start_pv = [&](int s) {
    const uint32_t vb = sv + s * L::KV_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_pv<HDP>(o, pa[kk], sw128_desc(vb + kk * 16 * ROW_BYTES, L::KV_PANEL, 1024));
    wg_commit();
  };

  auto release = [&](int base_bar, int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(base_bar + i % STAGES));
  };
  auto wait_full = [&](int base_bar, int i) {
    mbar_wait(bar(base_bar + i % STAGES), (i / STAGES) & 1);
  };
  // A dead tile: K and V released unread, each after it lands, so the empty
  // barriers' phases stay in order.
  auto skip = [&](int i) {
    wait_full(BAR_K_FULL, i);
    release(BAR_K_EMPTY, i);
    wait_full(BAR_V_FULL, i);
    release(BAR_V_EMPTY, i);
  };
  // Scores of tile i (in sc) to weights: scale, mask a tile that the
  // diagonal, the window edge or the end of the sequence cuts, and update
  // the running max and sum; returns each row's alpha in `alpha`.
  auto softmax = [&](int i, float (&alpha)[2]) {
    const int kt = (t_first + i) * BN;
    const bool cut = (causal && kt + BN - 1 > r_lo) || (window > 0 && r_hi - kt >= window) ||
                     kt + BN > S;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sc[e] *= scale_log2;
    if (cut) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int key = kt + 8 * (e / 4) + 2 * tq + (e & 1);
        const int pos = pos0 + 8 * ((e / 2) & 1);
        if (key >= S) sc[e] = -CUDART_INF_F;
        else if ((causal && key > pos) || (window > 0 && pos - key >= window)) sc[e] = NEG_INF;
      }
    }
    float m_cur[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) m_cur[(e / 2) & 1] = fmaxf(m_cur[(e / 2) & 1], sc[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      const float m_new = fmaxf(m_run[r], m_cur[r]);
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float l_cur[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int r = (e / 2) & 1;
      sc[e] = ex2(sc[e] - m_run[r]);
      l_cur[r] += sc[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + l_cur[r];
  };
  // The weights, rounded to bf16, as the A fragments of P V.
  auto to_pa = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  mbar_wait(bar(BAR_Q), 0);
  for (int i = 0; i < min(i_lo, n_tiles); ++i) skip(i);
  if (i_lo <= i_hi) {
    // The first live tile: scores, weights; O is still 0.
    float alpha[2];
    wait_full(BAR_K_FULL, i_lo);
    start_qk(i_lo % STAGES);
    wg_wait<0>();
    pin(sc);
    release(BAR_K_EMPTY, i_lo);
    softmax(i_lo, alpha);
    to_pa();
    // Then each tile's Q K^T goes out before the last tile's P V, and its
    // softmax runs while that P V is on the tensor cores.
    for (int i = i_lo + 1; i <= i_hi; ++i) {
      wait_full(BAR_K_FULL, i);
      start_qk(i % STAGES);
      wait_full(BAR_V_FULL, i - 1);
      start_pv((i - 1) % STAGES);
      wg_wait<1>();  // Q K^T is done; P V may still run
      pin(sc);
      release(BAR_K_EMPTY, i);
      softmax(i, alpha);
      wg_wait<0>();
      pin(o);
      release(BAR_V_EMPTY, i - 1);
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      to_pa();
    }
    wait_full(BAR_V_FULL, i_hi);
    start_pv(i_hi % STAGES);
    wg_wait<0>();
    pin(o);
    release(BAR_V_EMPTY, i_hi);
  }
  for (int i = max(i_hi + 1, i_lo); i < n_tiles; ++i) skip(i);

  // ---- epilogue: O / l in bf16 into this warpgroup's Q rows, then TMA ------ //
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-20f);
  }
  unsigned char* rows = gbase + c * 64 * ROW_BYTES;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;  // row % 8 == g
      const uint32_t off = (j / 8) * L::Q_PANEL + row * ROW_BYTES + (((j % 8) ^ g) << 4) + 4 * tq;
      *reinterpret_cast<__nv_bfloat162*>(rows + off) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / l_run[r], o[4 * j + 2 * r + 1] / l_run[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
  if (tid == 0 && r_lo < S) {
    for (int p = 0; p < L::PANELS; ++p)
      tma_store(&tm_o, q_rows + p * L::Q_PANEL, p * PANEL, h, r_lo, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- host ---------------------------------------------------------------------- //

typedef decltype(&cuTensorMapEncodeTiled) EncodeFn;

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library does not link libcuda).  0 on success, else a CUDA runtime error code.
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

// The tensor map of a contiguous (B, S, heads, hd) bf16 tensor: 4-D, hd
// innermost, boxes of 64 columns x 1 head x 64 rows x 1 batch, 128-byte
// swizzle, zeros outside the tensor.
int make_map(EncodeFn encode, CUtensorMap* map, const void* ptr, int hd, int heads, int S,
             int B) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {PANEL, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED - static_cast<int>(r);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int Hkv,
           int hd, int causal, int window, float scale, cudaStream_t stream) {
  static_assert(BN == 64, "K/V boxes share the 64-row box of Q and O");
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<HDP>::bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  EncodeFn encode;
  int err = encoder(&encode);
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mo;
  if ((err = make_map(encode, &mq, q, hd, H, S, B)) != 0) return err;
  if ((err = make_map(encode, &mk, k, hd, Hkv, S, B)) != 0) return err;
  if ((err = make_map(encode, &mv, v, hd, Hkv, S, B)) != 0) return err;
  if ((err = make_map(encode, &mo, o, hd, H, S, B)) != 0) return err;
  const long long blocks = static_cast<long long>((S + BM - 1) / BM) * B * H;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_fwd_wgmma<HDP><<<static_cast<unsigned>(blocks), THREADS, Smem<HDP>::bytes, stream>>>(
      mq, mk, mv, mo, B, S, H, Hkv, causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// ---- the float32 / f16 route: FFMA on the CUDA cores -------------------- //
constexpr int FQ = 64;          // query rows per block
constexpr int FN = 32;          // keys per tile: a lane each
constexpr int FR = 8;           // query rows per warp
constexpr int F_THREADS = 256;  // 8 warps

__device__ __forceinline__ float load_f(float x) { return x; }
__device__ __forceinline__ float load_f(__half x) { return __half2float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__half* p, float x) { *p = __float2half_rn(x); }

__device__ __forceinline__ float warp_max_f(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum_f(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one block: the Q tile, a K tile (rows padded by 4) and a
// V tile, float32.
__host__ __device__ __forceinline__ int ffma_row(int hd) { return (hd + 3) & ~3; }
__host__ __device__ __forceinline__ size_t ffma_smem(int hd) {
  return static_cast<size_t>(FQ * ffma_row(hd) + FN * (ffma_row(hd) + 4) + FN * ffma_row(hd)) *
         sizeof(float);
}

// NT = ceil(hd / 32): lane l holds columns l + 32 t, t < NT, of its rows.
template <typename T, int NT>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_fwd_ffma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, int B, int S, int H, int Hkv, int hd, int causal, int window,
               float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int hd4 = ffma_row(hd), ks = hd4 + 4;
  float* sq = fsm;
  float* sk = sq + FQ * hd4;
  float* sv = sk + FN * ks;
  const int nq = (S + FQ - 1) / FQ;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int b = idx % B;
  const int q0 = (nq - 1 - idx / B) * FQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < FQ * hd4; i += F_THREADS) {
    const int r = i / hd4, d = i % hd4, row = q0 + r;
    sq[i] = row < S && d < hd
                ? load_f(q[((static_cast<long long>(b) * S + row) * H + h) * hd + d])
                : 0.f;
  }
  // Key tiles holding a live key for some row of the block.
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(q0 + FQ - 1, S - 1) : S - 1;
  const int r_lo = q0 + warp * FR, r_hi = min(r_lo + FR - 1, S - 1);
  float m[FR], l[FR], acc[FR][NT];
#pragma unroll
  for (int r = 0; r < FR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }
  for (int kt = k_lo / FN * FN; kt <= k_hi; kt += FN) {
    __syncthreads();  // the last tile is read (and the Q tile staged)
    for (int i = tid; i < FN * hd4; i += F_THREADS) {
      const int j = i / hd4, d = i % hd4, key = kt + j;
      const bool in = key < S && d < hd;
      const long long g = ((static_cast<long long>(b) * S + key) * Hkv + hk) * hd + d;
      sk[j * ks + d] = in ? load_f(k[g]) : 0.f;
      sv[j * hd4 + d] = in ? load_f(v[g]) : 0.f;
    }
    __syncthreads();
    // A tile dead for every row of the warp adds nothing that survives.
    if (r_lo >= S || (causal && kt > r_hi) || (window > 0 && kt + FN - 1 <= r_lo - window))
      continue;
    float s[FR];
#pragma unroll
    for (int r = 0; r < FR; ++r) s[r] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(sk + lane * ks);
    const float4* qr = reinterpret_cast<const float4*>(sq + warp * FR * hd4);
    for (int d4 = 0; d4 < hd4 / 4; ++d4) {
      const float4 kv = kr[d4];
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        const float4 qv = qr[r * (hd4 / 4) + d4];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const int key = kt + lane;
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      const int row = r_lo + r;
      float x = s[r] * scale;
      if (key >= S)
        x = -CUDART_INF_F;
      else if ((causal && key > row) || (window > 0 && row - key >= window))
        x = NEG_INF;
      const float mn = fmaxf(m[r], warp_max_f(x));
      const float p = expf(x - mn);
      const float alpha = expf(m[r] - mn);
      l[r] = alpha * l[r] + warp_sum_f(p);
      m[r] = mn;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= alpha;
      s[r] = p;
    }
    for (int j = 0; j < FN; ++j) {
      const float* vr = sv + j * hd4;
      float vv[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int d = lane + 32 * t;
        vv[t] = d < hd4 ? vr[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[r][t] = fmaf(pj, vv[t], acc[r][t]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FR; ++r) {
    const int row = r_lo + r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-20f);
    T* out = o + ((static_cast<long long>(b) * S + row) * H + h) * hd;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) store_f(out + d, acc[r][t] / den);
    }
  }
}

template <typename T, int NT>
int launch_ffma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int Hkv, int hd, int causal, int window, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_ffma<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ffma_smem(32 * NT)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long blocks = static_cast<long long>((S + FQ - 1) / FQ) * B * H;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_fwd_ffma<T, NT><<<static_cast<unsigned>(blocks), F_THREADS, ffma_smem(hd), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), B, S, H, Hkv, hd, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_ffma(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int Hkv,
             int hd, int causal, int window, float scale, cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch_ffma<T, 1>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
    case 2: return launch_ffma<T, 2>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
    case 3: return launch_ffma<T, 3>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
    case 4: return launch_ffma<T, 4>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
    case 5: return launch_ffma<T, 5>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
    case 6: return launch_ffma<T, 6>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
    case 7: return launch_ffma<T, 7>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
    default: return launch_ffma<T, 8>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
  }
}

}  // namespace

// The float32 / f16 route: q, o contiguous (B, S, H, hd), k, v contiguous
// (B, S, Hkv, hd), all float32 (half == 0) or all f16 (half != 0); H a
// multiple of Hkv; 1 <= hd <= 256; causal, window and scale as below.  One
// launch of flash_fwd_ffma on `stream`; returns a CUDA runtime error code.
extern "C" int flash_attention_ffma_run(const void* q, const void* k, const void* v, void* o,
                                        int B, int S, int H, int Hkv, int hd, int causal,
                                        int window, float scale, int half, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (half) return run_ffma<__half>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
  return run_ffma<float>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
}

// q, o: contiguous (B, S, H, hd) bf16; k, v: contiguous (B, S, Hkv, hd)
// bf16, 16-byte aligned; H a multiple of Hkv; hd a multiple of 8, at most
// 256.  causal: 0 or 1; window: the
// sliding window, or 0 for none; scale: the score scale (1 / sqrt(hd)).
// One launch on `stream`; returns 0 on success, a CUDA runtime error code
// (cudaErrorInvalidConfiguration when B * H * ceil(S / 128) reaches 2^31),
// or a negative code when a tensor map is refused.
extern "C" int flash_attention_run(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int Hkv, int hd, int causal,
                                   int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch<64>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
  if (hd <= 128) return launch<128>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
  return launch<256>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  static char buf[96];
  if (code <= ENCODE_FAILED) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             ENCODE_FAILED - code);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
