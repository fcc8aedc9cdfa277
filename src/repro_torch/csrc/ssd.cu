// The Mamba2 SSD scan (state-space duality) on Hopper:
//   h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,   h_0 = 0,
// with x (B, L, H, P), dt (B, L, H) float32, A (H,) float32, B and C
// (B, L, N) shared by all heads; returns y (B, L, H, P) in x's type and
// the final state (B, H, P, N) float32.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd_pallas.
//
// Bound: bytes at mamba2-780m's prefill shape (B 4, L 4096, H 48, P 64,
// N 128, bf16): x and y 101 MB each, B and C 8 MB together, dt 3 MB, the
// final state 6 MB; 219 MB, about 0.065 ms at 3.35 TB/s.  The chunked
// algorithm at chunk 256 needs about 3.9e10 flop, 0.04 ms on the bf16
// tensor cores.  A chunk-parallel design also writes and reads the chunk
// states, 101 MB per pass at this shape, so its own floor is about 0.19 ms.
//
// Design: the plain version's four phases (kernels/ssd/ref.py), each
// parallel across chunks of Q = 256 steps, in three launches on one stream:
//  1. ssd_chunk_state, one block of 8 warps per (batch, chunk, group of
//     HG1 heads), two blocks an SM: dA's cumsum over the chunk is a team
//     scan (shuffles, not one thread), and S_c = (w x)^T B with
//     w = exp(cum_T - cum) dt goes through the tensor cores; S_c (float32)
//     and cum_T go to scratch.  B's chunk is staged once for the group.
//  2. ssd_state_pass: an elementwise float32 scan over the chunks, one
//     thread per 4 state values of a (batch, head): h_in[c] = h, then
//     h = exp(cum_T) h + S_c; h_in goes out split into bf16 hi and lo
//     planes for phase 3's products, and the last h is hT.
//  3. ssd_chunk_out, one block of 16 warps (12 on float32 inputs) per
//     (batch, chunk, 64-step row tile, group of HG3 heads), the row tiles
//     of a group side by side:
//     G = C B^T for the tile's causal part is formed ONCE for the block
//     (all its heads share B and C) and kept in shared memory; then teams
//     of 4 warps take the heads.  For the key tiles below the row tile L
//     factors into a row part and a column part, so y there is
//     r_t (exp(cum_e) C h_in^T + (G * w) x) (see K3); only the diagonal tile
//     forms L[t, s] = exp(cum_t - cum_s) element by element, masked before
//     the exp, so strong decays underflow to 0, never NaN.  y is rounded
//     once to x's type.  The next x tile, and the next head's h_in, are
//     staged by cp.async while the current one computes.
// Every product is mma.sync.m16n8k16 with bf16 operands and float32 sums.
// An operand that is exact in bf16 (B, C, and x on bf16 inputs) goes in as
// it is; a float32 operand (w x, h_in, G * w, G * L * dt, and x, B, C on
// float32 inputs) is split into bf16 hi + lo and both parts go in: two
// products where the other side is exact, three where neither is (lo * lo
// is dropped).  One bf16 rounding of a float32 operand would miss the
// reference's 3e-4 bar by an order of magnitude (tests/test_torch_ssd.py
// emulates both).  The cumsum is carried as a float pair from a float64
// sum (chunk_cumsum), as the plain version takes it in float64.  Steps
// past L take dt = 0 and zero x, B, C (cp.async's zero fill); their y is
// not stored.
//
// Any other (P, N) takes the SIMT route (ssd_run_simt): the same three
// launches in float32 on the CUDA cores, one block of Q threads per
// (chunk, head, batch).  ssd_chunk_state_simt takes dA's cumsum in float64
// (a Hillis-Steele scan), w = exp(cum_T - cum) dt, and S_c = (w x)^T B with
// a thread per state value; ssd_state_pass_simt is the float32 scan over
// chunks (h_in[c] = h; h = exp(cum_T) h + S_c); ssd_chunk_out_simt forms M
// = (C B^T) * L * dt for 16 rows of the chunk at a time in shared memory,
// masked before the exp, then y = M x + exp(cum_t) C h_in^T with a thread
// per (row, p).  Inputs are float32 (the entry casts f16); y is float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int P = 64, N = 128;   // head dim, state dim
constexpr int Q = 256;           // steps per chunk
constexpr int TR = 64;           // steps per row tile of ssd_chunk_out
constexpr int RT = Q / TR;       // row tiles per chunk
constexpr int TEAM = 128;        // threads of a team (4 warps)
constexpr int HG1 = 6;           // heads per ssd_chunk_state block
constexpr int HG3 = 16;          // heads per ssd_chunk_out block
constexpr int K1_THREADS = 256;

template <typename T>
constexpr bool kExact = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// ---- fragments and products ---------------------------------------------- //

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (a, b) as bf16 hi parts and bf16 residuals: a = hi + lo to about 2^-17 |a|.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const bf16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
  hi = pack2(ah, bh);
  lo = pack2(__float2bfloat16_rn(a - __bfloat162float(ah)),
             __float2bfloat16_rn(b - __bfloat162float(bh)));
}

// d += a * b for one 16x8x16 tile (row-major A, column-major B).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A (16 x 16) and B (16 x 8, two n-tiles) fragments; lo is set only for
// an operand that is not exact in bf16.
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2][2], lo[2][2]; };

// d += a * b in hi/lo parts: the small cross terms first.
template <bool AX, bool BX>
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a, const FragB& b,
                                          int t) {
  if (!AX) mma(d, a.lo, b.hi[t]);
  if (!BX) mma(d, a.hi, b.lo[t]);
  mma(d, a.hi, b.hi[t]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// A[m][k] at s[m * LD + k], rows m0.., columns k0...
template <int LD>
__device__ __forceinline__ void load_a(FragA& f, const bf16* s, int m0, int k0, int lane) {
  ldsm_x4(f.hi, s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + k0 + (lane >> 4) * 8);
}
template <int LD>
__device__ __forceinline__ void load_a(FragA& f, const float* s, int m0, int k0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = *reinterpret_cast<const float2*>(
        s + (m0 + g + 8 * (i & 1)) * LD + k0 + 2 * tq + 8 * (i >> 1));
    split2(v.x, v.y, f.hi[i], f.lo[i]);
  }
}

// B[k][n] = s[n * LD + k] (k contiguous), n-tiles n0 and n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_nk(FragB& f, const bf16* s, int n0, int k0, int lane) {
  uint32_t r[4];
  ldsm_x4(r, s + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8);
  f.hi[0][0] = r[0]; f.hi[0][1] = r[1]; f.hi[1][0] = r[2]; f.hi[1][1] = r[3];
}
template <int LD>
__device__ __forceinline__ void load_b_nk(FragB& f, const float* s, int n0, int k0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(
          s + (n0 + 8 * t + g) * LD + k0 + 2 * tq + 8 * i);
      split2(v.x, v.y, f.hi[t][i], f.lo[t][i]);
    }
}

// B[k][n] = s[k * LD + n] (n contiguous), n-tiles n0 and n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_kn(FragB& f, const bf16* s, int k0, int n0, int lane) {
  uint32_t r[4];
  ldsm_x4_t(r, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8);
  f.hi[0][0] = r[0]; f.hi[0][1] = r[1]; f.hi[1][0] = r[2]; f.hi[1][1] = r[3];
}
template <int LD>
__device__ __forceinline__ void load_b_kn(FragB& f, const float* s, int k0, int n0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = s + (k0 + 2 * tq + 8 * i) * LD + n0 + 8 * t + g;
      split2(p[0], p[LD], f.hi[t][i], f.lo[t][i]);
    }
}

// A[m][k] = w[k] * s[k * LD + m] (m contiguous), always split.
template <int LD, typename T>
__device__ __forceinline__ void load_a_scaled(FragA& f, const T* s, const float* w, int m0,
                                              int k0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + g + 8 * (i & 1), k = k0 + 2 * tq + 8 * (i >> 1);
    split2(w[k] * to_f(s[k * LD + m]), w[k + 1] * to_f(s[(k + 1) * LD + m]), f.hi[i],
           f.lo[i]);
  }
}

// ---- copies and team helpers ----------------------------------------------- //

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Named barrier of one team (ids 1, 2, ...; 0 is __syncthreads).
__device__ __forceinline__ void team_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(TEAM) : "memory");
}

// Stage `rows` rows of WIDTH elements into dst (row stride LD) by cp.async;
// row i comes from src_row(i), or is zero where that is null.
template <typename T, int WIDTH, int LD, int NT, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int tid, const T* any,
                                           RowFn src_row) {
  constexpr int PER = 16 / sizeof(T), CH = WIDTH / PER;
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * PER;
    const T* src = src_row(r);
    cp_async16(dst + r * LD + c, src ? src + c : any, src != nullptr);
  }
}

// cum[s] = sum_{u <= s} dts[u] * a over the chunk, as a float pair
// (chi + clo, from a float64 sum), by the 128 threads of one team (tid
// 0..127, barrier `bar`): two steps a thread, a shuffle scan across the
// warp, then the warps' totals.  The pair keeps a segment sum
// cum_t - cum_s = (chi_t - chi_s) + (clo_t - clo_s) accurate to its own
// size where cum reaches -1e4 (strong decays): a float32 cumsum would
// lose ~1e-3 of it to cancellation.  The caller synchronises after.
__device__ __forceinline__ void chunk_cumsum(float* chi, float* clo, const float* dts, float a,
                                             double* wsum, int tid, int bar) {
  const int lane = tid & 31, w = tid >> 5;
  const double v0 = static_cast<double>(dts[2 * tid] * a);
  const double v1 = v0 + static_cast<double>(dts[2 * tid + 1] * a);
  double s = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += t;
  }
  double ex = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) ex = 0.0;
  if (lane == 31) wsum[w] = s;
  team_sync(bar);
  for (int i = 0; i < w; ++i) ex += wsum[i];
  const double c0 = ex + v0, c1 = ex + v1;
  chi[2 * tid] = static_cast<float>(c0);
  clo[2 * tid] = static_cast<float>(c0 - static_cast<float>(c0));
  chi[2 * tid + 1] = static_cast<float>(c1);
  clo[2 * tid + 1] = static_cast<float>(c1 - static_cast<float>(c1));
}

// 2^x by the SFU (ex2.approx: relative error below 2^-22; results below
// 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
constexpr float LOG2E = 1.4426950408889634f;

// cum_t - cum_s from the float pairs.
__device__ __forceinline__ float seg(float thi, float tlo, float shi, float slo) {
  return (thi - shi) + (tlo - slo);
}

// ---- 1. chunk states ------------------------------------------------------- //

template <typename T>
struct K1 {
  static constexpr int LDB = kExact<T> ? N + 8 : N + 4;   // B[s][n]
  static constexpr int LDX = kExact<T> ? P + 8 : P + 4;   // x[s][p]
  static constexpr size_t B_BYTES = sizeof(T) * Q * LDB;
  static constexpr size_t X_BYTES = sizeof(T) * Q * LDX;
  // ws, dts, chi, clo; 4 warp totals
  static constexpr size_t bytes = B_BYTES + X_BYTES + sizeof(float) * 4 * Q + sizeof(double) * 4;
};

template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                float* __restrict__ S, float* __restrict__ tot, int L, int H, int nc) {
  using K = K1<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Bs = reinterpret_cast<T*>(smem_raw);
  T* Xs = reinterpret_cast<T*>(smem_raw + K::B_BYTES);
  float* ws = reinterpret_cast<float*>(smem_raw + K::B_BYTES + K::X_BYTES);
  float* dts = ws + Q;
  float* chi = dts + Q;
  float* clo = chi + Q;
  double* wsum = reinterpret_cast<double*>(clo + Q);

  const int c = blockIdx.x, b = blockIdx.z;
  const int h_lo = blockIdx.y * HG1, h_hi = min(H, h_lo + HG1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long l0 = static_cast<long long>(b) * L + static_cast<long long>(c) * Q;
  const int rows = min(Q, L - c * Q);
  const int ksteps = (rows + 15) / 16;

  stage_rows<T, N, K::LDB, K1_THREADS>(Bs, Q, tid, Bm, [&](int r) -> const T* {
    return r < rows ? Bm + (l0 + r) * N : nullptr;
  });
  auto stage_x = [&](int h) {
    stage_rows<T, P, K::LDX, K1_THREADS>(Xs, Q, tid, x, [&](int r) -> const T* {
      return r < rows ? x + ((l0 + r) * H + h) * P : nullptr;
    });
  };
  stage_x(h_lo);
  cp_commit();
  auto load_dt = [&](int h) { return tid < rows ? dt[(l0 + tid) * H + h] : 0.0f; };
  float dnext = load_dt(h_lo);

  const int mt = warp & 3, nb = (warp >> 2) * 64;  // this warp's 16 x 64 of S
  for (int h = h_lo; h < h_hi; ++h) {
    dts[tid] = dnext;
    if (h + 1 < h_hi) dnext = load_dt(h + 1);
    __syncthreads();
    if (warp < 4) chunk_cumsum(chi, clo, dts, A[h], wsum, tid, 1);
    __syncthreads();
    const float thi = chi[Q - 1], tlo = clo[Q - 1];
    ws[tid] = expf(seg(thi, tlo, chi[tid], clo[tid])) * dts[tid];
    if (tid == 0) tot[(static_cast<long long>(b) * nc + c) * H + h] = thi + tlo;
    cp_wait<0>();
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    for (int ks = 0; ks < ksteps; ++ks) {
      FragA a;
      load_a_scaled<K::LDX>(a, Xs, ws, 16 * mt, 16 * ks, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        FragB fb;
        load_b_kn<K::LDB>(fb, Bs, 16 * ks, nb + 16 * np, lane);
        mma_split<false, kExact<T>>(acc[2 * np], a, fb, 0);
        mma_split<false, kExact<T>>(acc[2 * np + 1], a, fb, 1);
      }
    }
    float* dst = S + ((static_cast<long long>(b) * nc + c) * H + h) * (P * N);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = nb + 8 * n + 2 * tq, p0 = 16 * mt + g;
      store2(dst + p0 * N + col, acc[n][0], acc[n][1]);
      store2(dst + (p0 + 8) * N + col, acc[n][2], acc[n][3]);
    }
    __syncthreads();  // x, ws, chi and clo are free again
    if (h + 1 < h_hi) {
      stage_x(h + 1);
      cp_commit();
    }
  }
}

// ---- 2. states entering each chunk ----------------------------------------- //

// One thread per 4 state values of a (batch, head): h_in[c] = h, then
// h = exp(cum_T) h + S_c, in float32 and in the plain version's order.
// h_in goes out as bf16 hi and lo planes, (B, nc, H, 2, P, N): the split
// that ssd_chunk_out's products need, made once per value.
__global__ void __launch_bounds__(256)
ssd_state_pass(const float* __restrict__ S, const float* __restrict__ tot,
               bf16* __restrict__ hin, float* __restrict__ h_last, int nc, int H,
               long long BH) {
  constexpr int V = P * N / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= BH * V) return;
  const long long bh = i / V;
  const int e = static_cast<int>(i % V);
  const long long b = bh / H, h = bh % H;
  const long long step = static_cast<long long>(H) * V;       // one chunk on
  const float4* s = reinterpret_cast<const float4*>(S) + (b * nc * H + h) * V + e;
  uint2* out = reinterpret_cast<uint2*>(hin) + (b * nc * H + h) * 2 * V + e;
  const float* t = tot + b * nc * H + h;
  float4 cur = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 nxt = s[0];
  float tn = t[0];
  for (int c = 0; c < nc; ++c) {
    const float4 sc = nxt;
    const float d = expf(tn);
    if (c + 1 < nc) {
      nxt = s[(c + 1) * step];
      tn = t[static_cast<long long>(c + 1) * H];
    }
    uint2 hi, lo;
    split2(cur.x, cur.y, hi.x, lo.x);
    split2(cur.z, cur.w, hi.y, lo.y);
    out[2 * c * step] = hi;
    out[2 * c * step + V] = lo;
    cur.x = __fadd_rn(__fmul_rn(cur.x, d), sc.x);
    cur.y = __fadd_rn(__fmul_rn(cur.y, d), sc.y);
    cur.z = __fadd_rn(__fmul_rn(cur.z, d), sc.z);
    cur.w = __fadd_rn(__fmul_rn(cur.w, d), sc.w);
  }
  reinterpret_cast<float4*>(h_last)[bh * V + e] = cur;
}

// ---- 3. chunk outputs ------------------------------------------------------ //

// With e = t0 - 1 the step before the row tile (cum_e = 0 at t0 = 0), the
// tile's rows t and any earlier step s < t0 have
//   L[t, s] = exp(cum_t - cum_s) = r_t c_s,  r_t = exp(cum_t - cum_e),
//   c_s = exp(cum_e - cum_s),  both in (0, 1] (dt >= 0, A <= 0),
// so the key tiles before the row tile give r_t ((G * w) x) with w = c dt
// folded into G's columns (G is shared by the heads; x goes in as it is),
// and Y2 = exp(cum_t) C h_in^T joins them as r_t (exp(cum_e) C h_in^T).
// Only the diagonal key tile forms L[t, s] element by element (masked
// before the exp).  A team's h_in comes in two halves of N through a
// buffer that then takes every other x tile, which keeps a team at 31 KB
// of shared memory, so 4 teams (16 warps) share one G.
template <typename T>
struct K3 {
  static constexpr int TEAMS = kExact<T> ? 4 : 3;
  static constexpr int THREADS = TEAMS * TEAM;
  static constexpr int LDC = N + 8;                       // C[t][n], B[s][n]
  static constexpr int LDX = kExact<T> ? P + 8 : P + 4;   // x[s][p]
  static constexpr int LDH = P + 8;                       // h_in half planes [p][n], bf16
  static constexpr int LDG = Q + 8;                       // G[t][s], float32
  static constexpr size_t C_BYTES = sizeof(T) * TR * LDC;
  static constexpr size_t G_BYTES = sizeof(float) * TR * LDG;
  static constexpr size_t X_BYTES = sizeof(T) * TR * LDX;
  static constexpr size_t H_BYTES = sizeof(bf16) * 2 * P * LDH;
  // an x tile; half of the h_in planes or an x tile; dts (w below the
  // tile), chi, clo; 4 warp totals
  static constexpr size_t TEAM_BYTES =
      X_BYTES + H_BYTES + sizeof(float) * 3 * Q + sizeof(double) * 4;
  static constexpr size_t bytes = C_BYTES + G_BYTES + TEAMS * TEAM_BYTES;
  static_assert(X_BYTES <= H_BYTES, "an x tile fits the h_in buffer");
  static_assert(TEAM_BYTES % 16 == 0, "team areas stay 16-byte aligned");
  // G's B tiles go in the team areas: all at once where they fit, else
  // two at a time.
  static constexpr size_t B_TILE = sizeof(T) * TR * LDC;
  static constexpr int B_BUFS = RT * B_TILE <= TEAMS * TEAM_BYTES ? RT : 2;
  static_assert(2 * B_TILE <= TEAMS * TEAM_BYTES, "B tiles fit the team areas");
};

template <typename T>
__global__ void __launch_bounds__(K3<T>::THREADS)
ssd_chunk_out(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const bf16* __restrict__ hin, T* __restrict__ y,
              int L, int H, int nc, int groups) {
  using K = K3<T>;
  constexpr bool EX = kExact<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);
  float* Gs = reinterpret_cast<float*>(smem_raw + K::C_BYTES);
  unsigned char* teams = smem_raw + K::C_BYTES + K::G_BYTES;

  // The row tiles of one (batch, chunk, group) are neighbours, heaviest
  // first, so they run together and share h_in and x through L2.
  int idx = blockIdx.x;
  const int r = RT - 1 - idx % RT;
  idx /= RT;
  const int grp = idx % groups;
  idx /= groups;
  const int c = idx % nc, b = idx / nc;
  const int rows = min(Q, L - c * Q), t0 = r * TR;
  if (t0 >= rows) return;
  const long long l0 = static_cast<long long>(b) * L + static_cast<long long>(c) * Q;
  const int h_lo = grp * HG3, h_hi = min(H, h_lo + HG3);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  // ---- G = C B^T for rows t0..t0+63, columns 0..t0+63, once ---------------- //
  {
    T* Bt = reinterpret_cast<T*>(teams);
    stage_rows<T, N, K::LDC, K::THREADS>(Cs, TR, tid, Cm, [&](int i) -> const T* {
      return t0 + i < rows ? Cm + (l0 + t0 + i) * N : nullptr;
    });
    auto stage_b = [&](int j) {
      stage_rows<T, N, K::LDC, K::THREADS>(Bt + (j % K::B_BUFS) * TR * K::LDC, TR, tid, Bm,
                                           [&](int i) -> const T* {
        return TR * j + i < rows ? Bm + (l0 + TR * j + i) * N : nullptr;
      });
    };
    stage_b(0);
    if (K::B_BUFS == RT)
      for (int j = 1; j <= r; ++j) stage_b(j);
    cp_commit();
    for (int j = 0; j <= r; ++j) {
      if (K::B_BUFS != RT && j < r) stage_b(j + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const T* bt = Bt + (j % K::B_BUFS) * TR * K::LDC;
      for (int item = warp; item < 8; item += K::THREADS / 32) {
        const int rg = item & 3, half = item >> 2;
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll 2
        for (int k0 = 0; k0 < N; k0 += 16) {
          FragA a;
          load_a<K::LDC>(a, Cs, 16 * rg, k0, lane);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            FragB fb;
            load_b_nk<K::LDC>(fb, bt, 32 * half + 16 * np, k0, lane);
            mma_split<EX, EX>(acc[2 * np], a, fb, 0);
            mma_split<EX, EX>(acc[2 * np + 1], a, fb, 1);
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float* dst = Gs + (16 * rg + g) * K::LDG + TR * j + 32 * half + 8 * n + 2 * tq;
          store2(dst, acc[n][0], acc[n][1]);
          store2(dst + 8 * K::LDG, acc[n][2], acc[n][3]);
        }
      }
      __syncthreads();  // B tile j is free; at the end, G and C are complete
    }
  }

  // ---- per head ------------------------------------------------------------ //
  const int team = warp >> 2, wq = warp & 3, ttid = tid & (TEAM - 1), bar = 1 + team;
  unsigned char* area = teams + team * K::TEAM_BYTES;
  T* Xa = reinterpret_cast<T*>(area);
  unsigned char* hb = area + K::X_BYTES;  // h_in half planes, or an odd x tile
  bf16* Hh = reinterpret_cast<bf16*>(hb);
  float* dts = reinterpret_cast<float*>(area + K::X_BYTES + K::H_BYTES);
  float* chi = dts + Q;
  float* clo = chi + Q;
  double* wsum = reinterpret_cast<double*>(clo + Q);
  // x tile j lives in Xa for even j, in the h_in buffer for odd j.
  auto xbuf = [&](int j) -> T* { return (j & 1) ? reinterpret_cast<T*>(hb) : Xa; };

  // Columns [64 half, 64 half + 64) of h_in's hi and lo planes (rows p).
  auto stage_h = [&](int h, int half) {
    const bf16* src = hin + ((static_cast<long long>(b) * nc + c) * H + h) * (2 * P * N)
                      + P * half;
    stage_rows<bf16, P, K::LDH, TEAM>(Hh, 2 * P, ttid, hin, [&](int i) -> const bf16* {
      return src + i * N;
    });
  };
  auto stage_x = [&](int h, int j) {
    stage_rows<T, P, K::LDX, TEAM>(xbuf(j), TR, ttid, x, [&](int i) -> const T* {
      return TR * j + i < rows ? x + ((l0 + TR * j + i) * H + h) * P : nullptr;
    });
  };
  auto load_dt = [&](int h, int s) { return s < rows ? dt[(l0 + s) * H + h] : 0.0f; };

  const int h0 = h_lo + team;
  float dn0 = 0.0f, dn1 = 0.0f;
  if (h0 < h_hi) {
    stage_h(h0, 0);
    stage_x(h0, 0);
    dn0 = load_dt(h0, ttid);
    dn1 = load_dt(h0, ttid + TEAM);
  }
  cp_commit();
  const int tw = t0 + 16 * wq;            // first row (chunk step) of this warp
  const int ta = tw + g, tb = ta + 8;     // this thread's two rows
  for (int h = h0; h < h_hi; h += K::TEAMS) {
    const int next = h + K::TEAMS;
    dts[ttid] = dn0;
    dts[ttid + TEAM] = dn1;
    if (next < h_hi) {
      dn0 = load_dt(next, ttid);
      dn1 = load_dt(next, ttid + TEAM);
    }
    team_sync(bar);
    chunk_cumsum(chi, clo, dts, A[h], wsum, ttid, bar);
    team_sync(bar);
    const float ehi = t0 ? chi[t0 - 1] : 0.0f, elo = t0 ? clo[t0 - 1] : 0.0f;
    const float ahi = chi[ta], alo = clo[ta], bhi = chi[tb], blo = clo[tb];
    // w = c dt below the row tile, in place (the cumsum has read dts).
    for (int s = ttid; s < t0; s += TEAM)
      dts[s] = ex2(LOG2E * seg(ehi, elo, chi[s], clo[s])) * dts[s];

    // exp(cum_e) C h_in^T, over the two halves of N.
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    for (int half = 0; half < 2; ++half) {
      if (half) {
        team_sync(bar);  // every warp is done with the first half
        stage_h(h, 1);
        cp_commit();
      }
      cp_wait<0>();
      team_sync(bar);
#pragma unroll 2
      for (int k0 = 0; k0 < P; k0 += 16) {
        FragA a;
        load_a<K::LDC>(a, Cs, 16 * wq, P * half + k0, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          FragB fb, fl;
          load_b_nk<K::LDH>(fb, Hh, 16 * np, k0, lane);
          load_b_nk<K::LDH>(fl, Hh + P * K::LDH, 16 * np, k0, lane);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            fb.lo[t][0] = fl.hi[t][0];
            fb.lo[t][1] = fl.hi[t][1];
          }
          mma_split<EX, false>(acc[2 * np], a, fb, 0);
          mma_split<EX, false>(acc[2 * np + 1], a, fb, 1);
        }
      }
    }
    {
      const float ee = ex2(LOG2E * (ehi + elo));
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= ee;
    }
    team_sync(bar);  // the h_in buffer is free

    for (int j = 0; j <= r; ++j) {
      // The next x tile; at the last, the next head's rows for the buffer
      // that the diagonal tile leaves free.
      if (j < r) stage_x(h, j + 1);
      else if (next < h_hi) {
        if (r & 1) stage_x(next, 0);
        else stage_h(next, 0);
      }
      cp_commit();
      cp_wait<1>();    // x tile j
      team_sync(bar);
      const T* xs = xbuf(j);
      if (j < r) {
        // (G * w) x over key tile j, w folded into G's columns.
#pragma unroll
        for (int kk = 0; kk < TR / 16; ++kk) {
          FragA a;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = (i & 1) ? tb : ta;
            const int s = TR * j + 16 * kk + 2 * tq + 8 * (i >> 1);
            const float2 gv = *reinterpret_cast<const float2*>(Gs + (t - t0) * K::LDG + s);
            const float2 wv = *reinterpret_cast<const float2*>(dts + s);
            split2(gv.x * wv.x, gv.y * wv.y, a.hi[i], a.lo[i]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            FragB fb;
            load_b_kn<K::LDX>(fb, xs, 16 * kk, 16 * np, lane);
            mma_split<false, EX>(acc[2 * np], a, fb, 0);
            mma_split<false, EX>(acc[2 * np + 1], a, fb, 1);
          }
        }
      } else {
        // The diagonal key tile: scale what came before by r_t, then
        // M[t][s] = G[t][s] exp(cum_t - cum_s) dt_s for s <= t, else 0.
        const float ra = ex2(LOG2E * seg(ahi, alo, ehi, elo));
        const float rb = ex2(LOG2E * seg(bhi, blo, ehi, elo));
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[n][0] *= ra; acc[n][1] *= ra;
          acc[n][2] *= rb; acc[n][3] *= rb;
        }
#pragma unroll
        for (int kk = 0; kk < TR / 16; ++kk) {
          const int s0 = t0 + 16 * kk;
          if (s0 > tw) break;
          FragA m;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = (i & 1) ? tb : ta;
            const float th = (i & 1) ? bhi : ahi, tl = (i & 1) ? blo : alo;
            const int s = s0 + 2 * tq + 8 * (i >> 1);
            const float2 gv = *reinterpret_cast<const float2*>(Gs + (t - t0) * K::LDG + s);
            const float m0 = s <= t
                ? (gv.x * ex2(LOG2E * seg(th, tl, chi[s], clo[s]))) * dts[s] : 0.0f;
            const float m1 = s + 1 <= t
                ? (gv.y * ex2(LOG2E * seg(th, tl, chi[s + 1], clo[s + 1]))) * dts[s + 1]
                : 0.0f;
            split2(m0, m1, m.hi[i], m.lo[i]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            FragB fb;
            load_b_kn<K::LDX>(fb, xs, 16 * kk, 16 * np, lane);
            mma_split<false, EX>(acc[2 * np], m, fb, 0);
            mma_split<false, EX>(acc[2 * np + 1], m, fb, 1);
          }
        }
      }
      team_sync(bar);  // x tile j's buffer is free
    }
    if (next < h_hi) {
      if (r & 1) stage_h(next, 0);
      else stage_x(next, 0);
    }
    cp_commit();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = 8 * n + 2 * tq;
      if (ta < rows) store2(y + ((l0 + ta) * H + h) * P + p, acc[n][0], acc[n][1]);
      if (tb < rows) store2(y + ((l0 + tb) * H + h) * P + p, acc[n][2], acc[n][3]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* h_last, void* S, void* hin, void* tot, int B, int L, int H,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(K1<T>::bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(K3<T>::bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (L + Q - 1) / Q;
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* Sf = static_cast<float*>(S);
  float* totf = static_cast<float*>(tot);
  bf16* hinb = static_cast<bf16*>(hin);
  ssd_chunk_state<T><<<dim3(nc, (H + HG1 - 1) / HG1, B), K1_THREADS, K1<T>::bytes, stream>>>(
      xt, dtf, Af, static_cast<const T*>(Bm), Sf, totf, L, H, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long BH = static_cast<long long>(B) * H;
  const long long threads = BH * (P * N / 4);
  ssd_state_pass<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      Sf, totf, hinb, static_cast<float*>(h_last), nc, H, BH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (H + HG3 - 1) / HG3;
  ssd_chunk_out<T><<<RT * groups * nc * B, K3<T>::THREADS, K3<T>::bytes, stream>>>(
      xt, dtf, Af, static_cast<const T*>(Bm), static_cast<const T*>(Cm), hinb,
      static_cast<T*>(y), L, H, nc, groups);
  return static_cast<int>(cudaGetLastError());
}

// ---- the SIMT route: any (P, N), float32 ------------------------------- //
constexpr int SQ_THREADS = Q;  // a thread per step of the chunk
constexpr int TT = 16;         // rows of M that ssd_chunk_out_simt holds at a time

// dA's inclusive cumsum over chunk c of (b, h) in float64, and dt, into
// shared memory; steps past L take dt = 0.
__device__ void chunk_cum_simt(const float* dt, float a, int b, int c, int h, int L, int H,
                               double* cum, float* dts) {
  const int t = threadIdx.x;
  const int l = c * Q + t;
  const float d = l < L ? dt[(static_cast<long long>(b) * L + l) * H + h] : 0.f;
  dts[t] = d;
  cum[t] = static_cast<double>(d * a);
  __syncthreads();
  for (int off = 1; off < Q; off <<= 1) {
    const double add = t >= off ? cum[t - off] : 0.0;
    __syncthreads();
    cum[t] += add;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SQ_THREADS)
ssd_chunk_state_simt(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     float* __restrict__ S, float* __restrict__ tot, int L, int H, int Pd,
                     int Nd, int nc) {
  __shared__ double cum[Q];
  __shared__ float dts[Q], w[Q];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  chunk_cum_simt(dt, A[h], b, c, h, L, H, cum, dts);
  const double total = cum[Q - 1];
  w[threadIdx.x] = expf(static_cast<float>(total - cum[threadIdx.x])) * dts[threadIdx.x];
  __syncthreads();
  const int steps = min(Q, L - c * Q);
  const long long row0 = static_cast<long long>(b) * L + static_cast<long long>(c) * Q;
  float* Sc = S + ((static_cast<long long>(b) * nc + c) * H + h) * Pd * Nd;
  for (int i = threadIdx.x; i < Pd * Nd; i += SQ_THREADS) {
    const int p = i / Nd, n = i % Nd;
    float acc = 0.f;
    for (int s = 0; s < steps; ++s)
      acc = fmaf(w[s] * __ldg(x + ((row0 + s) * H + h) * Pd + p), __ldg(Bm + (row0 + s) * Nd + n),
                 acc);
    Sc[i] = acc;
  }
  if (threadIdx.x == 0) tot[(static_cast<long long>(b) * nc + c) * H + h] = static_cast<float>(total);
}

__global__ void ssd_state_pass_simt(const float* __restrict__ S, const float* __restrict__ tot,
                                    float* __restrict__ hin, float* __restrict__ h_last, int nc,
                                    int H, long long PN, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long bh = i / PN, e = i % PN, b = bh / H, hh = bh % H;
  float hv = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long r = (b * nc + c) * H + hh;
    hin[r * PN + e] = hv;
    hv = expf(tot[r]) * hv + S[r * PN + e];
  }
  h_last[bh * PN + e] = hv;
}

__global__ void __launch_bounds__(SQ_THREADS)
ssd_chunk_out_simt(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ hin,
                   float* __restrict__ y, int L, int H, int Pd, int Nd, int nc) {
  __shared__ double cum[Q];
  __shared__ float dts[Q];
  __shared__ float M[TT][Q];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  chunk_cum_simt(dt, A[h], b, c, h, L, H, cum, dts);
  const int steps = min(Q, L - c * Q);
  const long long row0 = static_cast<long long>(b) * L + static_cast<long long>(c) * Q;
  const float* hc = hin + ((static_cast<long long>(b) * nc + c) * H + h) * Pd * Nd;
  for (int t0 = 0; t0 < steps; t0 += TT) {
    // M[r][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t = t0 + r.
    for (int i = threadIdx.x; i < TT * Q; i += SQ_THREADS) {
      const int r = i / Q, s = i % Q, t = t0 + r;
      float m = 0.f;
      if (t < steps && s <= t) {
        const float* ct = Cm + (row0 + t) * Nd;
        const float* bs = Bm + (row0 + s) * Nd;
        float g = 0.f;
        for (int n = 0; n < Nd; ++n) g = fmaf(__ldg(ct + n), __ldg(bs + n), g);
        m = g * expf(static_cast<float>(cum[t] - cum[s])) * dts[s];
      }
      M[r][s] = m;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TT * Pd; i += SQ_THREADS) {
      const int r = i / Pd, p = i % Pd, t = t0 + r;
      if (t >= steps) continue;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc = fmaf(M[r][s], __ldg(x + ((row0 + s) * H + h) * Pd + p), acc);
      const float* ct = Cm + (row0 + t) * Nd;
      const float* hp = hc + static_cast<long long>(p) * Nd;
      float inter = 0.f;
      for (int n = 0; n < Nd; ++n) inter = fmaf(__ldg(ct + n), hp[n], inter);
      y[((row0 + t) * H + h) * Pd + p] = acc + expf(static_cast<float>(cum[t])) * inter;
    }
    __syncthreads();
  }
}

}  // namespace

// The SIMT route, any P, N >= 1: x, y contiguous (B, L, H, P), B_, C_
// (B, L, N), dt (B, L, H), A (H,), h_last (B, H, P, N), all float32;
// scratch, with nc = ceil(L / 256): S and hin (B, nc, H, P, N), tot
// (B, nc, H) float32.  Three launches on `stream`; returns a CUDA error
// code (0 on success).
extern "C" int ssd_run_simt(const float* x, const float* dt, const float* A, const float* Bm,
                            const float* Cm, float* y, float* h_last, float* S, float* hin,
                            float* tot, int B, int L, int H, int Pd, int Nd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || H < 1 || Pd < 1 || Nd < 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (L + Q - 1) / Q;
  const dim3 grid(nc, H, B);
  ssd_chunk_state_simt<<<grid, SQ_THREADS, 0, s>>>(x, dt, A, Bm, S, tot, L, H, Pd, Nd, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long PN = static_cast<long long>(Pd) * Nd;
  const long long n = static_cast<long long>(B) * H * PN;
  ssd_state_pass_simt<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(S, tot, hin, h_last,
                                                                             nc, H, PN, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_out_simt<<<grid, SQ_THREADS, 0, s>>>(x, dt, A, Bm, Cm, hin, y, L, H, Pd, Nd, nc);
  return static_cast<int>(cudaGetLastError());
}

// x, y: contiguous (B, L, H, 64); B_, C_: (B, L, 128), all bf16 (bf16 != 0)
// or all float32; dt (B, L, H), A (H,), h_last (B, H, 64, 128) float32;
// scratch, with nc = ceil(L / 256): S (B, nc, H, 64, 128) float32, hin
// (B, nc, H, 2, 64, 128) bf16, tot (B, nc, H) float32.  x, B_, C_ and the
// scratch 16-byte aligned.  Three launches on `stream`; returns a CUDA
// error code (0 on success).
extern "C" int ssd_run(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, void* h_last, void* S, void* hin, void* tot,
                       int B, int L, int H, int bf16_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in) return launch<bf16>(x, dt, A, Bm, Cm, y, h_last, S, hin, tot, B, L, H, s);
  return launch<float>(x, dt, A, Bm, Cm, y, h_last, S, hin, tot, B, L, H, s);
}

extern "C" int ssd_chunk_len() { return Q; }

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
