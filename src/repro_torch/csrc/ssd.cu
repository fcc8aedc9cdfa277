// The Mamba2 SSD scan (state-space duality) on Hopper, per (batch, head):
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
// algorithm at the TPU kernel's chunk of 256, with C B^T formed once per
// (batch, chunk), needs about 3.9e10 flop: 0.04 ms on the bf16 tensor
// cores, 0.59 ms on float32 CUDA cores.  The kernel below runs on CUDA
// cores and is bound by its own arithmetic and shared-memory traffic.
//
// Design.  One block of 256 threads per (batch, head) walks L in order in
// sub-chunks of T = 32 steps; the (P, N) = (64, 128) state never leaves
// the SM: the running copy lives in registers (32 values per thread) and a
// copy in shared memory feeds the output term.  Per sub-chunk, as the TPU
// kernel does per chunk: cum = cumsum(dt A) (one thread, in order);
// G = (C B^T) * L with L[t, s] = exp(cum_t - cum_s) for s <= t;
// y = G (dt x) + exp(cum) * (C h^T); h = exp(cum_T) h + (w x)^T B with
// w = exp(cum_T - cum) dt.  The chunk length is the kernel's own choice (it
// changes only rounding); T = 32 keeps the intra-chunk products small and
// the block's 95 KB of shared memory lets two blocks share an SM.  Each
// thread computes a small register tile of every product (4 x 2 outputs,
// 8 x 4 state values) so shared-memory loads are reused.  y is rounded to
// x's type once, at the end, as in the TPU kernel.  Tensor cores, and
// forming C B^T once for all heads, are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int T = 32;  // steps per sub-chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

template <int P, int N>
struct Smem {
  float h[P][N + 1];     // state entering the sub-chunk
  float Bm[T][N + 1];
  float Cm[T][N + 1];
  float dtx[T][P];       // dt_s * x_s
  float wx[T][P];        // exp(cum_T - cum_s) dt_s * x_s
  float x[T][P];
  float G[T][T];
  float dt[T], cum[T], ecum[T];
};

template <typename TI, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const TI* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const TI* __restrict__ Bm,
           const TI* __restrict__ Cm, TI* __restrict__ y, float* __restrict__ h_last,
           int L, int H) {
  static_assert(P % 32 == 0 && N % 32 == 0 && P % WARPS == 0 && T % WARPS == 0, "tiles");
  constexpr int SP = P / WARPS, SN = N / 32;   // state tile per thread
  constexpr int YT = T / WARPS, YP = P / 32;   // output tile per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<P, N>& sm = *reinterpret_cast<Smem<P, N>*>(smem_raw);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float a = A[h];

  float hr[SP][SN];
#pragma unroll
  for (int i = 0; i < SP; ++i)
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      hr[i][j] = 0.0f;
      sm.h[warp + WARPS * i][lane + 32 * j] = 0.0f;
    }

  for (int t0 = 0; t0 < L; t0 += T) {
    __syncthreads();  // the previous sub-chunk's reads are done
    for (int i = tid; i < T * P; i += THREADS) {
      const int t = i / P, p = i % P, l = t0 + t;
      sm.x[t][p] = l < L ? to_f(x[((static_cast<long long>(b) * L + l) * H + h) * P + p]) : 0.0f;
    }
    for (int i = tid; i < T * N; i += THREADS) {
      const int t = i / N, n = i % N, l = t0 + t;
      const long long off = (static_cast<long long>(b) * L + l) * N + n;
      sm.Bm[t][n] = l < L ? to_f(Bm[off]) : 0.0f;
      sm.Cm[t][n] = l < L ? to_f(Cm[off]) : 0.0f;
    }
    if (tid < T) {
      const int l = t0 + tid;
      sm.dt[tid] = l < L ? dt[(static_cast<long long>(b) * L + l) * H + h] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {  // cum = cumsum(dt * A), in order
      float c = 0.0f;
      for (int t = 0; t < T; ++t) {
        c = __fadd_rn(c, __fmul_rn(sm.dt[t], a));
        sm.cum[t] = c;
        sm.ecum[t] = expf(c);
      }
    }
    __syncthreads();
    const float total = sm.cum[T - 1];
    for (int i = tid; i < T * P; i += THREADS) {
      const int s = i / P, p = i % P;
      const float xs = sm.x[s][p];
      sm.dtx[s][p] = sm.dt[s] * xs;
      sm.wx[s][p] = (expf(total - sm.cum[s]) * sm.dt[s]) * xs;
    }
    // G[t][s] = (C_t . B_s) * exp(cum_t - cum_s) for s <= t, else 0.
    {
      float g[YT];
#pragma unroll
      for (int i = 0; i < YT; ++i) g[i] = 0.0f;
      for (int n = 0; n < N; ++n) {
        const float bs = sm.Bm[lane][n];
#pragma unroll
        for (int i = 0; i < YT; ++i) g[i] += sm.Cm[warp + WARPS * i][n] * bs;
      }
#pragma unroll
      for (int i = 0; i < YT; ++i) {
        const int t = warp + WARPS * i, s = lane;
        sm.G[t][s] = s <= t ? g[i] * expf(sm.cum[t] - sm.cum[s]) : 0.0f;
      }
    }
    __syncthreads();
    // y = G (dt x) + exp(cum) * (C h^T), a 4 x 2 tile per thread.
    {
      float y1[YT][YP], ch[YT][YP];
#pragma unroll
      for (int i = 0; i < YT; ++i)
#pragma unroll
        for (int j = 0; j < YP; ++j) y1[i][j] = ch[i][j] = 0.0f;
      for (int s = 0; s < T; ++s) {
        float d[YP];
#pragma unroll
        for (int j = 0; j < YP; ++j) d[j] = sm.dtx[s][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < YT; ++i) {
          const float gv = sm.G[warp + WARPS * i][s];
#pragma unroll
          for (int j = 0; j < YP; ++j) y1[i][j] += gv * d[j];
        }
      }
      for (int n = 0; n < N; ++n) {
        float hv[YP];
#pragma unroll
        for (int j = 0; j < YP; ++j) hv[j] = sm.h[lane + 32 * j][n];
#pragma unroll
        for (int i = 0; i < YT; ++i) {
          const float c = sm.Cm[warp + WARPS * i][n];
#pragma unroll
          for (int j = 0; j < YP; ++j) ch[i][j] += c * hv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < YT; ++i) {
        const int t = warp + WARPS * i, l = t0 + t;
        if (l >= L) continue;
        TI* dst = y + ((static_cast<long long>(b) * L + l) * H + h) * P;
#pragma unroll
        for (int j = 0; j < YP; ++j)
          from_f(y1[i][j] + sm.ecum[t] * ch[i][j], dst + lane + 32 * j);
      }
    }
    // h = exp(cum_T) h + (w x)^T B, on the register copy.
    const float decay = expf(total);
    float upd[SP][SN];
#pragma unroll
    for (int i = 0; i < SP; ++i)
#pragma unroll
      for (int j = 0; j < SN; ++j) upd[i][j] = 0.0f;
    for (int s = 0; s < T; ++s) {
      float bv[SN];
#pragma unroll
      for (int j = 0; j < SN; ++j) bv[j] = sm.Bm[s][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < SP; ++i) {
        const float w = sm.wx[s][warp + WARPS * i];
#pragma unroll
        for (int j = 0; j < SN; ++j) upd[i][j] += w * bv[j];
      }
    }
    __syncthreads();  // every read of sm.h for this sub-chunk is done
#pragma unroll
    for (int i = 0; i < SP; ++i)
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        hr[i][j] = decay * hr[i][j] + upd[i][j];
        sm.h[warp + WARPS * i][lane + 32 * j] = hr[i][j];
      }
  }
  float* dst = h_last + (static_cast<long long>(b) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < SP; ++i)
#pragma unroll
    for (int j = 0; j < SN; ++j) dst[(warp + WARPS * i) * N + lane + 32 * j] = hr[i][j];
}

template <typename TI>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* h_last, int B, int L, int H, cudaStream_t stream) {
  constexpr int P = 64, N = 128;
  static bool configured = false;
  const int bytes = static_cast<int>(sizeof(Smem<P, N>));
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<TI, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  ssd_kernel<TI, P, N><<<dim3(H, B), THREADS, bytes, stream>>>(
      static_cast<const TI*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TI*>(Bm),
      static_cast<const TI*>(Cm), static_cast<TI*>(y), static_cast<float*>(h_last), L, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous (B, L, H, 64); B_, C_: (B, L, 128), all bf16 (bf16 != 0)
// or all float32; dt (B, L, H), A (H,), h_last (B, H, 64, 128) float32.
// Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int ssd_run(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, void* h_last, int B, int L, int H,
                       int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_last, B, L, H, s);
  return launch<float>(x, dt, A, Bm, Cm, y, h_last, B, L, H, s);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
