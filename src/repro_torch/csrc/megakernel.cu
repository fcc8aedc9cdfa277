// Kernel B2: a whole actor network run to quiescence in ONE launch — the
// paper's §3.3 device-resident dispatch, with no host round trip per
// scheduling decision.
//
// Replaces the TPU kernel
// src/repro/core/megakernel/kernel.py::compile_megakernel (the persistent
// Pallas kernel with its in-kernel sweep loop).
//
// What it computes: the host dynamic executor's run (executor.run_dynamic
// in the port, the reference's `sweep` loop at kernel.py:671-716) over a
// device program packed by core/megakernel/program.py: sweeps in visit
// order until a sweep fires nothing or max_sweeps; per visit up to
// _max_fireable firings (cap 8), each guarded by _can_fire with the control
// token peeked and its rates looked up in the actor's rate table; masked
// ring reads and writes at the Eq. 1 offsets, with the Fig. 2 delay
// channel's shifted writes and slot-0 copy-back; fire counts, sweeps and
// the stall flag.  The Eq. 1 rings stay in device memory and are updated
// in place (DPD's 11.5 MB and motion detection's 3.5 MB fit in the 50 MB
// L2; a block's 227 KB of shared memory could not hold them).
//
// Design, simple and right first:
// * One cooperative launch, one block per SM, so that every block is
//   co-resident and cooperative_groups' grid barrier is legal.
// * The scheduler is replicated, not shared: thread 0 of every block runs
//   the same deterministic loop over its own shared-memory copy of the
//   cursor block, the fire counts, the actor states' int scalars and the
//   control rings (control tokens are scheduler state: only config actors
//   write them, only control ports read them).  Every block makes the same
//   decisions, so no cursor semaphore or atomic is needed, and a config
//   firing runs in thread 0 alone with no barrier.
// * Rings are bytes: a channel row carries its token size in bytes, so one
//   kernel moves DPD's float32 and motion detection's uint8 tokens.
//   Windows are copied in 16-, 4- or 1-byte words, the widest that every
//   address and length allows.  A source or sink copies its window through
//   its slab descriptor (planes of per-window runs), so DPD's two (re, im)
//   planes and motion detection's one run of frames take the same path.
// * Bodies run across the whole grid as grid-stride loops (source and sink
//   copy a window, fork copies its input to every enabled output, the adder
//   sums its enabled inputs from 0 in its terms' order with __fadd_rn, Poly
//   runs B1's arithmetic from dyn_fir.cuh, gauss/thres/med run B3's and
//   B4's per-pixel arithmetic from motion.cuh with clamped neighbours); a
//   grid barrier follows every body.  A rate-0 firing moves only the
//   replicated cursors.  Data written by one body is read in a later one
//   with __ldcg (L2), after the barrier.
// * The delay channel's copy-back needs no barrier of its own: after an
//   enabled phase-2 write, slot 0 takes slot 3r, the window's last token,
//   and the thread that writes a word of that token writes it to slot 0
//   too.  Its reader is a later body, after the grid barrier.  Only such
//   a firing runs the bodies compiled with that test (run_body_copy_back);
//   every other store tests nothing.
// * Poly history is updated in place without a race: only tile 0 reads the
//   9 history samples, tile 0 always belongs to block 0, and block 0 writes
//   the next history after its own block barrier that ends the tile's
//   staging; the next reader is a later body, after the grid barrier.
//
// Bound: on DPD, operations.  Poly's fp32 work over a run is the sum over
// active firings of L * (84 + order) flop (about 1.2 Gflop, 18 us at
// 67 TFLOP/s on DPD's main path), above the ~10 us of HBM time for the
// source and sink slabs (16.8 MB each at 3.35 TB/s).  On motion detection,
// bytes: the 73.7 MB source and sink slabs of 960 frames take 44 us.
// What holds it back by design: one grid barrier per body (about 650 per
// DPD run, 1200 per motion detection run, each a few us), one block per SM,
// stencils that read their neighbours from L2 rather than a staged tile,
// and a single-threaded scheduler step per firing attempt.  A later change
// would partition the grid (`cores`, one SM group per partition with
// cursor semaphores), move windows with TMA, and fuse bodies to need fewer
// barriers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dyn_fir.cuh"
#include "motion.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- packed table layout: mirrors core/megakernel/program.py ----------- //
enum { H_N_FIFOS, H_N_ACTORS, H_N_VISIT, H_FIFO_OFF, H_ACTOR_OFF, H_VISIT_OFF,
       H_N_APTRS, H_N_SCALARS, H_N_CTRL, H_LEN };
constexpr int FIFO_FIELDS = 12;
enum { F_RATE, F_CAP, F_TOKB, F_NPH, F_BOUND, F_CTRL, F_FWD, F_CBASE, F_DELAY,
       F_ELEM };
constexpr int ACTOR_FIELDS = 20;
enum { A_KIND, A_CTRL, A_IN, A_NIN, A_OUT, A_NOUT, A_READY, A_SCALAR, A_ORDER,
       A_RATES, A_DLO, A_DHI, A_PTR0, A_PTR1, A_AUX, A_NAUX, A_N0, A_N1,
       A_PLANES, A_FPARAM };
constexpr int META_WORDS = 8;
enum { M_SWEEPS, M_STALLED, M_ERROR, M_ERR_ACTOR, M_ERR_VALUE, M_BLOCKS };
enum { K_SOURCE, K_CONFIG, K_FORK, K_POLY, K_ADDER, K_SINK, K_GAUSS, K_THRES,
       K_MED };
enum { ERR_DOMAIN = 1, ERR_SLAB = 2 };

constexpr int MAX_FIRINGS_PER_VISIT = 8;  // executor.py:31
constexpr int MAX_PORTS = 32;             // checked by program.py
constexpr int THREADS = 256;              // = Poly tile, as in B1
constexpr int CMD_DONE = -1;

using dyn_fir::HALO;
using dyn_fir::N_TAPS;

// One body for the whole grid, decided by thread 0 of every block.
struct Cmd {
  int kind;
  int n_in, n_out;
  unsigned in_en, out_en;
  int order, n_terms;
  int n0, n1, planes;  // Poly: L; gauss/med: H, W; source/sink: plane bytes, planes
  float fparam;        // thres: the threshold
  long long win;       // bytes of input 0's window (fork, adder, gauss, thres, med)
  const unsigned char* in[MAX_PORTS];
  unsigned char* out[MAX_PORTS];
  // Bit o: output o is a delay channel on an enabled phase-2 write, whose
  // ring's slot 0 (slot0[o]) takes the window's bytes from cb_from[o] on
  // (slot 3r).  Unset bits leave slot0 and cb_from unread.
  unsigned cb_mask;
  unsigned char* slot0[MAX_PORTS];
  long long cb_from[MAX_PORTS];
  int terms[MAX_PORTS];
  unsigned char* slab;     // source/sink: window idx of the slab's plane 0
  long long slab_stride;   // source/sink: bytes between the slab's planes
  float* hist;
  const float* taps;
};

// Thread 0's scheduler position between bodies.
struct Sched {
  int sweeps, vpos, left, fired_any;
  int stalled, error, err_actor, err_value;
};

// Views of the shared-memory replicas.
struct View {
  const int* P;      // the packed program
  int* S;            // io words: cursors | scalars | control rings | counts
  long long* args;   // ring addresses | actor tensor addresses | io
  int io_scal, io_ctrl, io_counts;
};

__device__ __forceinline__ const int* fifo_row(const View& v, int f) {
  return v.P + v.P[H_FIFO_OFF] + FIFO_FIELDS * f;
}
__device__ __forceinline__ const int* actor_row(const View& v, int a) {
  return v.P + v.P[H_ACTOR_OFF] + ACTOR_FIELDS * a;
}
__device__ __forceinline__ int occ(const View& v, int f) { return v.S[3 * f + 2]; }
__device__ __forceinline__ int rd_off(const View& v, int f) {
  const int* fr = fifo_row(v, f);
  return (v.S[3 * f] % fr[F_NPH]) * fr[F_RATE];
}
// A delay channel writes one slot further on: slot 0 holds the delay token.
__device__ __forceinline__ int wr_off(const View& v, int f) {
  const int* fr = fifo_row(v, f);
  return (v.S[3 * f + 1] % fr[F_NPH]) * fr[F_RATE] + fr[F_DELAY];
}
__device__ __forceinline__ unsigned char* ring(const View& v, int f, int off) {
  return reinterpret_cast<unsigned char*>(static_cast<uintptr_t>(v.args[f])) +
         static_cast<long long>(off) * fifo_row(v, f)[F_TOKB];
}
__device__ __forceinline__ void* aptr(const View& v, int slot) {
  return reinterpret_cast<void*>(
      static_cast<uintptr_t>(v.args[v.P[H_N_FIFOS] + slot]));
}

// Enables of actor a: bit i for input i, bit n_in + o for output o.
// Returns false (with the error set) for a token outside the domain.
__device__ bool rates(const View& v, int a, unsigned long long* en, Sched* s) {
  const int* r = actor_row(v, a);
  const int n = r[A_NIN] + r[A_NOUT];
  if (r[A_CTRL] < 0) {
    *en = n >= 64 ? ~0ull : ((1ull << n) - 1);
    return true;
  }
  const int c = r[A_CTRL];
  const int tok = v.S[v.io_ctrl + fifo_row(v, c)[F_CBASE] + rd_off(v, c)];
  if (tok < r[A_DLO] || tok > r[A_DHI]) {
    s->error = ERR_DOMAIN;
    s->err_actor = a;
    s->err_value = tok;
    return false;
  }
  const int* row = v.P + r[A_RATES] + (tok - r[A_DLO]) * n;
  unsigned long long bits = 0;
  for (int i = 0; i < n; ++i) bits |= static_cast<unsigned long long>(row[i] != 0) << i;
  *en = bits;
  return true;
}

__device__ bool can_fire(const View& v, int a, Sched* s) {
  const int* r = actor_row(v, a);
  if (r[A_READY] >= 0 && v.S[v.io_scal + 2 * r[A_SCALAR]] >= r[A_READY]) return false;
  if (r[A_CTRL] >= 0 && occ(v, r[A_CTRL]) < 1) return false;
  unsigned long long en;
  if (!rates(v, a, &en, s)) return false;
  const int n_in = r[A_NIN];
  for (int i = 0; i < n_in; ++i) {
    const int f = v.P[r[A_IN] + i];
    if (((en >> i) & 1) && occ(v, f) < fifo_row(v, f)[F_RATE]) return false;
  }
  for (int o = 0; o < r[A_NOUT]; ++o) {
    const int f = v.P[r[A_OUT] + o];
    const int* fr = fifo_row(v, f);
    if (((en >> (n_in + o)) & 1) && occ(v, f) + fr[F_RATE] > fr[F_BOUND]) return false;
  }
  return true;
}

__device__ int max_fireable(const View& v, int a) {
  const int* r = actor_row(v, a);
  if (r[A_CTRL] >= 0) return min(MAX_FIRINGS_PER_VISIT, occ(v, r[A_CTRL]));
  int k = MAX_FIRINGS_PER_VISIT;
  for (int i = 0; i < r[A_NIN]; ++i) {
    const int f = v.P[r[A_IN] + i];
    k = min(k, occ(v, f) / fifo_row(v, f)[F_RATE]);
  }
  for (int o = 0; o < r[A_NOUT]; ++o) {
    const int f = v.P[r[A_OUT] + o];
    const int* fr = fifo_row(v, f);
    k = min(k, (fr[F_BOUND] - occ(v, f)) / fr[F_RATE]);
  }
  return k;
}

// One firing's bookkeeping (fire_actor): consume the control token, masked
// input reads, the actor's scalar state, masked output writes.  Fills `cmd`
// and returns true when the firing has a body for the grid to run.
__device__ bool fire(const View& v, int a, Cmd* cmd, Sched* s) {
  const int* r = actor_row(v, a);
  unsigned long long en;
  rates(v, a, &en, s);  // can_fire just checked the token
  if (r[A_CTRL] >= 0) {
    const int c = r[A_CTRL];
    v.S[3 * c] += 1;
    v.S[3 * c + 2] -= 1;
  }
  const int n_in = r[A_NIN], n_out = r[A_NOUT];
  const int kind = r[A_KIND];
  for (int i = 0; i < n_in; ++i) {
    const int f = v.P[r[A_IN] + i];
    cmd->in[i] = ring(v, f, rd_off(v, f));
    if ((en >> i) & 1) {
      v.S[3 * f] += 1;
      v.S[3 * f + 2] -= fifo_row(v, f)[F_RATE];
    }
  }
  const bool body = r[A_CTRL] < 0 || n_in + n_out == 0 || en != 0;
  int value = 0;
  if (body && (kind == K_SOURCE || kind == K_CONFIG || kind == K_SINK)) {
    int* sc = v.S + v.io_scal + 2 * r[A_SCALAR];
    const int idx = sc[0];
    if (kind != K_CONFIG && (idx < 0 || idx >= sc[1])) {
      s->error = ERR_SLAB;
      s->err_actor = a;
      s->err_value = idx;
      return false;
    }
    sc[0] = idx + 1;
    if (kind == K_CONFIG) {
      const int* sched = static_cast<const int*>(aptr(v, r[A_PTR0]));
      value = sched[min(max(idx, 0), r[A_AUX] - 1)];
    } else {
      // Plane p of window idx sits at p * stride + idx * plane_bytes.
      const long long plane_bytes = r[A_N0];
      cmd->slab = static_cast<unsigned char*>(aptr(v, r[A_PTR0])) + idx * plane_bytes;
      cmd->slab_stride = static_cast<long long>(sc[1]) * plane_bytes;
    }
  }
  unsigned cb_mask = 0;
  for (int o = 0; o < n_out; ++o) {
    const int f = v.P[r[A_OUT] + o];
    const int* fr = fifo_row(v, f);
    const int off = wr_off(v, f);
    const bool on = (en >> (n_in + o)) & 1;
    if (fr[F_CTRL]) {
      cmd->out[o] = nullptr;
      if (body && on && kind == K_CONFIG) v.S[v.io_ctrl + fr[F_CBASE] + off] = value;
    } else {
      cmd->out[o] = ring(v, f, off);
      if (on && fr[F_DELAY] && v.S[3 * f + 1] % fr[F_NPH] == 2) {  // Fig. 2
        cb_mask |= 1u << o;
        cmd->slot0[o] = ring(v, f, 0);
        cmd->cb_from[o] = static_cast<long long>(fr[F_RATE] - 1) * fr[F_TOKB];
      }
    }
    if (on) {
      v.S[3 * f + 1] += 1;
      v.S[3 * f + 2] += fr[F_RATE];
    }
  }
  v.S[v.io_counts + a] += 1;
  if (!body || kind == K_CONFIG) return false;
  // The body's parameters; only those its kind reads are written, since
  // thread 0 does this alone on every firing.
  cmd->kind = kind;
  cmd->cb_mask = cb_mask;
  cmd->n_in = n_in;
  cmd->n_out = n_out;
  cmd->in_en = static_cast<unsigned>(en & ((1ull << n_in) - 1));
  cmd->out_en = static_cast<unsigned>(en >> n_in);
  cmd->n0 = r[A_N0];
  if (kind == K_POLY) {
    cmd->order = r[A_ORDER];
    cmd->hist = static_cast<float*>(aptr(v, r[A_PTR0]));
    cmd->taps = static_cast<const float*>(aptr(v, r[A_PTR1]));
    return true;
  }
  if (kind == K_SOURCE || kind == K_SINK) {
    cmd->planes = r[A_PLANES];
    return true;
  }
  const int* f0 = fifo_row(v, v.P[r[A_IN]]);  // fork, adder, gauss, thres, med
  cmd->win = static_cast<long long>(f0[F_RATE]) * f0[F_TOKB];
  cmd->n1 = r[A_N1];
  cmd->fparam = __int_as_float(r[A_FPARAM]);
  if (kind == K_ADDER) {
    cmd->n_terms = r[A_NAUX];
    for (int t = 0; t < r[A_NAUX]; ++t) cmd->terms[t] = v.P[r[A_AUX] + t];
  }
  return true;
}

// Thread 0: advance the sweep loop (run_dynamic) to the next firing with a
// body, or to its end (cmd->kind = CMD_DONE).
__device__ void schedule_next(const View& v, Cmd* cmd, Sched* s,
                              int max_sweeps, int multi_firing) {
  const int* visit = v.P + v.P[H_VISIT_OFF];
  const int n_visit = v.P[H_N_VISIT];
  for (;;) {
    if (s->vpos < 0) {  // between sweeps: `while fired_any and sweeps < max`
      if (!s->fired_any || s->sweeps >= max_sweeps) {
        s->stalled = s->fired_any && s->sweeps >= max_sweeps;
        cmd->kind = CMD_DONE;
        return;
      }
      s->fired_any = 0;
      s->vpos = 0;
      s->left = -1;
    }
    if (s->vpos == n_visit) {
      s->sweeps += 1;
      s->vpos = -1;
      continue;
    }
    const int a = visit[s->vpos];
    if (s->left < 0) s->left = multi_firing ? max_fireable(v, a) : 1;
    if (s->left == 0 || !can_fire(v, a, s)) {
      if (s->error) {
        cmd->kind = CMD_DONE;
        return;
      }
      s->vpos += 1;
      s->left = -1;
      continue;
    }
    s->left -= 1;
    s->fired_any = 1;
    const bool body = fire(v, a, cmd, s);
    if (s->error) {
      cmd->kind = CMD_DONE;
      return;
    }
    if (body) return;
  }
}

// ---- bodies: every thread of the grid ---------------------------------- //
__device__ __forceinline__ long long grid_first() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_step() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// Store word x at byte b of output o's window.  CB is set only for a firing
// with a delay channel's enabled phase-2 write (cmd.cb_mask != 0): then x
// also goes to its slot-0 place when o is that channel and b lies in the
// window's last token (the Fig. 2 copy-back).  Every other firing runs the
// CB = false bodies, whose stores test nothing.
template <bool CB, typename T>
__device__ __forceinline__ void put(const Cmd& c, int o, long long b, T x) {
  *reinterpret_cast<T*>(c.out[o] + b) = x;
  if (CB && ((c.cb_mask >> o) & 1) && b >= c.cb_from[o])
    *reinterpret_cast<T*>(c.slot0[o] + (b - c.cb_from[o])) = x;
}

// The widest word (16, 4 or 1 bytes) that every address and length in
// `bits` allows.
__device__ __forceinline__ int word_bytes(unsigned long long bits) {
  return (bits & 15) == 0 ? 16 : ((bits & 3) == 0 ? 4 : 1);
}

// n bytes of src to byte `at` of every enabled output window.
template <bool CB, typename T>
__device__ void fan_out_words(const Cmd& c, const unsigned char* src, long long n,
                              long long at) {
  const T* s = reinterpret_cast<const T*>(src);
  for (long long j = grid_first(); j < n / static_cast<long long>(sizeof(T));
       j += grid_step()) {
    const T x = __ldcg(s + j);
    for (int o = 0; o < c.n_out; ++o)
      if ((c.out_en >> o) & 1) put<CB, T>(c, o, at + j * static_cast<long long>(sizeof(T)), x);
  }
}

template <bool CB>
__device__ void fan_out(const Cmd& c, const unsigned char* src, long long n, long long at) {
  unsigned long long bits = reinterpret_cast<uintptr_t>(src) | n | at;
  for (int o = 0; o < c.n_out; ++o) {
    if (!((c.out_en >> o) & 1)) continue;
    bits |= reinterpret_cast<uintptr_t>(c.out[o]);
    if (CB && ((c.cb_mask >> o) & 1))
      bits |= reinterpret_cast<uintptr_t>(c.slot0[o]) | c.cb_from[o];
  }
  switch (word_bytes(bits)) {
    case 16: fan_out_words<CB, uint4>(c, src, n, at); break;
    case 4: fan_out_words<CB, unsigned int>(c, src, n, at); break;
    default: fan_out_words<CB, unsigned char>(c, src, n, at); break;
  }
}

// n bytes of src (zeros when src is nullptr) to dst.
template <typename T>
__device__ void copy_words(unsigned char* dst, const unsigned char* src, long long n) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  for (long long j = grid_first(); j < n / static_cast<long long>(sizeof(T));
       j += grid_step())
    d[j] = s != nullptr ? __ldcg(s + j) : T{};
}

__device__ void copy_bytes(unsigned char* dst, const unsigned char* src, long long n) {
  switch (word_bytes(reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | n)) {
    case 16: copy_words<uint4>(dst, src, n); break;
    case 4: copy_words<unsigned int>(dst, src, n); break;
    default: copy_words<unsigned char>(dst, src, n); break;
  }
}

template <bool CB>
__device__ void run_poly(const Cmd& c, float* sb_re, float* sb_im, float* sh_re,
                         float* sh_im) {
  const int L = c.n0;
  const float* win_re = reinterpret_cast<const float*>(c.in[0]);
  const float* win_im = win_re + L;
  const bool write = c.out_en & 1;
  float* hist_re = c.hist;
  float* hist_im = c.hist + HALO;
  const int tid = threadIdx.x;
  const int n_tiles = (L + THREADS - 1) / THREADS;
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;
  if (tid < N_TAPS) {
    sh_re[tid] = __ldcg(c.taps + tid);
    sh_im[tid] = __ldcg(c.taps + N_TAPS + tid);
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * THREADS;
    float nr = 0.f, ni = 0.f;
    if (tile == 0 && tid < HALO) {
      // Next history: stream samples L .. L + 8 of hist ++ window.
      const int g = L + tid;
      nr = g < HALO ? __ldcg(hist_re + g) : __ldcg(win_re + g - HALO);
      ni = g < HALO ? __ldcg(hist_im + g) : __ldcg(win_im + g - HALO);
    }
    for (int j = tid; j < THREADS + HALO; j += THREADS) {
      const int g = base + j;
      float xr = 0.f, xi = 0.f;
      if (g < HALO) {
        xr = __ldcg(hist_re + g);
        xi = __ldcg(hist_im + g);
      } else if (g - HALO < L) {
        xr = __ldcg(win_re + g - HALO);
        xi = __ldcg(win_im + g - HALO);
      }
      dyn_fir::basis(xr, xi, c.order, &sb_re[j], &sb_im[j]);
    }
    __syncthreads();
    if (tile == 0 && tid < HALO) {  // tile 0's history reads are done
      hist_re[tid] = nr;
      hist_im[tid] = ni;
    }
    const int n = base + tid;
    if (write && n < L) {
      float yr, yi;
      dyn_fir::fir_mac(sb_re, sb_im, sh_re, sh_im, tid, &yr, &yi);
      put<CB, float>(c, 0, 4LL * n, yr);
      put<CB, float>(c, 0, 4LL * (L + n), yi);
    }
    __syncthreads();
  }
}

// A stencil over every u8 frame of the window: out pixel j = px(at, y, x)
// with at(dy, dx) the clamped neighbour of (y, x) in j's frame.  Motion
// detection's bodies stay out of line, so DPD's bodies keep their code
// compact in the sweep loop.
template <bool CB, typename Px>
__device__ __noinline__ void run_stencil(const Cmd& c, Px px) {
  const int H = c.n0, W = c.n1;
  const long long hw = static_cast<long long>(H) * W;
  for (long long j = grid_first(); j < c.win; j += grid_step()) {
    const long long frame = j / hw;
    const int p = static_cast<int>(j - frame * hw);
    const int y = p / W, x = p - y * W;
    const unsigned char* in = c.in[0] + frame * hw;
    auto at = [&](int dy, int dx) {
      return static_cast<float>(__ldcg(in + static_cast<long long>(motion::clampi(y + dy, 0, H - 1)) * W +
                                       motion::clampi(x + dx, 0, W - 1)));
    };
    const unsigned char u = motion::to_u8(px(at, y, x, H, W));
    for (int o = 0; o < c.n_out; ++o)
      if ((c.out_en >> o) & 1) put<CB, unsigned char>(c, o, j, u);
  }
}

template <bool CB>
__device__ __noinline__ void run_thres(const Cmd& c) {
  for (long long j = grid_first(); j < c.win; j += grid_step()) {
    const float cur = __ldcg(c.in[0] + j), prev = __ldcg(c.in[1] + j);
    put<CB, unsigned char>(c, 0, j, motion::to_u8(motion::thres_px(cur, prev, c.fparam)));
  }
}

struct GaussPx {
  template <typename At>
  __device__ float operator()(At at, int y, int x, int H, int W) const {
    return motion::gauss_px(at, y, x, H, W);
  }
};
struct MedPx {
  template <typename At>
  __device__ float operator()(At at, int, int, int, int) const {
    return motion::med_px(at);
  }
};

template <bool CB>
__device__ __forceinline__ void run_body(const Cmd& c, float* sb_re, float* sb_im,
                                         float* sh_re, float* sh_im) {
  switch (c.kind) {
    case K_SOURCE:
      if (c.out_en & 1)
        for (int p = 0; p < c.planes; ++p)
          fan_out<CB>(c, c.slab + p * c.slab_stride, c.n0, static_cast<long long>(p) * c.n0);
      break;
    case K_SINK:
      for (int p = 0; p < c.planes; ++p)
        copy_bytes(c.slab + p * c.slab_stride, c.in[0] + static_cast<long long>(p) * c.n0,
                   c.n0);
      break;
    case K_FORK:
      fan_out<CB>(c, c.in[0], c.win, 0);
      break;
    case K_ADDER:
      if (c.out_en & 1)
        for (long long j = grid_first(); j < c.win / 4; j += grid_step()) {
          float acc = 0.f;
          for (int t = 0; t < c.n_terms; ++t) {
            const int k = c.terms[t];
            if ((c.in_en >> k) & 1)
              acc = __fadd_rn(acc, __ldcg(reinterpret_cast<const float*>(c.in[k]) + j));
          }
          put<CB, float>(c, 0, 4 * j, acc);
        }
      break;
    case K_POLY:
      run_poly<CB>(c, sb_re, sb_im, sh_re, sh_im);
      break;
    case K_GAUSS:
      run_stencil<CB>(c, GaussPx());
      break;
    case K_MED:
      run_stencil<CB>(c, MedPx());
      break;
    case K_THRES:
      if (c.out_en & 1) run_thres<CB>(c);
      break;
  }
}

// The bodies of a firing that writes a delay channel's phase 2, out of line
// so that the sweep loop's common path keeps its code compact.
__device__ __noinline__ void run_body_copy_back(const Cmd& c, float* sb_re,
                                                float* sb_im, float* sh_re,
                                                float* sh_im) {
  run_body<true>(c, sb_re, sb_im, sh_re, sh_im);
}

__global__ void __launch_bounds__(THREADS, 1)
megakernel(const int* __restrict__ prog, long long* args, int n_ptrs,
           int io_len, int max_sweeps, int multi_firing) {
  extern __shared__ int smem[];
  __shared__ Cmd cmd;
  __shared__ float sb_re[THREADS + HALO];
  __shared__ float sb_im[THREADS + HALO];
  __shared__ float sh_re[N_TAPS];
  __shared__ float sh_im[N_TAPS];
  cg::grid_group grid = cg::this_grid();

  // 1. Replicate the program and the io words into this block.
  const int len = prog[H_LEN];
  const int n_state = io_len - META_WORDS;
  long long* io = args + n_ptrs;
  for (int i = threadIdx.x; i < len; i += blockDim.x) smem[i] = prog[i];
  for (int i = threadIdx.x; i < n_state; i += blockDim.x)
    smem[len + i] = static_cast<int>(io[i]);
  __syncthreads();
  View v;
  v.P = smem;
  v.S = smem + len;
  v.args = args;
  v.io_scal = 3 * v.P[H_N_FIFOS];
  v.io_ctrl = v.io_scal + 2 * v.P[H_N_SCALARS];
  v.io_counts = v.io_ctrl + v.P[H_N_CTRL];

  // 2. Forwarded data rings start from zeros (the dead-slot rule).
  for (int f = 0; f < v.P[H_N_FIFOS]; ++f) {
    const int* fr = fifo_row(v, f);
    if (!fr[F_FWD] || fr[F_CTRL]) continue;
    copy_bytes(ring(v, f, 0), nullptr, static_cast<long long>(fr[F_CAP]) * fr[F_TOKB]);
  }
  grid.sync();

  // 3. The sweep loop: thread 0 decides, the grid runs each body.
  Sched s = {0, -1, -1, 1, 0, 0, 0, 0};
  for (;;) {
    if (threadIdx.x == 0) schedule_next(v, &cmd, &s, max_sweeps, multi_firing);
    __syncthreads();
    if (cmd.kind == CMD_DONE) break;
    if (cmd.cb_mask)
      run_body_copy_back(cmd, sb_re, sb_im, sh_re, sh_im);
    else
      run_body<false>(cmd, sb_re, sb_im, sh_re, sh_im);
    grid.sync();
  }

  // 4. Block 0 writes the replicated state back.
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < n_state; i += blockDim.x) io[i] = v.S[i];
    if (threadIdx.x == 0) {
      long long* meta = io + n_state;
      meta[M_SWEEPS] = s.sweeps;
      meta[M_STALLED] = s.stalled;
      meta[M_ERROR] = s.error;
      meta[M_ERR_ACTOR] = s.err_actor;
      meta[M_ERR_VALUE] = s.err_value;
      meta[M_BLOCKS] = gridDim.x;
    }
  }
}

}  // namespace

// Launch B2 once on `stream` (PyTorch's current stream) as a cooperative
// grid of one block per SM.  `prog` is the packed program (prog_len int32
// words), `args` the run's block (n_ptrs addresses, then io_len io words),
// both on the current device.  Returns cudaGetLastError(), or the error of
// the failed query or refused launch.
extern "C" int megakernel_run(const int* prog, int prog_len, long long* args,
                              int n_ptrs, int io_len, int max_sweeps,
                              int multi_firing, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(prog_len + io_len) * sizeof(int);
  err = cudaFuncSetAttribute(megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, megakernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* kargs[] = {&prog, &args, &n_ptrs, &io_len, &max_sweeps, &multi_firing};
  err = cudaLaunchCooperativeKernel((const void*)megakernel, dim3(sms),
                                    dim3(THREADS), kargs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* megakernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
