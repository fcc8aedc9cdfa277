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
// token peeked and its rates computed from the actor's declared enables
// (per port the constant 0 or 1, or tok[word] > threshold), for any token
// value, as the reference computes control(tok); masked ring reads and
// writes at the Eq. 1 offsets, with the Fig. 2 delay channel's shifted
// writes and slot-0 copy-back; fire counts, sweeps and the stall flag.  The Eq. 1 rings stay in device memory and are updated
// in place (DPD's 11.5 MB and motion detection's 3.5 MB fit in the 50 MB
// L2; a block's 227 KB of shared memory could not hold them).
//
// Bound: on DPD, operations.  Poly's fp32 work over a run is the sum over
// active firings of L * (84 + order) flop (about 1.2 Gflop, 18 us at
// 67 TFLOP/s on DPD's main path), above the ~10 us of HBM time for the
// source and sink slabs (16.8 MB each at 3.35 TB/s).  On motion detection,
// bytes: the 73.7 MB source and sink slabs of 960 frames take 44 us.  On
// the MoE network at olmoe-1b-7b's widths (chip_smoke.py phase 18):
// operations, the experts' three products over C rows each (about 515
// Gflop a run of 8 firings, 7.7 ms at 67 TFLOP/s, against 1.9 ms for their
// 6.4 GB of bf16 weights).
// What costs the time instead is latency: about 650 bodies per DPD run and
// 1200 per motion detection run, each well under a microsecond of bytes or
// flops, chained by data dependencies through L2, and the sweep loop that
// decides them one firing at a time.  The parent design ran each body
// across the grid behind a serial scheduler step and a grid barrier; this
// one overlaps the three (PERF.md has the clock split of both).
//
// Design: the scheduler runs ahead of the bodies, and bodies wait only for
// the bodies they depend on.
// * One cooperative launch, one block per SM, every block co-resident.
//   Each block is 256 body threads (the Poly tile, as in B1), a scheduler
//   warp, a publisher warp and a watcher warp.
// * The scheduler is replicated, not shared: the scheduler warp of every
//   block runs the same deterministic sweep loop over its own shared-memory
//   copy of the cursor block, the fire counts, the actor states' int
//   scalars and the control rings.  A config actor's control token is
//   scheduler state, written as the scheduler decides.  A token a body
//   writes (the MoE router's counts, the packer's packed token) is written
//   by every block's body threads into that block's own copy, and the
//   scheduler records the writing command as the token's last writer; the
//   one wait the scheduler ever makes on a body is before it peeks such a
//   token, for its own block to have run that command (ctrl_wait).  Only
//   then does it need a body's result, so otherwise it runs ahead.  Lane l handles input l and
//   output l of the actor it visits (can_fire, max_fireable and fire as
//   warp votes and reductions); cursor phases (cursor % phases) are kept, so
//   no step divides by a phase count; ring and tensor addresses are copied
//   into shared memory, so the only global load it makes is a config
//   actor's schedule entry.
// * Each firing with a body becomes a command: its number k (from 1),
//   wait_for, and what the body runs from (the addresses of its ports'
//   windows and of its slab window, its enables, its parameters).  The
//   scheduler warp writes it into a ring of RING command slots (mbarriers:
//   full, done, empty), a lane for each port; the body threads run their
//   share of the body from the slot, most as grid-stride loops.
// * Dependency waits, not a grid barrier per body.  Each block runs its
//   share of every command in order.  When every body warp of the block has
//   arrived on the slot's `done`, the publisher warp publishes k in the
//   block's progress word (fence.acq_rel.gpu, relaxed store) and frees the
//   slot, off the body threads' path.  A watcher warp keeps the least
//   progress of all blocks in shared memory (relaxed loads, then
//   fence.acq_rel.gpu and a release store when it grows).  Before command
//   k, warp 0 reads it with acquire loads until it covers wait_for, and a
//   block barrier hands that on: a dependency is usually met while the
//   block runs the commands before it, and a command with no conflict
//   waits for nothing.  wait_for is the largest k of an earlier command
//   that wrote a ring segment this one reads (RAW), or read or wrote one it
//   writes (WAR, WAW); a segment is a channel's window (with a delay
//   channel, the parts of its windows the one-slot shift cuts apart, and
//   slot 0 written by the copy-back).  core/megakernel/ref.py holds the same rule
//   (hazard_waits), and the tests replay its command lists in orders the
//   rule permits.  Data written in another block is read with __ldcg (L1 is
//   not coherent across SMs).  The start-up zeroing of forwarded rings
//   keeps its one grid barrier.
// * Poly history is updated in place without a wait: only tile 0 reads the
//   9 history samples, tile 0 always belongs to block 0, block 0 runs its
//   commands in order, and it writes the next history after the block
//   barrier that ends the tile's staging.  Source slabs are only read and
//   each sink window is written once per run, so neither is a resource.
// * Rings are bytes: a channel row carries its token size in bytes, so one
//   kernel moves DPD's float32 and motion detection's uint8 tokens.
//   Windows are copied in 16-, 4- or 1-byte words, the widest that every
//   address and length allows.  A source or sink copies its window through
//   its slab descriptor (planes of per-window runs).  Bodies: source and
//   sink copy a window, fork copies its input to every enabled output, the
//   adder sums its enabled inputs from 0 in its terms' order with
//   __fadd_rn, Poly runs B1's arithmetic from dyn_fir.cuh, gauss/thres/med
//   run B3's and B4's per-pixel arithmetic from motion.cuh with clamped
//   neighbours: gauss and med on rows a block stages (as floats, with their
//   halo) in shared memory, thres on 16 pixels a thread; the adder keeps 8
//   terms' loads in flight.  A rate-0 firing moves only the replicated
//   cursors.
// * The delay channel's copy-back: after an enabled phase-2 write, slot 0
//   takes slot 3r, the window's last token; the thread that writes a word
//   of that token writes it to slot 0 too.  Only such a firing runs the
//   bodies compiled with that test (run_body_copy_back).
// * Built with -DMK_CLOCK_SPLIT, thread 0 of block 0 counts its cycles
//   waiting for the scheduler (the ring empty), waiting on other blocks
//   (and how often), in each kind of body (and how often), and in the
//   whole command loop, and block 0's scheduler warp its cycles deciding
//   and waiting for a free slot, into the meta words from M_CLK_STALL on
//   (kernel.py's decode_clock_split reads them).
// * Built with -DMK_GUARDS, the health layer's channel guards
//   (core/health.py), each an observer that changes no operation.  The
//   cursor guards belong to the scheduler warp, which already handles input
//   l and output l of a firing in lane l: before each op it recomputes the
//   true occupancy delay + (wr - rd) * rate from the io words (not from
//   the phases, which a corrupted cursor leaves out of step) and ORs
//   CURSOR_INVALID, UNDERFLOW and OVERFLOW into a per-channel word in
//   shared memory, with the write's true occupancy after it as the
//   high-water mark; a control token read or written is checked against its
//   channel's domain (DOMAIN).  Every block keeps them, block 0 writes them
//   out.  NONFINITE and a data channel's DOMAIN read token values: before a
//   body, the block scans its share of every enabled float input window for
//   NaN and Inf (inputs stay put while a command runs); every store of an
//   enabled float output (put) tests the word it stores.  bf16 and f16
//   tokens (copy bodies and step windows only) are tested on their 16-bit
//   patterns (every exponent bit set) and, against a domain, widened to
//   float32 against bounds the program rounded to their type; their words
//   are never single bytes (word_bytes' 2-byte level).  In a program with
//   a data channel that declares a domain (H_DOM) the block also scans every
//   enabled input window of such a channel for an element outside [lo, hi],
//   and a command with such an output runs bodies of their own (CB_DOM)
//   whose stores test it; the body threads find those ports from the channel
//   rows, not the scheduler warp, which bounds DPD, and a program without a
//   domain runs what it ran before.  A bad word sets its port's bit in a
//   block word, and after the body thread 0 ORs NONFINITE or DOMAIN into the
//   channel's fault word in global memory.
// * Built with -DMK_TRACE, block 0's scheduler warp writes one event per
//   firing attempt (trace.py's row: actor, sweep, fired, then every
//   channel's occupancy after the attempt) into a (capacity, 3 + channels)
//   ring in global memory, under a monotonic count: all k attempts of a
//   visit, k the bound at its start, the skipped ones after a failed
//   attempt included, as the reference records them.
// * Faulty operations go ahead and are reported.  An overflow's write past
//   the Eq. 1 bound is a write like any other to the dependency rule, which
//   orders it after the segment's last reader.
// * The MoE kinds (router, expert, combine, packer) take up to 256 ports a
//   side on a wide path of the scheduler (a lane takes ports l, l + 32, ...;
//   per port enable and window phase bits in the command).  The router and
//   an expert run in two phases, two commands, the second waiting for the
//   first in every block, through a float32 scratch tensor per actor (the
//   router's logits, the expert's hidden rows); a firing's first command
//   also waits for the actor's previous firing, which shares the scratch.
//   Router: phase 0 the logits split over the grid, one a thread; phase 1
//   the routing in every block (softmax, top-k, capacity ranks by a scan
//   per expert in token-major order, in shared memory), then block 0's
//   slots, weights and counts, each block's own control tokens, and the
//   dispatched slabs a row a block.  Expert: SIMT tiles of 16 columns by up
//   to 96 rows, operands staged 32 k at a time; phase 0 both hidden
//   products and SwiGLU, phase 1 the output product.  Every sum is from 0
//   in the order of its index, each product and add rounded alone, as the
//   plain version sums (ref.py).  Combine: an output a thread, the k
//   weighted rows in order.  Packer: every block, its own control words.
// * The serving network's bodies (graphs/serving.py; all int32, bit for
//   bit the actors' fire): gate copies input k to output k under its
//   enables, merge folds the decoded tokens into the slot table (grid
//   stride; its feedback window copies back on phase 2), retire scatters
//   the finished rows into its state tensors (warp 0 of block 0, rows in
//   order).  Admission runs in warp 0 of every block: each block keeps its
//   own replica of admission's control token, its two scalars (retired,
//   the ready limit's, and the step t) and its taken flags among the io
//   words, so its scheduler waits for its own block's body before it reads
//   them (ctrl_wait, local_wait); block 0 writes the table and the
//   finished rows.  Ranks come from ballots in request and slot order.
// * Step actors (a decode step, an LM stage) have no body here.  At an
//   enabled firing of one, after its bookkeeping and its trace event, the
//   scheduler stops the run (ERR_YIELD): the yield words after the fire
//   counts take the scheduler (sweeps, visit position, firings left,
//   fired_any, commands emitted) and the firing's actor, enables and window
//   offsets, and every block ends (the kernel's end is the wait for every
//   earlier command in every block).  The runner fires the actor between
//   launches.  A launch on io words with a step pending resumes: it
//   restores the scheduler, numbers commands on from the saved count (the
//   progress words start there), keeps the forwarded rings as they are
//   and, in the MK_GUARDS build, first checks the step's windows (NONFINITE,
//   DOMAIN) as dynamic mode's guards read them; the high-water marks and
//   the trace count go on from the io words.  A rate-0 step firing is the
//   scheduler's own (no stop).  These kinds, like the MoE ones, run in the
//   instance with MOE set.
#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "dyn_fir.cuh"
#include "motion.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- packed table layout: mirrors core/megakernel/program.py ----------- //
enum { H_N_FIFOS, H_N_ACTORS, H_N_VISIT, H_FIFO_OFF, H_ACTOR_OFF, H_VISIT_OFF,
       H_N_APTRS, H_N_SCALARS, H_N_CTRL, H_LEN, H_SCRATCH, H_MOE, H_DOM };
constexpr int FIFO_FIELDS = 13;
// F_DOM: a data channel with a declared domain, [F_DLO, F_DHI] as float32
// bits for float channels (a bf16 or f16 channel's rounded to its type
// first), as ints for u8 and int32 ones (control channels
// always compare their int32 tokens with F_DLO and F_DHI).
enum { F_RATE, F_CAP, F_TOKB, F_NPH, F_BOUND, F_CTRL, F_FWD, F_CBASE, F_DELAY,
       F_ELEM, F_DLO, F_DHI, F_DOM };
enum { ELEM_F32 = 0, ELEM_U8 = 1, ELEM_I32 = 2, ELEM_BF16 = 3, ELEM_F16 = 4 };
__host__ __device__ __forceinline__ bool is_half(int elem) {
  return elem == ELEM_BF16 || elem == ELEM_F16;
}
constexpr int ACTOR_FIELDS = 20;
enum { A_KIND, A_CTRL, A_IN, A_NIN, A_OUT, A_NOUT, A_READY, A_SCALAR, A_ORDER,
       A_ENABLES, A_N2, A_N3, A_PTR0, A_PTR1, A_AUX, A_NAUX, A_N0, A_N1,
       A_PLANES, A_FPARAM };
constexpr int META_WORDS = 17;
enum { M_SWEEPS, M_STALLED, M_ERROR, M_ERR_ACTOR, M_ERR_VALUE, M_BLOCKS,
       M_CLK_STALL, M_CLK_LOOP, M_CLK_SCHED, M_CLK_KIND };
enum { K_SOURCE, K_CONFIG, K_FORK, K_POLY, K_ADDER, K_SINK, K_GAUSS, K_THRES,
       K_MED, K_ROUTER, K_EXPERT, K_COMBINE, K_PACKER, K_ADMISSION, K_GATE,
       K_MERGE, K_RETIRE, K_STEP };
// ERR_YIELD: not an error, the run stopped at an enabled step firing.
enum { ERR_SLAB = 2, ERR_YIELD = 3 };
// Yield words, after the fire counts (program.py's Y_*): a step firing is
// pending, the saved scheduler, the step firing's actor, enables and the
// first slot of each of its windows.
constexpr int MAX_STEP_PORTS = 8;
enum { Y_PENDING, Y_SWEEPS, Y_VPOS, Y_LEFT, Y_FIRED, Y_SEQ, Y_ACTOR, Y_IN_EN, Y_OUT_EN,
       Y_OFF };
// The serving network's slot table (graphs/serving.py): a row is
// SLOT_HEADER columns, P prompt columns, N generated-token columns.
enum { C_ACTIVE, C_REQ, C_POS, C_PROD, C_BUDGET, C_FIN, C_LAST, C_NEW, C_LAT, C_STATUS,
       C_DEADLINE, C_AGE, SLOT_HEADER };
enum { STATUS_OK = 0, STATUS_TIMEOUT = 1, STATUS_SHED = 2 };
// Fault bits (core/health.py).  After the meta words: a fault word per
// channel, a high-water mark per channel, the trace's event count.
enum { OVERFLOW = 1, UNDERFLOW = 2, CURSOR_INVALID = 4, NONFINITE = 8, DOMAIN = 32 };
#ifdef MK_GUARDS
constexpr int GUARD_INTS = 2;  // per channel in shared memory: fault bits, high water
#else
constexpr int GUARD_INTS = 0;
#endif

constexpr int MAX_FIRINGS_PER_VISIT = 8;  // executor.py:31
constexpr int MAX_PORTS = 32;             // checked by program.py; a lane each
constexpr int WIDE_WORDS = 8;             // the MoE kinds: up to 256 ports a side
constexpr int BODY_THREADS = 256;         // = Poly tile, as in B1
constexpr int SCHED_TID = BODY_THREADS;   // the scheduler warp
constexpr int PUBLISH_TID = BODY_THREADS + 32;  // the publisher warp
constexpr int WATCH_TID = BODY_THREADS + 64;    // the watcher warp
constexpr int THREADS = BODY_THREADS + 96;
constexpr int TILE_FLOATS = 4096;         // a stencil's staged rows
constexpr int RING = 16;                  // command slots
constexpr int SEGS = 8;                   // segments a channel has, at most 7
constexpr int CMD_DONE = -1;
constexpr unsigned FULL = 0xffffffffu;

using dyn_fir::HALO;
using dyn_fir::N_TAPS;

// A command: one firing with a body as the scheduler warp decided it, with
// the addresses and parameters the body threads run it from.
struct Cmd {
  long long seq, wait_for;
  int kind;            // CMD_DONE ends the run
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
  int terms[MAX_PORTS];     // the adder's term order; admission: each output's
                            // control token io word
  unsigned char* slab;     // source/sink: window idx of the slab's plane 0
  long long slab_stride;   // source/sink: bytes between the slab's planes
  float* hist;
  const float* taps;
#ifdef MK_GUARDS
  unsigned in_fl;          // bit k: input k's channel carries float tokens of any width
  unsigned in_h, in_hf;    // bit k: input k's tokens are bf16 or f16; are f16
  unsigned out_fl;         // bit k: output k's channel carries float32 tokens
  unsigned out_h, out_hf;  // bit k: output k's tokens are bf16 or f16; are f16
  int in_f[MAX_PORTS];     // each port's channel
  int out_f[MAX_PORTS];
#endif
  // The MoE kinds (the wide path): the actor's row, which phase of the
  // firing this command runs, and per port its enable and its window's
  // phase (delay-free channels have two), bit p % 32 of word p / 32.  The
  // serving kinds take their parameters from the row too.
  const int* row;
  int phase;
  unsigned wen_in[WIDE_WORDS], wen_out[WIDE_WORDS];
  unsigned wph_in[WIDE_WORDS], wph_out[WIDE_WORDS];
};

// The scheduler warp's position between firings (the same in every lane).
struct Sched {
  int sweeps, vpos, left, fired_any;
  int stalled, error, err_actor, err_value;
  long long seq;           // commands emitted
#ifdef MK_TRACE
  long long events;        // trace events recorded
#endif
};

// One firing as fire() leaves it: lane l holds input l's and output l's
// window; the rest is the same in every lane.
struct Firing {
  long long wait_for;
  unsigned in_en, out_en, cb_mask;
  int idx, n_idx;
  int in_off, out_off;
  int phases;              // commands the firing becomes (the wide path's
                           // enables and phases are in View::wide)
};

// Views of the shared-memory replicas.
struct View {
  const int* P;            // the packed program
  int* S;                  // io words: cursors | scalars | control rings | counts
  int* ph;                 // per channel: read phase, write phase
  const long long* addr;   // ring addresses | actor tensor addresses
  long long* trk;          // per channel: each segment's last writer, then last reader
  const int* fifos;        // the channel rows
  const int* actors;       // the actor rows
  int n_fifos, io_scal, io_ctrl, io_counts;
  long long* alast;        // per actor: the last command of its last firing (MoE scratch)
  const long long* local_done;  // this block has run every command up to it
  int* moe;                // the router's routing words (H_SCRATCH)
  // The wide path's last firing, by the scheduler warp for fill: enables
  // in, out, then window phase bits in, out, WIDE_WORDS words each; its
  // wait.
  unsigned* wide;
  long long* wide_wait;
#ifdef MK_GUARDS
  int* fault;              // per channel: the cursor guards' bits
  int* hw;                 // per channel: the high-water mark
#endif
#ifdef MK_TRACE
  int* trace;              // the event ring (global memory), block 0 only
  int trace_cap;
#endif
};

__device__ __forceinline__ const int* fifo_row(const View& v, int f) {
  return v.fifos + FIFO_FIELDS * f;
}
__device__ __forceinline__ const int* actor_row(const View& v, int a) {
  return v.actors + ACTOR_FIELDS * a;
}
__device__ __forceinline__ int occ(const View& v, int f) { return v.S[3 * f + 2]; }
__device__ __forceinline__ unsigned char* ring(const View& v, int f, int off) {
  return reinterpret_cast<unsigned char*>(static_cast<uintptr_t>(v.addr[f])) +
         static_cast<long long>(off) * fifo_row(v, f)[F_TOKB];
}
__device__ __forceinline__ void* aptr(const View& v, int slot) {
  return reinterpret_cast<void*>(static_cast<uintptr_t>(v.addr[v.n_fifos + slot]));
}
__device__ __forceinline__ long long& last_writer(const View& v, int f, int seg) {
  return v.trk[2 * SEGS * f + seg];
}
__device__ __forceinline__ long long& last_reader(const View& v, int f, int seg) {
  return v.trk[2 * SEGS * f + SEGS + seg];
}

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }
// The largest of the warp's w (command numbers stay below 2^32 in any run
// that ends in hours, so one 32-bit reduction does, checked).
__device__ __forceinline__ long long warp_max(long long w) {
  if (__any_sync(FULL, (w >> 32) != 0)) {
    for (int o = 16; o; o >>= 1) {
      const long long x = __shfl_xor_sync(FULL, w, o);
      w = x > w ? x : w;
    }
    return w;
  }
  return __reduce_max_sync(FULL, static_cast<unsigned>(w));
}
__device__ __forceinline__ unsigned low_bits(int n) {
  return n >= 32 ? FULL : (1u << n) - 1;
}
__device__ __forceinline__ int next_phase(int ph, int n_phases) {
  return ph + 1 == n_phases ? 0 : ph + 1;
}
// The io word of control channel c's token at phase ph (rate 1: phase p is
// slot p), a token of F_TOKB / 4 words.
__device__ __forceinline__ int ctrl_word(const View& v, int c, int ph) {
  const int* fr = fifo_row(v, c);
  return v.io_ctrl + fr[F_CBASE] + ph * (fr[F_TOKB] >> 2);
}
__device__ __forceinline__ bool bit_of(const unsigned* words, int p) {
  return (words[p >> 5] >> (p & 31)) & 1;
}

#ifdef MK_GUARDS
// The cursor guards of one op on channel f from its pre-op io words
// (health.py's read_guard_bits / write_guard_bits): CURSOR_INVALID, and in
// *true_occ the occupancy the cursors give.
__device__ __forceinline__ int cursor_bits(const View& v, int f, int delay, int rate,
                                           int* true_occ) {
  *true_occ = delay + (v.S[3 * f + 1] - v.S[3 * f]) * rate;
  return v.S[3 * f + 2] != *true_occ ? CURSOR_INVALID : 0;
}
// DOMAIN of a control token against its channel's declared domain.
__device__ __forceinline__ int domain_bit(const View& v, int f, int tok) {
  const int* fr = fifo_row(v, f);
  return tok < fr[F_DLO] || tok > fr[F_DHI] ? DOMAIN : 0;
}
// DOMAIN of every word of channel f's token at io word `at`.
__device__ int token_domain_bits(const View& v, int f, int at) {
  int bits = 0;
  for (int w = 0; w < (fifo_row(v, f)[F_TOKB] >> 2); ++w) bits |= domain_bit(v, f, v.S[at + w]);
  return bits;
}
#endif

// ---- synchronisation --------------------------------------------------- //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar))
               : "memory");
}
// A wait that outlasts this many cycles (about 35 s at 1.98 GHz) traps: a
// broken dependency then fails the launch instead of hanging the card.
constexpr long long WAIT_LIMIT = 1LL << 36;
__device__ __forceinline__ void watchdog(long long since) {
  if (clock64() - since > WAIT_LIMIT) __trap();
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long since = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done) watchdog(since);
  } while (!done);
}
// The 256 body threads' own barrier (the other warps never join it).
__device__ __forceinline__ void body_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(BODY_THREADS) : "memory");
}
// This block has finished command `seq` (every body warp has arrived on the
// slot's `done`): make the share's writes visible to the GPU, then publish
// the number.
__device__ __forceinline__ void publish(unsigned long long* word, long long seq) {
  asm volatile("fence.acq_rel.gpu;\n"
               "st.relaxed.gpu.global.u64 [%0], %1;\n"
               :: "l"(word), "l"(static_cast<unsigned long long>(seq)) : "memory");
}
__device__ __forceinline__ long long load_relaxed(const unsigned long long* word) {
  unsigned long long x;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(x) : "l"(word) : "memory");
  return static_cast<long long>(x);
}
__device__ __forceinline__ void store_release_cta(long long* word, long long x) {
  asm volatile("st.release.cta.shared.u64 [%0], %1;\n" :: "r"(smem_u32(word)),
               "l"(static_cast<unsigned long long>(x)) : "memory");
}
__device__ __forceinline__ long long load_acquire_cta(const long long* word) {
  unsigned long long x;
  asm volatile("ld.acquire.cta.shared.u64 %0, [%1];\n" : "=l"(x) : "r"(smem_u32(word))
               : "memory");
  return static_cast<long long>(x);
}

// The watcher warp: keeps *least, in shared memory, at the least progress
// of all blocks until the body threads set *finished.  Its loads are
// relaxed, so a lane's few are in flight together; when the least grows, a
// fence.acq_rel.gpu makes them an acquire, and a release store hands the
// value on: a body warp that reads it with an acquire, and the block
// barrier after that, see every write of the commands up to it.  So a
// command's dependency is usually met while the block runs the commands
// before it, and the block only reads shared memory to know.
__device__ void watcher(const unsigned long long* progress, long long* least,
                        const volatile int* finished) {
  long long known = 0;
  while (!*finished) {
    long long m = LLONG_MAX;
    for (int b = lane(); b < static_cast<int>(gridDim.x); b += 32) {
      const long long p = load_relaxed(progress + b);
      m = p < m ? p : m;
    }
    for (int o = 16; o; o >>= 1) {
      const long long p = __shfl_xor_sync(FULL, m, o);
      m = p < m ? p : m;
    }
    if (m > known) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      known = m;
      if (lane() == 0) store_release_cta(least, m);
    }
  }
}

// ---- the scheduler warp ------------------------------------------------ //
// The actor being visited, loaded once per visit: the same in every lane,
// except that lane l holds input l's and output l's channel.
struct Visit {
  const int* r;            // the actor's row
  int a, kind, n_in, n_out, ctrl, wide;
  int ctrl_base, ctrl_nph; // the control ring's first io word, its phases
  int ctrl_words;          // words of a control token
  int ready, scalar;       // ready limit (-1: none) and its scalar slot
  int fi, fo;              // lane l's input and output channel, -1 for none
  int rate_i, nph_i, data_i, delay_i, tokb_i;
  int rate_o, nph_o, bound_o, delay_o, data_o, cbase_o, tokb_o;
  unsigned char* ring_i;   // the rings' first slots
  unsigned char* ring_o;
};

__device__ __forceinline__ void visit_actor(const View& v, int a, Visit* u) {
  const int l = lane();
  const int* r = actor_row(v, a);
  u->r = r;
  u->a = a;
  u->kind = r[A_KIND];
  u->n_in = r[A_NIN];
  u->n_out = r[A_NOUT];
  u->ctrl = r[A_CTRL];
  u->wide = u->kind >= K_ROUTER && u->kind <= K_PACKER;
  if (u->ctrl >= 0) {
    const int* fc = fifo_row(v, u->ctrl);
    u->ctrl_base = v.io_ctrl + fc[F_CBASE];
    u->ctrl_nph = fc[F_NPH];
    u->ctrl_words = fc[F_TOKB] >> 2;
  }
  u->ready = r[A_READY];
  u->scalar = r[A_SCALAR];
  u->fi = l < u->n_in ? v.P[r[A_IN] + l] : -1;
  u->fo = l < u->n_out ? v.P[r[A_OUT] + l] : -1;
  if (u->fi >= 0) {
    const int* fr = fifo_row(v, u->fi);
    u->rate_i = fr[F_RATE];
    u->nph_i = fr[F_NPH];
    u->data_i = !fr[F_CTRL];
    u->delay_i = fr[F_DELAY];
    u->tokb_i = fr[F_TOKB];
    u->ring_i = ring(v, u->fi, 0);
  }
  if (u->fo >= 0) {
    const int* fr = fifo_row(v, u->fo);
    u->rate_o = fr[F_RATE];
    u->nph_o = fr[F_NPH];
    u->bound_o = fr[F_BOUND];
    u->delay_o = fr[F_DELAY];
    u->data_o = !fr[F_CTRL];
    u->cbase_o = fr[F_CBASE];
    u->tokb_o = fr[F_TOKB];
    u->ring_o = ring(v, u->fo, 0);
  }
}

// A control token a body writes (the MoE router's counts, the packer's
// packed token) goes into this block's own v.S from its body threads, and
// the scheduler records the writing command as the token's segment's last
// writer.  Before the token is peeked, wait until this block has run that
// command (the publisher's local_done), and mark it read.
// Out of line, and given pointers only: a View whose address is taken
// would leave the registers of the scheduler's narrow path.
__device__ __noinline__ void ctrl_wait(long long* writer, long long* reader,
                                       const long long* local_done) {
  const long long w = *writer;
  if (w > *reader) {
    const long long since = clock64();
    while (load_acquire_cta(local_done) < w) watchdog(since);
  }
  __syncwarp();
  if (lane() == 0 && w > *reader) *reader = w;
  __syncwarp();
}

// Wait until this block has run command w (admission's body writes the
// scalar its ready limit reads).
__device__ __noinline__ void local_wait(long long w, const long long* local_done) {
  const long long since = clock64();
  while (load_acquire_cta(local_done) < w) watchdog(since);
  __syncwarp();
}

// A port's declared enable on token `tok`: (word, threshold) is tok[word]
// > threshold, (-1, v) the constant v.
__device__ __forceinline__ bool enable_of(const int* form, const int* tok) {
  return form[0] < 0 ? form[1] != 0 : tok[form[0]] > form[1];
}

// Enables of the visited actor, the same in every lane: bit i of *in_en
// for input i, bit o of *out_en for output o, from its declared enables on
// the control token, whatever its value.
template <bool MOE>
__device__ __forceinline__ void rates(const View& v, const Visit& u, unsigned* in_en,
                                      unsigned* out_en) {
  if (u.ctrl < 0) {
    *in_en = low_bits(u.n_in);
    *out_en = low_bits(u.n_out);
    return;
  }
  const int ph = v.ph[2 * u.ctrl];
  if constexpr (MOE)
    ctrl_wait(&last_writer(v, u.ctrl, ph), &last_reader(v, u.ctrl, ph), v.local_done);
  const int* tok = v.S + u.ctrl_base + ph * u.ctrl_words;
  const int* en = v.P + u.r[A_ENABLES];
  const int l = lane();
  *in_en = __ballot_sync(FULL, l < u.n_in && enable_of(en + 2 * l, tok));
  *out_en = __ballot_sync(FULL, l < u.n_out && enable_of(en + 2 * (u.n_in + l), tok));
}

// can_fire: on true, *in_en and *out_en hold the firing's enables.
template <bool MOE>
__device__ __forceinline__ bool can_fire(const View& v, const Visit& u, unsigned* in_en,
                                         unsigned* out_en) {
  if (u.ready >= 0) {
    if constexpr (MOE)
      if (u.kind == K_ADMISSION) local_wait(v.alast[u.a], v.local_done);
    if (v.S[v.io_scal + 2 * u.scalar] >= u.ready) return false;
  }
  if (u.ctrl >= 0 && occ(v, u.ctrl) < 1) return false;
  rates<MOE>(v, u, in_en, out_en);
  const int l = lane();
  const bool blocked = (((*in_en >> l) & 1) && occ(v, u.fi) < u.rate_i) ||
                       (((*out_en >> l) & 1) && occ(v, u.fo) + u.rate_o > u.bound_o);
  return !__any_sync(FULL, blocked);
}

__device__ int max_fireable(const View& v, const Visit& u) {
  if (u.ctrl >= 0) return min(MAX_FIRINGS_PER_VISIT, occ(v, u.ctrl));
  int k = MAX_FIRINGS_PER_VISIT;
  if (u.fi >= 0) k = min(k, occ(v, u.fi) / u.rate_i);
  if (u.fo >= 0) k = min(k, (u.bound_o - occ(v, u.fo)) / u.rate_o);
  return __reduce_min_sync(FULL, k);
}

// The segments a read (write) at phase ph of a channel with `delay` and
// `rate` covers, *s1 = -1 when only one (ref.py's read_segments /
// write_segments).
__device__ __forceinline__ void read_segments(int delay, int rate, int ph, int* s0,
                                              int* s1) {
  *s0 = delay ? 2 * ph : ph;
  *s1 = delay && rate > 1 ? 2 * ph + 1 : -1;
}
__device__ __forceinline__ void write_segments(int delay, int rate, int ph, int* s0,
                                               int* s1) {
  *s0 = delay ? 2 * ph + 2 : ph;
  *s1 = delay && rate > 1 ? 2 * ph + 1 : -1;
}

// One firing's bookkeeping (fire_actor) by the whole warp, with the
// enables can_fire returned: consume the control token, masked input
// reads, the actor's scalar state, masked output writes, and for a firing
// with a body its wait (hazard_waits in ref.py) as command `seq`.  Fills
// `f`; returns true when the firing has a body for the body threads to run.
// With MOE, an enabled firing of a step actor writes its actor, enables and
// window offsets into the yield words and sets s->error to ERR_YIELD: the
// run stops there, and the runner fires the actor.
template <bool MOE>
__device__ bool fire(const View& v, const Visit& u, unsigned in_en, unsigned out_en,
                     long long seq, Firing* f, Sched* s) {
  const int l = lane();
  const int kind = u.kind, fi = u.fi, fo = u.fo;
  if (u.ctrl >= 0 && l == 0) {
    const int c = u.ctrl;
#ifdef MK_GUARDS
    int t;
    int bits = cursor_bits(v, c, 0, 1, &t);
    if (t < 1) bits |= UNDERFLOW;
    bits |= token_domain_bits(v, c, u.ctrl_base + v.ph[2 * c] * u.ctrl_words);
    if (bits) atomicOr(&v.fault[c], bits);
#endif
    v.S[3 * c] += 1;
    v.S[3 * c + 2] -= 1;
    v.ph[2 * c] = next_phase(v.ph[2 * c], u.ctrl_nph);
  }
  const int in_ph = fi >= 0 ? v.ph[2 * fi] : 0;
  if (fi >= 0) {
#ifdef MK_GUARDS
    {
      const bool e = (in_en >> l) & 1;
      int t;
      int bits = cursor_bits(v, fi, u.delay_i, u.rate_i, &t);
      if (e && t < u.rate_i) bits |= UNDERFLOW;
      // A control channel has rate 1: phase p is slot p.
      if (e && !u.data_i) bits |= token_domain_bits(v, fi, ctrl_word(v, fi, in_ph));
      if (bits) atomicOr(&v.fault[fi], bits);
    }
#endif
    f->in_off = in_ph * u.rate_i;
    if ((in_en >> l) & 1) {
      v.S[3 * fi] += 1;
      v.S[3 * fi + 2] -= u.rate_i;
      v.ph[2 * fi] = next_phase(in_ph, u.nph_i);
    }
  }
  const bool body = u.ctrl < 0 || u.n_in + u.n_out == 0 || (in_en | out_en) != 0;
  int value = 0;
  f->idx = f->n_idx = 0;
  if (body && (kind == K_SOURCE || kind == K_CONFIG || kind == K_SINK)) {
    int* sc = v.S + v.io_scal + 2 * u.scalar;
    const int idx = sc[0], n_idx = sc[1];
    __syncwarp();
    if (kind != K_CONFIG && (idx < 0 || idx >= n_idx)) {
      s->error = ERR_SLAB;
      s->err_actor = u.a;
      s->err_value = idx;
      __syncwarp();
      return false;
    }
    if (l == 0) sc[0] = idx + 1;
    f->idx = idx;
    f->n_idx = n_idx;
    if (kind == K_CONFIG)
      value = __ldg(static_cast<const int*>(aptr(v, u.r[A_PTR0])) +
                    min(max(idx, 0), u.r[A_AUX] - 1));
  }
  __syncwarp();  // input cursors before output cursors: an actor may feed itself
  const int out_ph = fo >= 0 ? v.ph[2 * fo + 1] : 0;
  const bool on = (out_en >> l) & 1;
  bool cb = false;
  if (fo >= 0) {
#ifdef MK_GUARDS
    {
      int t;
      int bits = cursor_bits(v, fo, u.delay_o, u.rate_o, &t);
      if (on && t + u.rate_o > u.bound_o) bits |= OVERFLOW;
      if (on && !u.data_o && body && kind == K_CONFIG) bits |= domain_bit(v, fo, value);
      if (bits) atomicOr(&v.fault[fo], bits);
      // One port writes a channel: this lane alone marks it.
      const int mark = t + (on ? u.rate_o : 0);
      if (mark > v.hw[fo]) v.hw[fo] = mark;
    }
#endif
    const int off = out_ph * u.rate_o + u.delay_o;
    f->out_off = off;
    if (!u.data_o) {
      if (body && on && kind == K_CONFIG) v.S[v.io_ctrl + u.cbase_o + off] = value;
    } else {
      cb = on && u.delay_o && out_ph == 2;  // Fig. 2
    }
    if (on) {
      v.S[3 * fo + 1] += 1;
      v.S[3 * fo + 2] += u.rate_o;
      v.ph[2 * fo + 1] = next_phase(out_ph, u.nph_o);
    }
  }
  if (l == 0) v.S[v.io_counts + u.a] += 1;
  f->cb_mask = __ballot_sync(FULL, cb);
  f->in_en = in_en;
  f->out_en = out_en;
  if (!body || kind == K_CONFIG) {
    __syncwarp();
    return false;
  }
  if constexpr (MOE) {
    if (kind == K_STEP) {
      int* y = v.S + v.io_counts + v.P[H_N_ACTORS];
      if (fi >= 0) y[Y_OFF + l] = f->in_off;
      if (fo >= 0) y[Y_OFF + MAX_STEP_PORTS + l] = f->out_off;
      if (l == 0) {
        y[Y_ACTOR] = u.a;
        y[Y_IN_EN] = static_cast<int>(in_en);
        y[Y_OUT_EN] = static_cast<int>(out_en);
      }
      s->error = ERR_YIELD;  // in every lane: the scheduler is replicated per lane
      __syncwarp();
      return false;
    }
  }

  // What the body touches: every input window (an adder only its enabled
  // terms), every enabled data output window, and slot 0 on a copy-back.
  int r0 = -1, r1 = -1, w0 = -1, w1 = -1;
  if (fi >= 0 && u.data_i && (kind != K_ADDER || ((in_en >> l) & 1)))
    read_segments(u.delay_i, u.rate_i, in_ph, &r0, &r1);
  if (fo >= 0 && on && u.data_o) write_segments(u.delay_o, u.rate_o, out_ph, &w0, &w1);
  long long w = 0;
  if (r0 >= 0) w = max(w, last_writer(v, fi, r0));
  if (r1 >= 0) w = max(w, last_writer(v, fi, r1));
  if (w0 >= 0) w = max(w, max(last_writer(v, fo, w0), last_reader(v, fo, w0)));
  if (w1 >= 0) w = max(w, max(last_writer(v, fo, w1), last_reader(v, fo, w1)));
  if (cb) w = max(w, max(last_writer(v, fo, 0), last_reader(v, fo, 0)));
  w = warp_max(w);  // every wait is read before this command's own segments count
  if (r0 >= 0) last_reader(v, fi, r0) = seq;
  if (r1 >= 0) last_reader(v, fi, r1) = seq;
  if (w0 >= 0) last_writer(v, fo, w0) = seq;
  if (w1 >= 0) last_writer(v, fo, w1) = seq;
  if (cb) last_writer(v, fo, 0) = seq;
  if constexpr (MOE) {
    // Admission's body writes its control tokens and its ready scalar:
    // their readers wait for this command (ctrl_wait, local_wait).
    if (kind == K_ADMISSION) {
      if (fo >= 0 && on && !u.data_o) last_writer(v, fo, out_ph) = seq;
      if (l == 0) v.alast[u.a] = seq;
    }
  }
  __syncwarp();
  f->wait_for = w;
  return true;
}

// ---- the wide path: the MoE kinds, up to 256 ports a side -------------- //
// The router has 3E + 2 outputs, the combine E + 2 inputs, the packer E.
// Lane l takes ports l, l + 32, ...; the rules are the narrow path's, port
// by port, on delay-free channels (program.py checks), whose window at
// phase p is segment p.  A firing becomes `phases` commands (PHASES in
// program.py), numbered seq .. seq + phases - 1: the first waits for the
// conflicts (and for the actor's previous firing, which shares its
// scratch), each later one for the one before it, and the firing's
// segments count from the last.

// The wide actor's enables, word w of each side for ports 32 w .. 32 w + 31.
__device__ void wide_rates(const View& v, const Visit& u, unsigned* in_en,
                           unsigned* out_en) {
  const int l = lane();
  const int* tok = nullptr;
  const int* en = nullptr;
  if (u.ctrl >= 0) {
    const int ph = v.ph[2 * u.ctrl];
    ctrl_wait(&last_writer(v, u.ctrl, ph), &last_reader(v, u.ctrl, ph), v.local_done);
    tok = v.S + u.ctrl_base + ph * u.ctrl_words;
    en = v.P + u.r[A_ENABLES];
  }
  for (int w = 0; w < WIDE_WORDS; ++w) {
    const int p = 32 * w + l;
    in_en[w] = __ballot_sync(FULL, p < u.n_in && (en == nullptr || enable_of(en + 2 * p, tok)));
    out_en[w] = __ballot_sync(
        FULL, p < u.n_out && (en == nullptr || enable_of(en + 2 * (u.n_in + p), tok)));
  }
}

__device__ bool can_fire_wide(const View& v, const Visit& u, unsigned* in_en,
                              unsigned* out_en) {
  if (u.ready >= 0 && v.S[v.io_scal + 2 * u.scalar] >= u.ready) return false;
  if (u.ctrl >= 0 && occ(v, u.ctrl) < 1) return false;
  wide_rates(v, u, in_en, out_en);
  bool blocked = false;
  for (int p = lane(); p < u.n_in; p += 32) {
    const int f = v.P[u.r[A_IN] + p];
    if (bit_of(in_en, p) && occ(v, f) < fifo_row(v, f)[F_RATE]) blocked = true;
  }
  for (int p = lane(); p < u.n_out; p += 32) {
    const int f = v.P[u.r[A_OUT] + p];
    const int* fr = fifo_row(v, f);
    if (bit_of(out_en, p) && occ(v, f) + fr[F_RATE] > fr[F_BOUND]) blocked = true;
  }
  return !__any_sync(FULL, blocked);
}

__device__ __noinline__ int max_fireable_wide(const View v, const Visit u) {
  if (u.ctrl >= 0) return min(MAX_FIRINGS_PER_VISIT, occ(v, u.ctrl));
  int k = MAX_FIRINGS_PER_VISIT;
  for (int p = lane(); p < u.n_in; p += 32) {
    const int f = v.P[u.r[A_IN] + p];
    k = min(k, occ(v, f) / fifo_row(v, f)[F_RATE]);
  }
  for (int p = lane(); p < u.n_out; p += 32) {
    const int f = v.P[u.r[A_OUT] + p];
    const int* fr = fifo_row(v, f);
    k = min(k, (fr[F_BOUND] - occ(v, f)) / fr[F_RATE]);
  }
  return __reduce_min_sync(FULL, k);
}

// fire for the wide path: the bookkeeping of fire(), port by port; a body
// writing a control output records its last command as that token's
// writer (ctrl_wait).  Fills f; returns whether the firing has a body.
__device__ bool fire_wide(const View& v, const Visit& u, const unsigned* in_en,
                          const unsigned* out_en, long long seq, Firing* f) {
  const int l = lane();
  const int* r = u.r;
  const int phases = u.kind == K_ROUTER || u.kind == K_EXPERT ? 2 : 1;
  if (u.ctrl >= 0 && l == 0) {
    const int c = u.ctrl;
#ifdef MK_GUARDS
    int t;
    int bits = cursor_bits(v, c, 0, 1, &t);
    if (t < 1) bits |= UNDERFLOW;
    bits |= token_domain_bits(v, c, u.ctrl_base + v.ph[2 * c] * u.ctrl_words);
    if (bits) atomicOr(&v.fault[c], bits);
#endif
    v.S[3 * c] += 1;
    v.S[3 * c + 2] -= 1;
    v.ph[2 * c] = next_phase(v.ph[2 * c], u.ctrl_nph);
  }
  __syncwarp();
  long long w = v.alast[u.a];
  for (int k = 0; k < WIDE_WORDS; ++k) {
    const int p = 32 * k + l;
    bool ph_bit = false;
    if (p < u.n_in) {
      const int fi = v.P[r[A_IN] + p];
      const int* fr = fifo_row(v, fi);
      const bool e = (in_en[k] >> l) & 1;
      const int ph = v.ph[2 * fi];
#ifdef MK_GUARDS
      {
        int t;
        int bits = cursor_bits(v, fi, fr[F_DELAY], fr[F_RATE], &t);
        if (e && t < fr[F_RATE]) bits |= UNDERFLOW;
        if (bits) atomicOr(&v.fault[fi], bits);
      }
#endif
      ph_bit = ph & 1;
      if (!fr[F_CTRL]) w = max(w, last_writer(v, fi, ph));
      if (e) {
        v.S[3 * fi] += 1;
        v.S[3 * fi + 2] -= fr[F_RATE];
        v.ph[2 * fi] = next_phase(ph, fr[F_NPH]);
      }
    }
    const unsigned bits = __ballot_sync(FULL, ph_bit);
    if (l == 0) v.wide[2 * WIDE_WORDS + k] = bits;
  }
  __syncwarp();  // input cursors before output cursors
  for (int k = 0; k < WIDE_WORDS; ++k) {
    const int p = 32 * k + l;
    bool ph_bit = false;
    if (p < u.n_out) {
      const int fo = v.P[r[A_OUT] + p];
      const int* fr = fifo_row(v, fo);
      const bool on = (out_en[k] >> l) & 1;
      const int ph = v.ph[2 * fo + 1];
#ifdef MK_GUARDS
      {
        int t;
        int bits = cursor_bits(v, fo, fr[F_DELAY], fr[F_RATE], &t);
        if (on && t + fr[F_RATE] > fr[F_BOUND]) bits |= OVERFLOW;
        if (bits) atomicOr(&v.fault[fo], bits);
        const int mark = t + (on ? fr[F_RATE] : 0);
        if (mark > v.hw[fo]) v.hw[fo] = mark;
      }
#endif
      ph_bit = ph & 1;
      if (on && !fr[F_CTRL]) w = max(w, max(last_writer(v, fo, ph), last_reader(v, fo, ph)));
      if (on) {
        v.S[3 * fo + 1] += 1;
        v.S[3 * fo + 2] += fr[F_RATE];
        v.ph[2 * fo + 1] = next_phase(ph, fr[F_NPH]);
      }
    }
    const unsigned bits = __ballot_sync(FULL, ph_bit);
    if (l == 0) v.wide[3 * WIDE_WORDS + k] = bits;
  }
  if (l == 0) v.S[v.io_counts + u.a] += 1;
  unsigned any = 0;
  for (int k = 0; k < WIDE_WORDS; ++k) {
    if (l == 0) {
      v.wide[k] = in_en[k];
      v.wide[WIDE_WORDS + k] = out_en[k];
    }
    any |= in_en[k] | out_en[k];
  }
  __syncwarp();
  f->cb_mask = 0;
  f->idx = f->n_idx = 0;
  f->phases = phases;
  if (u.ctrl >= 0 && !any) {
    __syncwarp();
    return false;
  }
  w = warp_max(w);  // every wait is read before this command's own segments count
  const long long last = seq + phases - 1;
  for (int k = 0; k < WIDE_WORDS; ++k) {
    const int p = 32 * k + l;
    if (p < u.n_in) {
      const int fi = v.P[r[A_IN] + p];
      if (!fifo_row(v, fi)[F_CTRL])
        last_reader(v, fi, (v.wide[2 * WIDE_WORDS + k] >> l) & 1) = last;
    }
    if (p < u.n_out && ((out_en[k] >> l) & 1))
      last_writer(v, v.P[r[A_OUT] + p], (v.wide[3 * WIDE_WORDS + k] >> l) & 1) = last;
  }
  if (phases > 1 && l == 0) v.alast[u.a] = last;
  __syncwarp();
  f->wait_for = w;
  return true;
}

// One attempt of the wide path, out of line and given its operands by
// value, so that the narrow path's scheduler state stays in registers:
// -1 when the actor cannot fire, else whether the firing it made has a
// body; the firing's wait goes to View::wide_wait.
__device__ __noinline__ int wide_try(const View v, const Visit u, long long seq) {
  unsigned in_en[WIDE_WORDS], out_en[WIDE_WORDS];
  if (!can_fire_wide(v, u, in_en, out_en)) return -1;
  Firing f;
  const bool body = fire_wide(v, u, in_en, out_en, seq, &f);
  if (lane() == 0) *v.wide_wait = f.wait_for;
  __syncwarp();
  return body ? 1 : 0;
}

#ifdef MK_TRACE
// `times` events of the firing trace for actor a (the skipped attempts left
// in a visit repeat one): block 0's scheduler warp writes [a, sweep, fired,
// every channel's occupancy] at the count modulo the capacity.
__device__ void trace_event(const View& v, Sched* s, int a, int fired, int times) {
  if (blockIdx.x == 0) {
    const int width = 3 + v.n_fifos;
    for (int t = 0; t < times; ++t) {
      int* row = v.trace + (s->events + t) % v.trace_cap * width;
      if (lane() == 0) {
        row[0] = a;
        row[1] = s->sweeps;
        row[2] = fired;
      }
      for (int f = lane(); f < v.n_fifos; f += 32) row[3 + f] = v.S[3 * f + 2];
    }
  }
  s->events += times;
  __syncwarp();
}
#endif

// Advance the sweep loop (run_dynamic) to the next firing with a body, or
// to its end: returns true with the visited actor in *u and the firing in
// *f, or false at the end of the run.
// MOE: the program has MoE kinds (H_MOE); without, the wide path and the
// waits on body-written control tokens are compiled out.
template <bool MOE>
__device__ __forceinline__ bool schedule_next(const View& v, Visit* u, Firing* f, Sched* s,
                                              int max_sweeps, int multi_firing) {
  const int* visit = v.P + v.P[H_VISIT_OFF];
  const int n_visit = v.P[H_N_VISIT];
  for (;;) {
    if (s->vpos < 0) {  // between sweeps: `while fired_any and sweeps < max`
      if (!s->fired_any || s->sweeps >= max_sweeps) {
        s->stalled = s->fired_any && s->sweeps >= max_sweeps;
        return false;
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
    bool wide_actor = false;
    if (s->left < 0) {
      visit_actor(v, visit[s->vpos], u);
      if constexpr (MOE) wide_actor = u->wide;
      s->left = !multi_firing ? 1 : (wide_actor ? max_fireable_wide(v, *u) : max_fireable(v, *u));
    }
    if constexpr (MOE) wide_actor = u->wide;
    unsigned in_en, out_en;
    // The wide path fires in its attempt: -1 could not, 0 / 1 fired.
    int wide = -1;
    if constexpr (MOE)
      if (s->left > 0 && wide_actor) wide = wide_try(v, *u, s->seq + 1);
    const bool ok = s->left > 0 && (wide_actor ? wide >= 0 : can_fire<MOE>(v, *u, &in_en, &out_en));
    if (!ok) {
#ifdef MK_TRACE
      if (s->left > 0) trace_event(v, s, u->a, 0, s->left);
#endif
      s->vpos += 1;
      s->left = -1;
      continue;
    }
    s->left -= 1;
    s->fired_any = 1;
    bool body;
    if (wide_actor) {
      body = wide == 1;
      f->phases = u->kind == K_ROUTER || u->kind == K_EXPERT ? 2 : 1;
      f->wait_for = *v.wide_wait;
      f->cb_mask = 0;
    } else {
      f->phases = 1;
      body = fire<MOE>(v, *u, in_en, out_en, s->seq + 1, f, s);
    }
    if (s->error) {
#ifdef MK_TRACE
      if (s->error == ERR_YIELD) trace_event(v, s, u->a, 1, 1);  // the step's attempt
#endif
      return false;
    }
#ifdef MK_TRACE
    trace_event(v, s, u->a, 1, 1);
#endif
    if (body) {
      s->seq += f->phases;
      return true;
    }
  }
}

// Command slot c for firing f of the visited actor (number s->seq), by the
// scheduler warp side by side: lane l fills input l, output l and adder
// term l, and the body's parameters are spread over the first lanes.
// The wide path's command, out of line with its operands by value: command
// `first + phase` of a firing whose first command waits for `wait_for`.
__device__ __noinline__ void fill_wide(const View v, const int* r, int kind, int n_in,
                                       int n_out, long long first, long long wait_for,
                                       int phase, Cmd* c) {
  const int l = lane();
  if (l < WIDE_WORDS) {
    c->wen_in[l] = v.wide[l];
    c->wen_out[l] = v.wide[WIDE_WORDS + l];
    c->wph_in[l] = v.wide[2 * WIDE_WORDS + l];
    c->wph_out[l] = v.wide[3 * WIDE_WORDS + l];
  }
  if (l == 0) {
    c->seq = first + phase;
    c->wait_for = phase == 0 ? wait_for : first + phase - 1;
    c->kind = kind;
    c->row = r;
    c->phase = phase;
    c->n_in = n_in;
    c->n_out = n_out;
    c->cb_mask = 0;
    c->in_en = v.wide[0];
    c->out_en = v.wide[WIDE_WORDS];
  }
}

template <bool MOE>
__device__ __forceinline__ void fill(const View& v, const Visit& u, const Firing& f,
                                     const Sched* s, int phase, Cmd* c) {
  const int l = lane();
  const int* r = u.r;
  if constexpr (MOE) {
    if (u.wide) {
      fill_wide(v, r, u.kind, u.n_in, u.n_out, s->seq - f.phases + 1, f.wait_for, phase, c);
      return;
    }
  }
  if (u.fi >= 0) c->in[l] = u.ring_i + static_cast<long long>(f.in_off) * u.tokb_i;
  if (u.fo >= 0) {
    c->out[l] = u.data_o ? u.ring_o + static_cast<long long>(f.out_off) * u.tokb_o : nullptr;
    if ((f.cb_mask >> l) & 1) {
      c->slot0[l] = u.ring_o;
      c->cb_from[l] = static_cast<long long>(u.rate_o - 1) * u.tokb_o;
    }
  }
  if (u.kind == K_ADDER && l < r[A_NAUX]) c->terms[l] = v.P[r[A_AUX] + l];
  if constexpr (MOE) {
    if (u.kind == K_ADMISSION && u.fo >= 0 && !u.data_o)
      c->terms[l] = v.io_ctrl + u.cbase_o + f.out_off * (u.tokb_o >> 2);
    if (l == 7) c->row = r;
  }
#ifdef MK_GUARDS
  {
    const int ei = u.fi >= 0 && u.data_i ? fifo_row(v, u.fi)[F_ELEM] : -1;
    const int eo = u.fo >= 0 && u.data_o ? fifo_row(v, u.fo)[F_ELEM] : -1;
    const unsigned in_fl = __ballot_sync(FULL, ei == ELEM_F32 || is_half(ei));
    const unsigned in_h = __ballot_sync(FULL, is_half(ei));
    const unsigned in_hf = __ballot_sync(FULL, ei == ELEM_F16);
    const unsigned out_fl = __ballot_sync(FULL, eo == ELEM_F32);
    const unsigned out_h = __ballot_sync(FULL, is_half(eo));
    const unsigned out_hf = __ballot_sync(FULL, eo == ELEM_F16);
    if (u.fi >= 0) c->in_f[l] = u.fi;
    if (u.fo >= 0) c->out_f[l] = u.fo;
    if (l == 6) {
      c->in_fl = in_fl;
      c->in_h = in_h;
      c->in_hf = in_hf;
      c->out_fl = out_fl;
      c->out_h = out_h;
      c->out_hf = out_hf;
    }
  }
#endif
  switch (l) {
    case 0:
      c->seq = s->seq;
      c->wait_for = f.wait_for;
      c->kind = u.kind;
      // bytes of input 0's window (fork, adder, gauss, thres, med)
      if (u.n_in > 0) c->win = static_cast<long long>(u.rate_i) * u.tokb_i;
      break;
    case 1:
      c->cb_mask = f.cb_mask;
      c->in_en = f.in_en;
      c->out_en = f.out_en;
      break;
    case 2:
      c->n_in = u.n_in;
      c->n_out = u.n_out;
      c->n_terms = r[A_NAUX];
      break;
    case 3:
      c->n0 = r[A_N0];
      c->n1 = r[A_N1];
      c->planes = r[A_PLANES];
      break;
    case 4:
      c->order = r[A_ORDER];
      c->fparam = __int_as_float(r[A_FPARAM]);
      break;
    case 5:
      if (u.kind == K_POLY) {
        c->hist = static_cast<float*>(aptr(v, r[A_PTR0]));
        c->taps = static_cast<const float*>(aptr(v, r[A_PTR1]));
      } else if (u.kind == K_SOURCE || u.kind == K_SINK) {
        // Plane p of window idx sits at p * stride + idx * plane_bytes.
        const long long plane_bytes = r[A_N0];
        c->slab = static_cast<unsigned char*>(aptr(v, r[A_PTR0])) + f.idx * plane_bytes;
        c->slab_stride = static_cast<long long>(f.n_idx) * plane_bytes;
      }
      break;
  }
}

// The scheduler warp: every command, then CMD_DONE, into the slot ring.
// Returns its cycles deciding and filling | waiting for a free slot << 32
// (counted with -DMK_CLOCK_SPLIT only).
template <bool MOE>
__device__ long long scheduler(const View& v, Cmd* slots, uint64_t* full, uint64_t* empty,
                               Sched* s, int max_sweeps, int multi_firing) {
  Visit u;
  // A resumed run stopped inside a visit: load the visited actor again.
  if (s->vpos >= 0 && s->vpos < v.P[H_N_VISIT] && s->left >= 0)
    visit_actor(v, v.P[v.P[H_VISIT_OFF] + s->vpos], &u);
  long long busy = 0, full_wait = 0;
  for (long long n = 0;;) {
#ifdef MK_CLOCK_SPLIT
    const long long t0 = clock64();
#endif
    Firing f;
    const bool more = schedule_next<MOE>(v, &u, &f, s, max_sweeps, multi_firing);
#ifdef MK_CLOCK_SPLIT
    const long long t1 = clock64();
    busy += t1 - t0;
#endif
    // A firing of a multi-phase kind becomes one command per phase.
    const int phases = MOE && more ? f.phases : 1;
    for (int ph = 0; ph < phases; ++ph, ++n) {
      const int i = static_cast<int>(n % RING);
#ifdef MK_CLOCK_SPLIT
      const long long t1b = clock64();
#endif
      mbar_wait(&empty[i], static_cast<uint32_t>((n / RING) & 1) ^ 1);
#ifdef MK_CLOCK_SPLIT
      const long long t2 = clock64();
#endif
      if (more)
        fill<MOE>(v, u, f, s, ph, &slots[i]);
      else if (lane() == 0)
        slots[i].kind = CMD_DONE;
      __syncwarp();
      if (lane() == 0) mbar_arrive(&full[i]);
#ifdef MK_CLOCK_SPLIT
      busy += clock64() - t2;
      full_wait += t2 - t1b;
#endif
    }
    if (!more) return (busy & 0xffffffffLL) | (full_wait << 32);
  }
}

// The publisher warp: once this block's body threads have run command k
// (every body warp arrived on its slot's `done`), publish k and free the
// slot.  Off the body threads' path, so a command that waits for nothing
// starts while the one before it is still being published.
// With MOE it also keeps *local_done, this block's own progress, for the
// scheduler's ctrl_wait.
template <bool MOE>
__device__ void publisher(const Cmd* slots, uint64_t* done, uint64_t* empty,
                          unsigned long long* progress, long long* local_done) {
  for (long long n = 0;; ++n) {
    const int i = static_cast<int>(n % RING);
    mbar_wait(&done[i], static_cast<uint32_t>((n / RING) & 1));
    if (slots[i].kind == CMD_DONE) return;
    if (lane() == 0) {
      const long long seq = slots[i].seq;
      publish(progress + blockIdx.x, seq);
      mbar_arrive(&empty[i]);
      if constexpr (MOE) store_release_cta(local_done, seq);
    }
    __syncwarp();
  }
}

// ---- the body threads -------------------------------------------------- //
__device__ __forceinline__ long long grid_first() {
  return static_cast<long long>(blockIdx.x) * BODY_THREADS + threadIdx.x;
}
__device__ __forceinline__ long long grid_step() {
  return static_cast<long long>(gridDim.x) * BODY_THREADS;
}

// Store word x at byte b of output o's window.  CB_COPY is set only for a
// firing with a delay channel's enabled phase-2 write (cmd.cb_mask != 0):
// then x also goes to its slot-0 place when o is that channel and b lies in
// the window's last token (the Fig. 2 copy-back).  Every other firing runs
// bodies without it, whose stores test nothing.  CB_DOM (the MK_GUARDS
// build, a command with an output that declares a domain) tests each word
// stored against its channel's domain.
enum { CB_COPY = 1, CB_DOM = 2 };
#ifdef MK_GUARDS
// Bit k: input k's (output k's) window held a NaN or an Inf (bad_in,
// bad_out), or an element outside its channel's domain (dom_in, dom_out),
// in the command the block is running.
__shared__ unsigned bad_in, bad_out, dom_in, dom_out;
// The channel rows (this block's replica of the program), for the body
// threads' DOMAIN tests, and whether any data channel declares a domain
// (H_DOM): without one, no command pays for the tests.
__shared__ const int* dom_rows;
__shared__ int dom_any;

// Whether a word of float32 tokens holds a NaN or an Inf (every exponent
// bit set).  float32 channels move words of 4 or 16 bytes (their addresses
// and windows are multiples of 4); 1- and 2-byte words are u8 or half tokens.
__device__ __forceinline__ bool nonfinite(unsigned x) {
  return (x & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ bool nonfinite(float x) { return nonfinite(__float_as_uint(x)); }
__device__ __forceinline__ bool nonfinite(uint4 x) {
  return nonfinite(x.x) || nonfinite(x.y) || nonfinite(x.z) || nonfinite(x.w);
}
__device__ __forceinline__ bool nonfinite(float4 x) {
  return nonfinite(x.x) || nonfinite(x.y) || nonfinite(x.z) || nonfinite(x.w);
}
__device__ __forceinline__ bool nonfinite(unsigned short) { return false; }
__device__ __forceinline__ bool nonfinite(unsigned char) { return false; }

// The same for a word of bf16 or f16 tokens, e the exponent bits of one
// (half_exp): its 16-bit halves tested on their own.  Half channels' words
// are 2, 4 or 16 bytes (their addresses and windows are even).
__device__ __forceinline__ unsigned half_exp(int elem) {
  return elem == ELEM_F16 ? 0x7c00u : 0x7f80u;
}
__device__ __forceinline__ bool nonfinite_h(unsigned short x, unsigned e) {
  return (x & e) == e;
}
__device__ __forceinline__ bool nonfinite_h(unsigned x, unsigned e) {
  return (x & e) == e || ((x >> 16) & e) == e;
}
__device__ __forceinline__ bool nonfinite_h(float x, unsigned e) {
  return nonfinite_h(__float_as_uint(x), e);
}
__device__ __forceinline__ bool nonfinite_h(uint4 x, unsigned e) {
  return nonfinite_h(x.x, e) || nonfinite_h(x.y, e) || nonfinite_h(x.z, e) ||
         nonfinite_h(x.w, e);
}
__device__ __forceinline__ bool nonfinite_h(float4 x, unsigned e) {
  return nonfinite_h(x.x, e) || nonfinite_h(x.y, e) || nonfinite_h(x.z, e) ||
         nonfinite_h(x.w, e);
}
__device__ __forceinline__ bool nonfinite_h(unsigned char, unsigned) { return false; }

// A bf16 or f16 token's float32 value.
__device__ __forceinline__ float half_value(unsigned h, int elem) {
  return elem == ELEM_F16 ? __half2float(__ushort_as_half(static_cast<unsigned short>(h)))
                          : __uint_as_float(h << 16);
}

// Whether a word of a channel with a declared domain (row fr) holds an
// element outside [lo, hi], compared as health.py compares it: lo <= x <= hi
// fails for a NaN too.  A 4-byte word of a u8 channel holds four tokens, of
// a half channel two (each widened to float32: its bounds are rounded to
// its type, so the comparison is the one in that type).
__device__ __forceinline__ bool out_of_domain_f(float x, const int* fr) {
  return !(x >= __int_as_float(fr[F_DLO]) && x <= __int_as_float(fr[F_DHI]));
}
__device__ __forceinline__ bool out_of_domain(unsigned w, const int* fr) {
  if (fr[F_ELEM] == ELEM_F32) return out_of_domain_f(__uint_as_float(w), fr);
  if (is_half(fr[F_ELEM]))
    return out_of_domain_f(half_value(w & 0xffffu, fr[F_ELEM]), fr) ||
           out_of_domain_f(half_value(w >> 16, fr[F_ELEM]), fr);
  if (fr[F_ELEM] == ELEM_I32) {
    const int x = static_cast<int>(w);
    return x < fr[F_DLO] || x > fr[F_DHI];
  }
  bool bad = false;
  for (int i = 0; i < 4; ++i) {
    const int x = static_cast<int>((w >> (8 * i)) & 0xffu);
    bad |= x < fr[F_DLO] || x > fr[F_DHI];
  }
  return bad;
}
__device__ __forceinline__ bool out_of_domain(unsigned char x, const int* fr) {
  return x < fr[F_DLO] || x > fr[F_DHI];
}
// A 2-byte word: one half token, or two u8 ones.
__device__ __forceinline__ bool out_of_domain(unsigned short x, const int* fr) {
  if (is_half(fr[F_ELEM])) return out_of_domain_f(half_value(x, fr[F_ELEM]), fr);
  return out_of_domain(static_cast<unsigned char>(x & 0xffu), fr) ||
         out_of_domain(static_cast<unsigned char>(x >> 8), fr);
}
__device__ __forceinline__ bool out_of_domain(float x, const int* fr) {
  return out_of_domain(__float_as_uint(x), fr);
}
__device__ __forceinline__ bool out_of_domain(uint4 x, const int* fr) {
  return out_of_domain(x.x, fr) || out_of_domain(x.y, fr) || out_of_domain(x.z, fr) ||
         out_of_domain(x.w, fr);
}
__device__ __forceinline__ bool out_of_domain(float4 x, const int* fr) {
  return out_of_domain(make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                                  __float_as_uint(x.z), __float_as_uint(x.w)), fr);
}
#endif

template <int CB, typename T>
__device__ __forceinline__ void put(const Cmd& c, int o, long long b, T x) {
#ifdef MK_GUARDS
  if (((c.out_fl >> o) & 1) && nonfinite(x)) atomicOr(&bad_out, 1u << o);
  if (((c.out_h >> o) & 1) &&
      nonfinite_h(x, ((c.out_hf >> o) & 1) ? half_exp(ELEM_F16) : half_exp(ELEM_BF16)))
    atomicOr(&bad_out, 1u << o);
  if constexpr ((CB & CB_DOM) != 0) {
    const int* fr = dom_rows + FIFO_FIELDS * c.out_f[o];
    if (fr[F_DOM] && out_of_domain(x, fr)) atomicOr(&dom_out, 1u << o);
  }
#endif
  *reinterpret_cast<T*>(c.out[o] + b) = x;
  if ((CB & CB_COPY) && ((c.cb_mask >> o) & 1) && b >= c.cb_from[o])
    *reinterpret_cast<T*>(c.slot0[o] + (b - c.cb_from[o])) = x;
}

// The widest word (16, 4, 2 or 1 bytes) that every address and length in
// `bits` allows.  A bf16 or f16 window is never moved a byte at a time, so
// the guards see whole tokens.
__device__ __forceinline__ int word_bytes(unsigned long long bits) {
  return (bits & 15) == 0 ? 16 : (bits & 3) == 0 ? 4 : (bits & 1) == 0 ? 2 : 1;
}

// n bytes of src to byte `at` of every enabled output window.
template <int CB, typename T>
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

template <int CB>
__device__ void fan_out(const Cmd& c, const unsigned char* src, long long n, long long at) {
  unsigned long long bits = reinterpret_cast<uintptr_t>(src) | n | at;
  for (int o = 0; o < c.n_out; ++o) {
    if (!((c.out_en >> o) & 1)) continue;
    bits |= reinterpret_cast<uintptr_t>(c.out[o]);
    if ((CB & CB_COPY) && ((c.cb_mask >> o) & 1))
      bits |= reinterpret_cast<uintptr_t>(c.slot0[o]) | c.cb_from[o];
  }
  switch (word_bytes(bits)) {
    case 16: fan_out_words<CB, uint4>(c, src, n, at); break;
    case 4: fan_out_words<CB, unsigned int>(c, src, n, at); break;
    case 2: fan_out_words<CB, unsigned short>(c, src, n, at); break;
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
    case 2: copy_words<unsigned short>(dst, src, n); break;
    default: copy_words<unsigned char>(dst, src, n); break;
  }
}

template <int CB>
__device__ void run_poly(const Cmd& c, float* sb_re, float* sb_im, float* sh_re,
                         float* sh_im) {
  const int L = c.n0;
  const float* win_re = reinterpret_cast<const float*>(c.in[0]);
  const float* win_im = win_re + L;
  const bool write = c.out_en & 1;
  float* hist_re = c.hist;
  float* hist_im = c.hist + HALO;
  const int tid = threadIdx.x;
  const int n_tiles = (L + BODY_THREADS - 1) / BODY_THREADS;
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;
  if (tid < N_TAPS) {
    sh_re[tid] = __ldcg(c.taps + tid);
    sh_im[tid] = __ldcg(c.taps + N_TAPS + tid);
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * BODY_THREADS;
    float nr = 0.f, ni = 0.f;
    if (tile == 0 && tid < HALO) {
      // Next history: stream samples L .. L + 8 of hist ++ window.
      const int g = L + tid;
      nr = g < HALO ? __ldcg(hist_re + g) : __ldcg(win_re + g - HALO);
      ni = g < HALO ? __ldcg(hist_im + g) : __ldcg(win_im + g - HALO);
    }
    for (int j = tid; j < BODY_THREADS + HALO; j += BODY_THREADS) {
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
    body_sync();
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
    body_sync();
  }
}

// A stencil over every u8 frame of the window: out pixel (y, x) of a frame
// is px(at, y, x, H, W) with at(dy, dx) the pixel at that offset (px
// clamps the offsets it needs clamped).  The window's rows (frames
// stacked) are split evenly over the blocks; a block stages its rows with
// a 2-row halo (a clamped row never leaves it) in shared memory as floats,
// TILE_FLOATS at a time, so each pixel is converted once, and computes
// from there.  Rows too wide for the tile read their neighbours from L2.
// Motion detection's bodies stay out of line, so DPD's bodies keep their
// code compact in the command loop.
template <int CB, typename Px>
__device__ __noinline__ void run_stencil(const Cmd& c, Px px, float* tile) {
  const int H = c.n0, W = c.n1, n_out = c.n_out;
  const unsigned out_en = c.out_en;
  const int rows = static_cast<int>(c.win / W);
  const int tid = threadIdx.x;
  const int max_chunk = TILE_FLOATS / W - 4;
  if (max_chunk < 1) {
    for (long long j = grid_first(); j < c.win; j += grid_step()) {
      const int g = static_cast<int>(j / W), x = static_cast<int>(j - static_cast<long long>(g) * W);
      const unsigned char* at0 = c.in[0] + j;
      auto at = [&](int dy, int dx) {
        return static_cast<float>(__ldcg(at0 + static_cast<long long>(dy) * W + dx));
      };
      const unsigned char u = motion::to_u8(px(at, g % H, x, H, W));
      for (int o = 0; o < c.n_out; ++o)
        if ((c.out_en >> o) & 1) put<CB, unsigned char>(c, o, j, u);
    }
    return;
  }
  const int per_block = (rows + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per_block;
  const int last = min(first + per_block, rows);
  for (int r0 = first; r0 < last; r0 += max_chunk) {
    const int r1 = min(r0 + max_chunk, last);
    const int s0 = max(r0 - 2, 0), s1 = min(r1 + 2, rows);
    const unsigned char* src = c.in[0] + static_cast<long long>(s0) * W;
    const int n = (s1 - s0) * W;
    if (((reinterpret_cast<uintptr_t>(src) | n) & 15) == 0) {
      for (int j = tid; j < n / 16; j += BODY_THREADS) {
        const uint4 w = __ldcg(reinterpret_cast<const uint4*>(src) + j);
        float4* d = reinterpret_cast<float4*>(tile) + 4 * j;
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          d[k] = make_float4(static_cast<float>(words[k] & 255u),
                             static_cast<float>((words[k] >> 8) & 255u),
                             static_cast<float>((words[k] >> 16) & 255u),
                             static_cast<float>(words[k] >> 24));
      }
    } else {
      for (int j = tid; j < n; j += BODY_THREADS) tile[j] = static_cast<float>(__ldcg(src + j));
    }
    body_sync();
    // Pixel p = tid + k * BODY_THREADS of the chunk, walked without dividing.
    int g = r0 + tid / W, x = tid % W, y = g % H;
    for (int p = tid; p < (r1 - r0) * W; p += BODY_THREADS) {
      const float* at0 = tile + (g - s0) * W + x;
      auto at = [&](int dy, int dx) { return at0[dy * W + dx]; };
      const unsigned char u = motion::to_u8(px(at, y, x, H, W));
      const long long b = static_cast<long long>(g) * W + x;
      for (int o = 0; o < n_out; ++o)
        if ((out_en >> o) & 1) put<CB, unsigned char>(c, o, b, u);
      for (x += BODY_THREADS; x >= W; x -= W) {
        ++g;
        y = y + 1 == H ? 0 : y + 1;
      }
    }
    body_sync();
  }
}

// The Thres actor on 4 pixels packed in a word.
__device__ __forceinline__ unsigned thres4(unsigned cur, unsigned prev, float threshold) {
  unsigned out = 0;
#pragma unroll
  for (int k = 0; k < 32; k += 8) {
    const float a = static_cast<float>((cur >> k) & 255u);
    const float b = static_cast<float>((prev >> k) & 255u);
    out |= static_cast<unsigned>(motion::to_u8(motion::thres_px(a, b, threshold))) << k;
  }
  return out;
}

template <int CB>
__device__ __noinline__ void run_thres(const Cmd& c) {
  unsigned long long bits = reinterpret_cast<uintptr_t>(c.in[0]) |
                            reinterpret_cast<uintptr_t>(c.in[1]) |
                            reinterpret_cast<uintptr_t>(c.out[0]) | c.win;
  if ((CB & CB_COPY) && (c.cb_mask & 1))
    bits |= reinterpret_cast<uintptr_t>(c.slot0[0]) | c.cb_from[0];
  if ((bits & 15) == 0) {  // 16 pixels a thread
    const uint4* cur = reinterpret_cast<const uint4*>(c.in[0]);
    const uint4* prev = reinterpret_cast<const uint4*>(c.in[1]);
    for (long long j = grid_first(); j < c.win / 16; j += grid_step()) {
      const uint4 a = __ldcg(cur + j), b = __ldcg(prev + j);
      const uint4 o = make_uint4(thres4(a.x, b.x, c.fparam), thres4(a.y, b.y, c.fparam),
                                 thres4(a.z, b.z, c.fparam), thres4(a.w, b.w, c.fparam));
      put<CB, uint4>(c, 0, 16 * j, o);
    }
    return;
  }
  for (long long j = grid_first(); j < c.win; j += grid_step()) {
    const float cur = __ldcg(c.in[0] + j), prev = __ldcg(c.in[1] + j);
    put<CB, unsigned char>(c, 0, j, motion::to_u8(motion::thres_px(cur, prev, c.fparam)));
  }
}

// The blur passes its 2-pixel border through and reads an interior
// pixel's 5x5 neighbours, all inside the frame: no offset needs clamping.
struct GaussPx {
  template <typename At>
  __device__ float operator()(At at, int y, int x, int H, int W) const {
    return motion::gauss_px(at, y, x, H, W);
  }
};
// The median's neighbours are clamped to the frame.
struct MedPx {
  template <typename At>
  __device__ float operator()(At at, int y, int x, int H, int W) const {
    auto clamped = [&](int dy, int dx) {
      return at(motion::clampi(y + dy, 0, H - 1) - y, motion::clampi(x + dx, 0, W - 1) - x);
    };
    return motion::med_px(clamped);
  }
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 fadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// The adder on words of T (float4 or float): its enabled inputs summed
// from 0 in its terms' order, each add rounded on its own; the loads of 8
// terms are in flight together.
template <int CB, typename T>
__device__ void adder_words(const Cmd& c) {
  constexpr int BATCH = 8;
  for (long long j = grid_first(); j < c.win / static_cast<long long>(sizeof(T));
       j += grid_step()) {
    T acc = {};
    for (int t0 = 0; t0 < c.n_terms; t0 += BATCH) {
      T x[BATCH];
      bool on[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int t = t0 + u;
        const int k = t < c.n_terms ? c.terms[t] : 0;
        on[u] = t < c.n_terms && ((c.in_en >> k) & 1);
        x[u] = on[u] ? __ldcg(reinterpret_cast<const T*>(c.in[k]) + j) : T{};
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (on[u]) acc = fadd(acc, x[u]);
    }
    put<CB, T>(c, 0, static_cast<long long>(sizeof(T)) * j, acc);
  }
}

template <int CB>
__device__ void run_adder(const Cmd& c) {
  unsigned long long bits = reinterpret_cast<uintptr_t>(c.out[0]) | c.win;
  for (int k = 0; k < c.n_in; ++k)
    if ((c.in_en >> k) & 1) bits |= reinterpret_cast<uintptr_t>(c.in[k]);
  if ((CB & CB_COPY) && (c.cb_mask & 1))
    bits |= reinterpret_cast<uintptr_t>(c.slot0[0]) | c.cb_from[0];
  if ((bits & 15) == 0)
    adder_words<CB, float4>(c);
  else
    adder_words<CB, float>(c);
}

// Shared memory the bodies stage in: Poly's basis values and taps, a
// stencil's rows.
struct Stage {
  float sb_re[BODY_THREADS + HALO];
  float sb_im[BODY_THREADS + HALO];
  float sh_re[N_TAPS];
  float sh_im[N_TAPS];
  alignas(16) float tile[TILE_FLOATS];
};

template <int CB>
__device__ __forceinline__ void run_body(const Cmd& c, Stage& st) {
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
      if (c.out_en & 1) run_adder<CB>(c);
      break;
    case K_POLY:
      run_poly<CB>(c, st.sb_re, st.sb_im, st.sh_re, st.sh_im);
      break;
    case K_GAUSS:
      run_stencil<CB>(c, GaussPx(), st.tile);
      break;
    case K_MED:
      run_stencil<CB>(c, MedPx(), st.tile);
      break;
    case K_THRES:
      if (c.out_en & 1) run_thres<CB>(c);
      break;
  }
}

// ---- the MoE bodies (the wide kinds) ----------------------------------- //
// Every product is float32 from bf16 weights, summed from 0 in the order of
// the summed index with each product and each add rounded on its own
// (__fmul_rn, __fadd_rn: no contraction), which is what the plain version
// (ref.py's _dot) computes with torch's elementwise ops.  SIMT, no tensor
// cores yet.
#ifdef MK_GUARDS
// Bit p: port p's float window held a NaN or an Inf (bad_win, bad_wout), or
// port p's window an element outside its channel's domain (dom_win,
// dom_wout), in a wide command.
__shared__ unsigned bad_win[WIDE_WORDS], bad_wout[WIDE_WORDS];
__shared__ unsigned dom_win[WIDE_WORDS], dom_wout[WIDE_WORDS];
#endif

__device__ __forceinline__ float bf16f(unsigned short x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}
__device__ __forceinline__ float fmac(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
// Port p's window (out: an output port) at the phase the command ran from.
__device__ __forceinline__ unsigned char* port_window(const View& v, const Cmd& c, bool out,
                                                      int p) {
  const int f = v.P[c.row[out ? A_OUT : A_IN] + p];
  return ring(v, f, bit_of(out ? c.wph_out : c.wph_in, p) * fifo_row(v, f)[F_RATE]);
}
// A float store to output port p's window, tested under guards for NaN and
// Inf and, where its channel declares one, against the domain.
__device__ __forceinline__ void put_moe(const View& v, const Cmd& c, int p, float* at,
                                        float x) {
#ifdef MK_GUARDS
  if (nonfinite(x)) atomicOr(&bad_wout[p >> 5], 1u << (p & 31));
  if (dom_any) {
    const int* fr = fifo_row(v, v.P[c.row[A_OUT] + p]);
    if (fr[F_DOM] && out_of_domain(x, fr)) atomicOr(&dom_wout[p >> 5], 1u << (p & 31));
  }
#endif
  *at = x;
}
// An int32 store to output port p's window, tested against its domain.
__device__ __forceinline__ void put_moe_i(const View& v, const Cmd& c, int p, int* at,
                                          int x) {
#ifdef MK_GUARDS
  if (dom_any) {
    const int* fr = fifo_row(v, v.P[c.row[A_OUT] + p]);
    if (fr[F_DOM] && out_of_domain(static_cast<unsigned>(x), fr))
      atomicOr(&dom_wout[p >> 5], 1u << (p & 31));
  }
#endif
  *at = x;
}

// The router, phase 0: logits (N, E) = x (N, D) @ W (D, E) into its scratch.
__device__ __noinline__ void router_logits(const View v, const Cmd& c) {
  const int* r = c.row;
  const int N = r[A_N0], D = r[A_N1], E = r[A_N2];
  const float* x = reinterpret_cast<const float*>(port_window(v, c, false, 0));
  const unsigned short* W = static_cast<const unsigned short*>(aptr(v, r[A_PTR0]));
  float* logits = static_cast<float*>(aptr(v, r[A_PTR0] + 1));
  for (long long o = grid_first(); o < static_cast<long long>(N) * E; o += grid_step()) {
    const int n = static_cast<int>(o / E), e = static_cast<int>(o - static_cast<long long>(n) * E);
    const float* xr = x + static_cast<long long>(n) * D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmac(acc, __ldcg(xr + d), bf16f(__ldg(W + static_cast<long long>(d) * E + e)));
    logits[o] = acc;
  }
}

// The router, phase 1, in every block on its own (the scan is short, and
// each block needs the counts in its own scheduler state): per token the
// softmax (the max, expf, the sum in expert order), the top k (ties to the
// lower expert), the weights over their sum (at least 1e-9); per expert the
// ranks of its assignments in token-major order and the slots within
// capacity.  Block 0 writes the slots, the weights and the packer's counts;
// every block writes the counts into its own control ring words and its
// share of the dispatched slabs (the token plus 0, as the reference's
// scatter-add into zeros, or 0).
__device__ __noinline__ void router_route(const View v, const Cmd& c) {
  const int* r = c.row;
  const int N = r[A_N0], D = r[A_N1], E = r[A_N2], C = r[A_N3], k = r[A_ORDER];
  const int nk = N * k, tid = threadIdx.x;
  const float* logits = static_cast<const float*>(aptr(v, r[A_PTR0] + 1));
  int* ge = v.moe;
  float* gw = reinterpret_cast<float*>(v.moe + nk);
  int* slot = v.moe + 2 * nk;
  int* inv = v.moe + 3 * nk;
  int* cnt = inv + E * C;
  for (int n = tid; n < N; n += BODY_THREADS) {
    const float* l = logits + static_cast<long long>(n) * E;
    float m = __ldcg(l);
    for (int e = 1; e < E; ++e) m = fmaxf(m, __ldcg(l + e));
    float sum = 0.f;
    for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, expf(__fsub_rn(__ldcg(l + e), m)));
    float gsum = 0.f;
    for (int j = 0; j < k; ++j) {
      int best = -1;
      float bv = 0.f;
      for (int e = 0; e < E; ++e) {
        bool taken = false;
        for (int q = 0; q < j; ++q) taken |= ge[n * k + q] == e;
        if (taken) continue;
        const float pe = __fdiv_rn(expf(__fsub_rn(__ldcg(l + e), m)), sum);
        if (best < 0 || pe > bv) {
          best = e;
          bv = pe;
        }
      }
      ge[n * k + j] = best;
      gw[n * k + j] = bv;
      gsum = __fadd_rn(gsum, bv);
    }
    const float den = fmaxf(gsum, 1e-9f);
    for (int j = 0; j < k; ++j) gw[n * k + j] = __fdiv_rn(gw[n * k + j], den);
  }
  body_sync();
  for (int e = tid; e < E; e += BODY_THREADS) {
    int seen = 0;
    for (int i = 0; i < nk; ++i) {
      if (ge[i] != e) continue;
      const int rank = seen++;
      slot[i] = rank < C ? e * C + rank : E * C;
      if (rank < C) inv[e * C + rank] = i / k;
    }
    for (int q = min(seen, C); q < C; ++q) inv[e * C + q] = -1;
    cnt[e] = min(seen, C);
  }
  body_sync();
  if (blockIdx.x == 0) {
    int* slot_o = reinterpret_cast<int*>(port_window(v, c, true, 2 * E));
    float* w_o = reinterpret_cast<float*>(port_window(v, c, true, 2 * E + 1));
    for (int i = tid; i < nk; i += BODY_THREADS) {
      put_moe_i(v, c, 2 * E, slot_o + i, slot[i]);
      put_moe(v, c, 2 * E + 1, w_o + i, __fmul_rn(gw[i], slot[i] < E * C ? 1.f : 0.f));
    }
    for (int e = tid; e < E; e += BODY_THREADS)
      put_moe_i(v, c, 2 * E + 2 + e,
                reinterpret_cast<int*>(port_window(v, c, true, 2 * E + 2 + e)), cnt[e]);
  }
  for (int e = tid; e < E; e += BODY_THREADS) {
    const int p = E + e;
    v.S[ctrl_word(v, v.P[r[A_OUT] + p], bit_of(c.wph_out, p))] = cnt[e];
  }
  const float* x = reinterpret_cast<const float*>(port_window(v, c, false, 0));
  for (int g = blockIdx.x; g < E * C; g += gridDim.x) {
    const int e = g / C, q = g - e * C, tok = inv[g];
    float* dst = reinterpret_cast<float*>(port_window(v, c, true, e)) + static_cast<long long>(q) * D;
    const float* src = x + static_cast<long long>(tok) * D;
    for (int d = tid; d < D; d += BODY_THREADS)
      put_moe(v, c, e, dst + d, tok >= 0 ? __fadd_rn(0.f, __ldcg(src + d)) : 0.f);
  }
}

// A tile of 16 columns (col0 ..) and up to 96 rows (row0 ..) of NB products
// A (rows, K) float32 @ B (K, M) bf16 sharing A, by the 256 body threads:
// thread (ty, tx) = (tid / 16, tid % 16) sums column col0 + tx of rows ty,
// ty + 16, ...; A and B staged 32 k at a time in the stage tile.  epi(row,
// col, sum0, sum1) takes each result.
constexpr int GEMM_COLS = 16, GEMM_ROWS = 96, GEMM_K = 32, GEMM_RPT = GEMM_ROWS / 16;
template <int NB, typename Epi>
__device__ __forceinline__ void gemm_tile(const float* A, int lda, int row0, int rows, int K,
                                          const unsigned short* B0, const unsigned short* B1,
                                          int M, int col0, float* tile, Epi epi) {
  float* As = tile;                             // GEMM_ROWS x GEMM_K
  float* Bs = tile + GEMM_ROWS * GEMM_K;        // NB x GEMM_K x GEMM_COLS
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[NB][GEMM_RPT];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < GEMM_RPT; ++j) acc[b][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += GEMM_K) {
    const int kc = min(GEMM_K, K - k0);
    for (int i = tid; i < rows * GEMM_K; i += BODY_THREADS) {
      const int rr = i / GEMM_K, kk = i - rr * GEMM_K;
      As[i] = kk < kc ? __ldcg(A + static_cast<long long>(row0 + rr) * lda + k0 + kk) : 0.f;
    }
    for (int i = tid; i < NB * GEMM_K * GEMM_COLS; i += BODY_THREADS) {
      const int b = i / (GEMM_K * GEMM_COLS), kk = (i / GEMM_COLS) % GEMM_K,
                cc = i % GEMM_COLS;
      const unsigned short* B = b ? B1 : B0;
      const int col = col0 + cc;
      Bs[i] = kk < kc && col < M ? bf16f(__ldg(B + static_cast<long long>(k0 + kk) * M + col))
                                 : 0.f;
    }
    body_sync();
    for (int kk = 0; kk < kc; ++kk) {
      float b[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q) b[q] = Bs[(q * GEMM_K + kk) * GEMM_COLS + tx];
#pragma unroll
      for (int j = 0; j < GEMM_RPT; ++j) {
        const float a = As[(ty + 16 * j) * GEMM_K + kk];
#pragma unroll
        for (int q = 0; q < NB; ++q) acc[q][j] = fmac(acc[q][j], a, b[q]);
      }
    }
    body_sync();
  }
#pragma unroll
  for (int j = 0; j < GEMM_RPT; ++j) {
    const int rr = ty + 16 * j, col = col0 + tx;
    if (rr < rows && col < M) epi(row0 + rr, col, acc[0][j], acc[NB - 1][j]);
  }
}

// Tiles t of a command's T, for this block: a rotation by the command's
// number spreads consecutive commands (the experts) over the blocks.
__device__ __forceinline__ int first_tile(const Cmd& c) {
  const int G = gridDim.x;
  return (static_cast<int>(blockIdx.x) + G - static_cast<int>(c.seq % G)) % G;
}

// An expert: phase 0 the hidden rows h = silu(slab @ Wg) * (slab @ Wu)
// into its scratch (silu(g) = g * (1 / (1 + exp(-g)))), phase 1 the output
// slab h @ Wd.
__device__ __noinline__ void run_expert(const View v, const Cmd& c, float* tile) {
  const int* r = c.row;
  const int C = r[A_N0], D = r[A_N1], F = r[A_AUX];
  const int base = r[A_PTR0];
  float* h = static_cast<float*>(aptr(v, base + 3));
  const int passes = (C + GEMM_ROWS - 1) / GEMM_ROWS;
  if (c.phase == 0) {
    const float* slab = reinterpret_cast<const float*>(port_window(v, c, false, 0));
    const auto* wg = static_cast<const unsigned short*>(aptr(v, base));
    const auto* wu = static_cast<const unsigned short*>(aptr(v, base + 1));
    const int cols = (F + GEMM_COLS - 1) / GEMM_COLS, T = cols * passes;
    for (int t = first_tile(c); t < T; t += gridDim.x) {
      const int row0 = (t / cols) * GEMM_ROWS, col0 = (t % cols) * GEMM_COLS;
      gemm_tile<2>(slab, D, row0, min(GEMM_ROWS, C - row0), D, wg, wu, F, col0, tile,
                   [&](int row, int col, float g, float u) {
                     const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
                     h[static_cast<long long>(row) * F + col] = __fmul_rn(__fmul_rn(g, s), u);
                   });
    }
    return;
  }
  float* y = reinterpret_cast<float*>(port_window(v, c, true, 0));
  const auto* wd = static_cast<const unsigned short*>(aptr(v, base + 2));
  const int cols = (D + GEMM_COLS - 1) / GEMM_COLS, T = cols * passes;
  for (int t = first_tile(c); t < T; t += gridDim.x) {
    const int row0 = (t / cols) * GEMM_ROWS, col0 = (t % cols) * GEMM_COLS;
    gemm_tile<1>(h, F, row0, min(GEMM_ROWS, C - row0), F, wd, nullptr, D, col0, tile,
                 [&](int row, int col, float acc, float) {
                   put_moe(v, c, 0, y + static_cast<long long>(row) * D + col, acc);
                 });
  }
}

// The combine: y[n] = sum over k of row(slot[n, k]) * w[n, k], from 0 in k
// order; a dropped assignment (slot E C) or a disabled expert gives 0.
__device__ __noinline__ void run_combine(const View v, const Cmd& c) {
  const int* r = c.row;
  const int N = r[A_N0], D = r[A_N1], E = r[A_N2], C = r[A_N3], k = r[A_ORDER];
  const int* slot = reinterpret_cast<const int*>(port_window(v, c, false, E));
  const float* w = reinterpret_cast<const float*>(port_window(v, c, false, E + 1));
  float* out = reinterpret_cast<float*>(port_window(v, c, true, 0));
  for (long long o = grid_first(); o < static_cast<long long>(N) * D; o += grid_step()) {
    const int n = static_cast<int>(o / D), d = static_cast<int>(o - static_cast<long long>(n) * D);
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int sl = __ldcg(slot + n * k + j);
      const float wt = __ldcg(w + n * k + j);
      float x = 0.f;
      if (sl >= 0 && sl < E * C) {
        const int e = sl / C;
        if (bit_of(c.wen_in, e))
          x = __ldcg(reinterpret_cast<const float*>(port_window(v, c, false, e)) +
                     static_cast<long long>(sl - e * C) * D + d);
      }
      acc = fmac(acc, x, wt);
    }
    put_moe(v, c, 0, out + o, acc);
  }
}

// The packer, in every block: the counts, twice, into its own control ring
// words of the packed token.
__device__ __noinline__ void run_packer(const View v, const Cmd& c) {
  const int* r = c.row;
  const int E = r[A_N2];
  const int at = ctrl_word(v, v.P[r[A_OUT]], bit_of(c.wph_out, 0));
  for (int e = threadIdx.x; e < E; e += BODY_THREADS) {
    const int n = __ldcg(reinterpret_cast<const int*>(port_window(v, c, false, e)));
    v.S[at + e] = n;
    v.S[at + E + e] = n;
  }
}


// ---- the serving network's bodies (graphs/serving.py) ------------------ //
// All int32, each the actor's fire bit for bit (ref.py's serving_*).  Simple
// code: gate and merge are grid-stride loops over the window; admission runs
// in warp 0 of every block (each block keeps its own control token, scalars
// and taken flags, as the scheduler needs them), block 0 alone writing its
// windows; retire runs in warp 0 of block 0, rows in order.

// Gate: input k to output k, for each enabled output.
template <int CB>
__device__ __noinline__ void run_gate(const Cmd& c) {
  for (int o = 0; o < c.n_out; ++o) {
    if (!((c.out_en >> o) & 1)) continue;
    const unsigned long long bits = reinterpret_cast<uintptr_t>(c.in[o]) |
                                    reinterpret_cast<uintptr_t>(c.out[o]) | c.win;
    if ((bits & 3) == 0) {
      const unsigned* src = reinterpret_cast<const unsigned*>(c.in[o]);
      for (long long j = grid_first(); j < c.win / 4; j += grid_step())
        put<CB, unsigned>(c, o, 4 * j, __ldcg(src + j));
    } else if ((bits & 1) == 0) {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(c.in[o]);
      for (long long j = grid_first(); j < c.win / 2; j += grid_step())
        put<CB, unsigned short>(c, o, 2 * j, __ldcg(src + j));
    } else {
      for (long long j = grid_first(); j < c.win; j += grid_step())
        put<CB, unsigned char>(c, o, j, __ldcg(c.in[o] + j));
    }
  }
}

__device__ __forceinline__ int add_i32(int a, int b) {  // int32 wraps, as torch's
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Merge: each active row takes its decoded token y[b] at generated column
// C_PROD, advances, and finishes on EOS or its budget; into output 0 (the
// feedback channel, a delay channel: CB_COPY copies phase 2 back).
template <int CB>
__device__ __noinline__ void run_merge(const Cmd& c) {
  const int* r = c.row;
  const int P = r[A_N0], N = r[A_N1], B = r[A_N2], eos = r[A_ORDER];
  const int W = SLOT_HEADER + P + N;
  const int* tbl = reinterpret_cast<const int*>(c.in[0]);
  const int* y = reinterpret_cast<const int*>(c.in[1]);
  for (long long j = grid_first(); j < static_cast<long long>(B) * W; j += grid_step()) {
    const int b = static_cast<int>(j / W), col = static_cast<int>(j - static_cast<long long>(b) * W);
    const int* row = tbl + static_cast<long long>(b) * W;
    const bool active = __ldcg(row + C_ACTIVE) > 0;
    const int act = active ? 1 : 0, yb = __ldcg(y + b);
    const int produced = __ldcg(row + C_PROD);
    int x;
    if (col >= SLOT_HEADER + P) {
      x = active && col - SLOT_HEADER - P == produced ? yb : __ldcg(row + col);
    } else if (col >= SLOT_HEADER) {
      x = __ldcg(row + col);
    } else {
      const int now = add_i32(produced, act);
      const bool fin = active && (yb == eos || now >= __ldcg(row + C_BUDGET));
      switch (col) {
        case C_ACTIVE: x = active && !fin; break;
        case C_POS: x = add_i32(__ldcg(row + C_POS), act); break;
        case C_PROD: x = now; break;
        case C_FIN: x = fin; break;
        case C_LAST: x = active ? yb : __ldcg(row + C_LAST); break;
        case C_NEW: x = 0; break;
        case C_AGE: x = add_i32(__ldcg(row + C_AGE), act); break;
        default: x = __ldcg(row + col);  // REQ, BUDGET, LAT, STATUS, DEADLINE
      }
    }
    put<CB, unsigned>(c, 0, 4 * j, static_cast<unsigned>(x));
  }
}

// Retire: each finished row with a request id in [0, R) into the actor's five
// (R, .) state tensors (generated tokens, produced, latency, status, done),
// rows in order: warp 0 of block 0.
__device__ __noinline__ void run_retire(const View v, const Cmd& c) {
  if (blockIdx.x != 0 || threadIdx.x >= 32) return;
  const int* r = c.row;
  const int P = r[A_N0], N = r[A_N1], B = r[A_N2], R = r[A_N3];
  const int W = SLOT_HEADER + P + N;
  int* gen = static_cast<int*>(aptr(v, r[A_PTR0]));
  int* lens = static_cast<int*>(aptr(v, r[A_PTR0] + 1));
  int* lat = static_cast<int*>(aptr(v, r[A_PTR0] + 2));
  int* status = static_cast<int*>(aptr(v, r[A_PTR0] + 3));
  int* done = static_cast<int*>(aptr(v, r[A_PTR0] + 4));
  const int* rows = reinterpret_cast<const int*>(c.in[0]);
  for (int b = 0; b < B; ++b) {
    const int* row = rows + static_cast<long long>(b) * W;
    const int req = __ldcg(row + C_REQ);
    if (__ldcg(row + C_FIN) <= 0 || req < 0 || req >= R) continue;
    for (int j = lane(); j < N; j += 32)
      gen[static_cast<long long>(req) * N + j] = __ldcg(row + SLOT_HEADER + P + j);
    if (lane() == 0) {
      lens[req] = __ldcg(row + C_PROD);
      lat[req] = __ldcg(row + C_LAT);
      status[req] = __ldcg(row + C_STATUS);
      done[req] = 1;
    }
    __syncwarp();
  }
}

// A slot of admission's input table: finished (EOS or budget last step, or
// its deadline passed), free once freed.
__device__ __forceinline__ void slot_state(const int* row, int t, bool* expired, bool* fin,
                                           bool* fre) {
  const int act = __ldcg(row + C_ACTIVE);
  *expired = act > 0 && __ldcg(row + C_DEADLINE) < t;
  *fin = *expired || __ldcg(row + C_FIN) > 0;
  *fre = *fin || act == 0;
}

// Admission, in warp 0 of every block: free the finished slots, admit the
// waiting requests in order into the free slots, shed and time out what it
// must (at most B - n_fin records ride the rows that did not finish), then
// the new table to outputs 0 and 1 and the finished rows to output 2
// (block 0), the control token [n_active, n_fin + n_shed, k] to every other
// output and the scalars retired += token[1], t += 1 (every block, its own
// io words).  Ranks come from ballots in request and slot order; the j-th
// admitted and the j-th shed request are kept in shared memory.
template <int CB>
__device__ __noinline__ void run_admission(const View v, const Cmd& c) {
  if (threadIdx.x >= 32) return;
  const int* r = c.row;
  const int P = r[A_N0], N = r[A_N1], B = r[A_N2], R = r[A_N3], qd = r[A_ORDER];
  const int W = SLOT_HEADER + P + N, l = lane();
  const unsigned below = (1u << l) - 1;
  int* sc = v.S + v.io_scal + 2 * r[A_SCALAR];
  const int retired = sc[0], t = sc[1];
  int* taken = v.S + v.io_ctrl + r[A_AUX];
  const int* prompts = static_cast<const int*>(aptr(v, r[A_PTR0]));
  const int* budgets = static_cast<const int*>(aptr(v, r[A_PTR0] + 1));
  const int* arrivals = static_cast<const int*>(aptr(v, r[A_PTR0] + 2));
  const int* deadlines = static_cast<const int*>(aptr(v, r[A_PTR0] + 3));
  const int* fb = reinterpret_cast<const int*>(c.in[0]);
  int* by_adm = v.moe;
  int* by_shed = v.moe + B;
  int n_fin = 0, n_free = 0, n_adm = 0;
  for (int b = l; b - l < B; b += 32) {
    bool e = false, fin = false, fre = false;
    if (b < B) slot_state(fb + static_cast<long long>(b) * W, t, &e, &fin, &fre);
    n_fin += __popc(__ballot_sync(FULL, fin));
    n_free += __popc(__ballot_sync(FULL, fre));
  }
  for (int i = l; i - l < R; i += 32) {
    const bool adm = i < R && taken[i] == 0 && __ldg(arrivals + i) <= t &&
                     !(__ldg(deadlines + i) < t);
    n_adm += __popc(__ballot_sync(FULL, adm));
  }
  const int k = min(n_adm, n_free);
  int a_rank = 0, s_rank = 0, n_shed = 0;
  for (int i = l; i - l < R; i += 32) {
    bool wait = false, expw = false;
    if (i < R) {
      wait = taken[i] == 0 && __ldg(arrivals + i) <= t;
      expw = wait && __ldg(deadlines + i) < t;
    }
    const bool adm = wait && !expw;
    const unsigned am = __ballot_sync(FULL, adm);
    const int ar = a_rank + __popc(am & below);
    const bool admit = adm && ar < k;
    const bool shed = expw || (adm && ar >= k + qd);
    const unsigned sm = __ballot_sync(FULL, shed);
    const int sr = s_rank + __popc(sm & below);
    const bool emit = shed && sr < B - n_fin;
    if (admit) by_adm[ar] = i;
    if (emit) by_shed[sr] = i;
    if (admit || emit) taken[i] = 1;
    a_rank += __popc(am);
    s_rank += __popc(sm);
    n_shed += __popc(__ballot_sync(FULL, emit));
  }
  __syncwarp();
  int f_rank = 0, r_rank = 0, n_active = 0;
  for (int b = 0; b < B; ++b) {
    const int* row = fb + static_cast<long long>(b) * W;
    bool expired, fin, fre;
    slot_state(row, t, &expired, &fin, &fre);
    const bool admit = fre && f_rank < k;
    const bool take = !fin && r_rank < n_shed;
    const int ai = admit ? by_adm[f_rank] : 0, si = take ? by_shed[r_rank] : 0;
    n_active += admit ? 1 : (!fin && __ldcg(row + C_ACTIVE) > 0);
    if (blockIdx.x == 0) {
      for (int col = l; col < W; col += 32) {
        int x = 0, y = 0;  // the table's word, the finished rows' word
        if (admit) {
          switch (col) {
            case C_ACTIVE: case C_NEW: x = 1; break;
            case C_REQ: x = ai; break;
            case C_POS: x = P - 1; break;
            case C_BUDGET: x = __ldg(budgets + ai); break;
            case C_STATUS: x = STATUS_OK; break;
            case C_DEADLINE: x = __ldg(deadlines + ai); break;
            default:
              if (col >= SLOT_HEADER && col < SLOT_HEADER + P)
                x = __ldg(prompts + static_cast<long long>(ai) * P + col - SLOT_HEADER);
          }
        } else if (!fin) {
          x = __ldcg(row + col);
        }
        if (take) {
          switch (col) {
            case C_REQ: y = si; break;
            case C_BUDGET: y = __ldg(budgets + si); break;
            case C_FIN: y = 1; break;
            case C_LAT: y = add_i32(t, -__ldg(arrivals + si)); break;
            case C_STATUS: y = __ldg(deadlines + si) < t ? STATUS_TIMEOUT : STATUS_SHED; break;
            case C_DEADLINE: y = __ldg(deadlines + si); break;
          }
        } else if (fin) {
          y = __ldcg(row + col);
          if (expired && col == C_FIN) y = 1;
          if (expired && col == C_STATUS) y = STATUS_TIMEOUT;
          if (col == C_LAT)
            y = add_i32(t - 1, -__ldg(arrivals + min(max(__ldcg(row + C_REQ), 0), R - 1)));
        }
        const long long at = 4 * (static_cast<long long>(b) * W + col);
        put<CB, unsigned>(c, 0, at, static_cast<unsigned>(x));
        put<CB, unsigned>(c, 1, at, static_cast<unsigned>(x));
        put<CB, unsigned>(c, 2, at, static_cast<unsigned>(y));
      }
    }
    f_rank += fre;
    r_rank += !fin;
  }
  if (l < c.n_out - 3) {
    int* tok = v.S + c.terms[3 + l];
    tok[0] = n_active;
    tok[1] = n_fin + n_shed;
    tok[2] = k;
  }
  if (l == 0) {
    sc[0] = retired + n_fin + n_shed;
    sc[1] = t + 1;
  }
  __syncwarp();
}

template <int CB>
__device__ __forceinline__ void run_serving(const View& v, const Cmd& c) {
  switch (c.kind) {
    case K_ADMISSION:
      run_admission<CB>(v, c);
      break;
    case K_GATE:
      run_gate<CB>(c);
      break;
    case K_MERGE:
      run_merge<CB>(c);
      break;
    case K_RETIRE:
      run_retire(v, c);
      break;
  }
}

#ifdef MK_GUARDS
// Bytes of a window of the channel with row fr.
__device__ __forceinline__ long long window_bytes(const int* fr) {
  return static_cast<long long>(fr[F_RATE]) * fr[F_TOKB];
}
// Whether a data channel (row fr) carries float tokens of any width.
__device__ __forceinline__ bool is_float(const int* fr) {
  return fr[F_ELEM] == ELEM_F32 || is_half(fr[F_ELEM]);
}

enum { SCAN_BAD = 1, SCAN_DOM = 2 };
// The block's share of n bytes at w of elem tokens: NaN and Inf where fl
// (SCAN_BAD), an element outside the domain of the channel with row fr
// where dm (SCAN_DOM; fr is read only then).  u8 tokens a byte at a time,
// bf16 and f16 ones 16 bytes at a time where the address and length allow,
// else 16 bits at a time (a window of an odd count of them ends mid-word),
// int32 and float32 ones a word at a time.
__device__ __forceinline__ int scan_span(const unsigned char* w, long long n, int elem,
                                         const int* fr, bool fl, bool dm) {
  bool bad = false, dom = false;
  if (elem == ELEM_U8) {
    if (dm)
      for (long long j = grid_first(); j < n; j += grid_step())
        dom |= out_of_domain(__ldcg(w + j), fr);
  } else if (is_half(elem)) {
    const unsigned e = half_exp(elem);
    if (((reinterpret_cast<uintptr_t>(w) | static_cast<unsigned long long>(n)) & 15) == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(w);
      for (long long j = grid_first(); j < n / 16; j += grid_step()) {
        const uint4 x = __ldcg(q + j);
        bad |= fl && nonfinite_h(x, e);
        dom |= dm && out_of_domain(x, fr);
      }
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(w);
      for (long long j = grid_first(); j < n / 2; j += grid_step()) {
        const unsigned short x = __ldcg(h + j);
        bad |= fl && nonfinite_h(x, e);
        dom |= dm && out_of_domain(x, fr);
      }
    }
  } else {
    const unsigned* ws = reinterpret_cast<const unsigned*>(w);
    for (long long j = grid_first(); j < n / 4; j += grid_step()) {
      const unsigned x = __ldcg(ws + j);
      bad |= fl && nonfinite(x);
      dom |= dm && out_of_domain(x, fr);
    }
  }
  return (bad ? SCAN_BAD : 0) | (dom ? SCAN_DOM : 0);
}
// scan_span over the window at w of the channel with row fr, in its type.
__device__ __noinline__ int scan_window(const unsigned char* w, const int* fr, bool fl,
                                        bool dm) {
  return scan_span(w, window_bytes(fr), fr[F_ELEM], fr, fl, dm);
}

// NONFINITE of a wide command's enabled float inputs and DOMAIN of those
// whose channel declares one (in its first phase).
__device__ __noinline__ void scan_inputs_wide(const View v, const Cmd& c) {
  for (int p = 0; p < c.n_in; ++p) {
    if (!bit_of(c.wen_in, p)) continue;
    const int f = v.P[c.row[A_IN] + p];
    const int* fr = fifo_row(v, f);
    const bool fl = is_float(fr), dm = dom_any && fr[F_DOM];
    if (fr[F_CTRL] || !(fl || dm)) continue;
    const int got = scan_window(port_window(v, c, false, p), fr, fl, dm);
    if (got & SCAN_BAD) atomicOr(&bad_win[p >> 5], 1u << (p & 31));
    if (got & SCAN_DOM) atomicOr(&dom_win[p >> 5], 1u << (p & 31));
  }
}

__device__ __noinline__ void flush_bad_wide(const View v, const Cmd& c, long long* fault) {
  for (int side = 0; side < 4; ++side)
    for (int k = 0; k < WIDE_WORDS; ++k) {
      unsigned* word = (side == 0 ? bad_win : side == 1 ? bad_wout
                        : side == 2 ? dom_win : dom_wout) + k;
      const int* ports = v.P + c.row[side & 1 ? A_OUT : A_IN];
      for (unsigned m = *word; m; m &= m - 1) {
        const int p = 32 * k + __ffs(m) - 1;
        atomicOr(reinterpret_cast<unsigned long long*>(fault + ports[p]),
                 static_cast<unsigned long long>(side < 2 ? NONFINITE : DOMAIN));
      }
      *word = 0;
    }
}
#endif

// The MoE bodies take the View by value: a View whose address is taken
// would leave the kernel's registers for local memory.
__device__ __noinline__ void run_moe(const View v, const Cmd& c, Stage& st) {
  switch (c.kind) {
    case K_ROUTER:
      if (c.phase == 0)
        router_logits(v, c);
      else
        router_route(v, c);
      break;
    case K_EXPERT:
      run_expert(v, c, st.tile);
      break;
    case K_COMBINE:
      run_combine(v, c);
      break;
    case K_PACKER:
      run_packer(v, c);
      break;
  }
}

#ifdef MK_GUARDS
// NONFINITE of the command's enabled float inputs (float32, bf16, f16): the
// block scans its share of each window, win bytes (every float input of a
// command has input 0's window: the serving kinds, whose windows differ,
// have none), in line and from the command alone (DPD's many short
// commands pay for a call and a read of the channel's row).
__device__ __forceinline__ void scan_inputs(const Cmd& c) {
  for (unsigned m = c.in_fl & c.in_en; m; m &= m - 1) {
    const int k = __ffs(m) - 1;
    const int elem = !((c.in_h >> k) & 1) ? ELEM_F32
                     : (c.in_hf >> k) & 1 ? ELEM_F16 : ELEM_BF16;
    if (scan_span(c.in[k], c.win, elem, nullptr, true, false) & SCAN_BAD)
      atomicOr(&bad_in, 1u << k);
  }
}

// DOMAIN of the command's enabled inputs whose channel declares one, in a
// program that has such a channel (H_DOM; the others never call it): the
// block scans its share of each window, a u8 window a byte at a time.
// Returns whether an enabled output declares a domain.
__device__ __noinline__ bool scan_domains(const Cmd& c) {
  const int* rows = dom_rows;
  unsigned out_dm = 0;
  for (int o = 0; o < c.n_out; ++o)
    out_dm |= static_cast<unsigned>(rows[FIFO_FIELDS * c.out_f[o] + F_DOM] != 0) << o;
  for (int k = 0; k < c.n_in; ++k) {
    const int* fr = rows + FIFO_FIELDS * c.in_f[k];
    if (!((c.in_en >> k) & 1) || !fr[F_DOM]) continue;
    if (scan_window(c.in[k], fr, false, true) & SCAN_DOM) atomicOr(&dom_in, 1u << k);
  }
  return (out_dm & c.out_en) != 0;
}

// After a body: OR NONFINITE and DOMAIN into the global fault word of every
// channel the block saw a bad word on, and clear the block words (thread 0,
// after a barrier; the next command's barrier orders the clear before its
// stores).
__device__ __forceinline__ void flush_bits(unsigned m, const int* ports, long long* fault,
                                           int bit) {
  for (; m; m &= m - 1)
    atomicOr(reinterpret_cast<unsigned long long*>(fault + ports[__ffs(m) - 1]),
             static_cast<unsigned long long>(bit));
}
__device__ void flush_bad(const Cmd& c, long long* fault) {
  flush_bits(bad_in, c.in_f, fault, NONFINITE);
  flush_bits(bad_out, c.out_f, fault, NONFINITE);
  bad_in = bad_out = 0;
  if (dom_any) {
    flush_bits(dom_in, c.in_f, fault, DOMAIN);
    flush_bits(dom_out, c.out_f, fault, DOMAIN);
    dom_in = dom_out = 0;
  }
}
#endif


// The serving kinds' commands, with the narrow path's guards (their outputs
// test DOMAIN on store, merge's feedback window copies back on phase 2).
__device__ __noinline__ void run_ext(const View v, const Cmd& c, long long* fault) {
#ifdef MK_GUARDS
  scan_inputs(c);
  if (dom_any && scan_domains(c)) {
    if (c.cb_mask)
      run_serving<CB_COPY | CB_DOM>(v, c);
    else
      run_serving<CB_DOM>(v, c);
  } else
#endif
  if (c.cb_mask)
    run_serving<CB_COPY>(v, c);
  else
    run_serving<0>(v, c);
#ifdef MK_GUARDS
  body_sync();
  if (threadIdx.x == 0) flush_bad(c, fault);
#else
  (void)fault;
#endif
}

#ifdef MK_GUARDS
// At a resume, the step firing the runner ran: NONFINITE of its enabled
// float windows (float32, bf16, f16) and DOMAIN of those whose channel
// declares one, inputs and outputs, each block its share (the values
// dynamic mode's guards read at that firing).
__device__ __noinline__ void scan_step(const View v, long long* fault) {
  const int* y = v.S + v.io_counts + v.P[H_N_ACTORS];
  const int* r = actor_row(v, y[Y_ACTOR]);
  for (int side = 0; side < 2; ++side) {
    const unsigned en = static_cast<unsigned>(y[side ? Y_OUT_EN : Y_IN_EN]);
    for (int p = 0; p < r[side ? A_NOUT : A_NIN]; ++p) {
      if (!((en >> p) & 1)) continue;
      const int f = v.P[r[side ? A_OUT : A_IN] + p];
      const int* fr = fifo_row(v, f);
      const bool fl = is_float(fr), dm = fr[F_DOM] != 0;
      if (fr[F_CTRL] || !(fl || dm)) continue;
      const int got = scan_window(ring(v, f, y[Y_OFF + side * MAX_STEP_PORTS + p]), fr,
                                  fl, dm);
      if (got & SCAN_BAD)
        atomicOr(reinterpret_cast<unsigned long long*>(fault + f),
                 static_cast<unsigned long long>(NONFINITE));
      if (got & SCAN_DOM)
        atomicOr(reinterpret_cast<unsigned long long*>(fault + f),
                 static_cast<unsigned long long>(DOMAIN));
    }
  }
}
#endif

// The bodies of a firing that writes a delay channel's phase 2, out of line
// so that the command loop's common path keeps its code compact.
__device__ __noinline__ void run_body_copy_back(const Cmd& c, Stage& st) {
  run_body<CB_COPY>(c, st);
}

#ifdef MK_GUARDS
// The bodies of a command with an output that declares a domain.
__device__ __noinline__ void run_body_domain(const Cmd& c, Stage& st) {
  if (c.cb_mask)
    run_body<CB_COPY | CB_DOM>(c, st);
  else
    run_body<CB_DOM>(c, st);
}
#endif

// MOE: an instance with the MoE kinds (the wide path, body-written control
// tokens, the MoE bodies); networks without them run the other, which has
// none of that code.
template <bool MOE>
__global__ void __launch_bounds__(THREADS, 1)
megakernel(const int* __restrict__ prog, long long* args, int n_ptrs,
           int io_len, int max_sweeps, int multi_firing,
           unsigned long long* progress
#ifdef MK_TRACE
           , int* trace, int trace_cap
#endif
           ) {
  extern __shared__ __align__(16) int smem[];
  __shared__ Cmd slots[RING];
  // Per slot: filled (scheduler), run by this block's body threads (one
  // arrival a warp), free again (publisher).
  __shared__ uint64_t full[RING], done[RING], empty[RING];
  __shared__ Stage stage;
  __shared__ long long least;        // the watcher's: every block has passed it
  __shared__ long long local_done;   // the publisher's: this block has run it
  __shared__ unsigned wide_bits[4 * WIDE_WORDS];  // View::wide
  __shared__ long long wide_wait;
  __shared__ volatile int finished;  // the body threads are done
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;

  // 1. Replicate the program, the io words and the addresses into this
  //    block: [program | io words | phases | guard words] as ints, then
  //    [addresses | segment trackers | each actor's last command] as 8-byte
  //    words, then the router's routing words (megakernel_run sizes it).
  const int len = prog[H_LEN];
  const int n_state = io_len - META_WORDS;
  long long* io = args + n_ptrs;
  // io words with a pending step firing: this launch resumes that run from
  // its saved scheduler, numbering commands on from seq0.
  const int io_yield = 3 * prog[H_N_FIFOS] + 2 * prog[H_N_SCALARS] + prog[H_N_CTRL] +
                       prog[H_N_ACTORS];
  const bool resume = MOE && io[io_yield + Y_PENDING] != 0;
  const long long seq0 = resume ? io[io_yield + Y_SEQ] : 0;
  View v;
  v.P = smem;
  v.S = smem + len;
  v.ph = v.S + n_state;
  long long* words = reinterpret_cast<long long*>(
      smem + ((len + n_state + (2 + GUARD_INTS) * n_ptrs + 1) & ~1));
#ifdef MK_GUARDS
  // The high-water marks go on from the io words (a resumed run's so far).
  v.fault = v.ph + 2 * n_ptrs;
  v.hw = v.fault + n_ptrs;
  for (int i = tid; i < n_ptrs; i += THREADS) {
    v.fault[i] = 0;
    v.hw[i] = i < prog[H_N_FIFOS] ? static_cast<int>(io[io_len + prog[H_N_FIFOS] + i]) : 0;
  }
#endif
#ifdef MK_TRACE
  v.trace = trace;
  v.trace_cap = trace_cap;
#endif
  v.addr = words;
  v.trk = words + n_ptrs;
  const int n_actors = prog[H_N_ACTORS];
  v.alast = v.trk + 2 * SEGS * n_ptrs;
  v.moe = reinterpret_cast<int*>(v.alast + n_actors);
  v.local_done = &local_done;
  v.wide = wide_bits;
  v.wide_wait = &wide_wait;
  for (int i = tid; i < len; i += THREADS) smem[i] = prog[i];
  for (int i = tid; i < n_state; i += THREADS) v.S[i] = static_cast<int>(io[i]);
  for (int i = tid; i < n_ptrs; i += THREADS) words[i] = args[i];
  for (int i = tid; i < 2 * SEGS * n_ptrs; i += THREADS) v.trk[i] = 0;
  for (int i = tid; i < n_actors; i += THREADS) v.alast[i] = 0;
  if (tid == 0) {
    least = seq0;
    local_done = seq0;
    finished = 0;
#ifdef MK_GUARDS
    bad_in = bad_out = dom_in = dom_out = 0;
    for (int k = 0; k < WIDE_WORDS; ++k) bad_win[k] = bad_wout[k] = dom_win[k] = dom_wout[k] = 0;
#endif
    for (int i = 0; i < RING; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&done[i], BODY_THREADS / 32);
      mbar_init(&empty[i], 1);
    }
    progress[blockIdx.x] = seq0;
  }
  __syncthreads();
  v.fifos = v.P + v.P[H_FIFO_OFF];
  v.actors = v.P + v.P[H_ACTOR_OFF];
  v.n_fifos = v.P[H_N_FIFOS];
  v.io_scal = 3 * v.P[H_N_FIFOS];
  v.io_ctrl = v.io_scal + 2 * v.P[H_N_SCALARS];
  v.io_counts = v.io_ctrl + v.P[H_N_CTRL];
#ifdef MK_GUARDS
  if (tid == 0) {
    dom_rows = v.fifos;
    dom_any = v.P[H_DOM];
  }
#endif
  for (int f = tid; f < v.P[H_N_FIFOS]; f += THREADS) {
    // Python's modulo: an injected cursor may be negative.
    const int nph = fifo_row(v, f)[F_NPH];
    v.ph[2 * f] = (v.S[3 * f] % nph + nph) % nph;
    v.ph[2 * f + 1] = (v.S[3 * f + 1] % nph + nph) % nph;
  }

  // 2. Forwarded data rings start from zeros (the dead-slot rule), except in
  //    a resumed run, which goes on with what they hold; there the guards
  //    first check the step firing's windows.
  if (tid < BODY_THREADS && !resume)
    for (int f = 0; f < v.P[H_N_FIFOS]; ++f) {
      const int* fr = fifo_row(v, f);
      if (!fr[F_FWD] || fr[F_CTRL]) continue;
      copy_bytes(ring(v, f, 0), nullptr, static_cast<long long>(fr[F_CAP]) * fr[F_TOKB]);
    }
#ifdef MK_GUARDS
  if constexpr (MOE)
    if (tid < BODY_THREADS && resume) scan_step(v, io + io_len);
#endif
  grid.sync();

  // 3. The scheduler warp decides; the body threads run the commands; the
  //    publisher warp reports each command this block has finished.
  if (tid >= WATCH_TID) {
    watcher(progress, &least, &finished);
    return;
  }
  if (tid >= PUBLISH_TID) {
    publisher<MOE>(slots, done, empty, progress, &local_done);
    return;
  }
  if (tid >= SCHED_TID) {
    Sched s = {};
    s.vpos = s.left = -1;
    s.fired_any = 1;
    if (resume) {
      const int* y = v.S + io_yield;
      s.sweeps = y[Y_SWEEPS];
      s.vpos = y[Y_VPOS];
      s.left = y[Y_LEFT];
      s.fired_any = y[Y_FIRED];
      s.seq = seq0;
    }
#ifdef MK_TRACE
    s.events = io[io_len + 2 * v.n_fifos];
#endif
    [[maybe_unused]] const long long clk =
        scheduler<MOE>(v, slots, full, empty, &s, max_sweeps, multi_firing);
    // 4. Block 0 writes the replicated state back, once its body threads
    //    have written every control token a body writes.
    if constexpr (MOE) {
      if (blockIdx.x == 0) {
        const long long since = clock64();
        while (load_acquire_cta(&local_done) < s.seq) watchdog(since);
        __syncwarp();
      }
    }
    if (blockIdx.x == 0) {
      if constexpr (MOE) {
        // A yield: the scheduler to resume from.
        if (lane() == 0) {
          int* y = v.S + io_yield;
          y[Y_PENDING] = s.error == ERR_YIELD;
          if (s.error == ERR_YIELD) {
            y[Y_SWEEPS] = s.sweeps;
            y[Y_VPOS] = s.vpos;
            y[Y_LEFT] = s.left;
            y[Y_FIRED] = s.fired_any;
            y[Y_SEQ] = static_cast<int>(s.seq);
          }
        }
        __syncwarp();
      }
      for (int i = lane(); i < n_state; i += 32) io[i] = v.S[i];
      if (lane() == 0) {
        long long* meta = io + n_state;
        meta[M_SWEEPS] = s.sweeps;
        meta[M_STALLED] = s.stalled;
        meta[M_ERROR] = s.error == ERR_YIELD ? 0 : s.error;
        meta[M_ERR_ACTOR] = s.err_actor;
        meta[M_ERR_VALUE] = s.err_value;
        meta[M_BLOCKS] = gridDim.x;
#ifdef MK_CLOCK_SPLIT
        meta[M_CLK_SCHED] = clk;
#endif
#ifdef MK_TRACE
        io[io_len + 2 * v.n_fifos] = s.events;
#endif
      }
#ifdef MK_GUARDS
      // The body threads OR NONFINITE into the same fault words.
      for (int f = lane(); f < v.n_fifos; f += 32) {
        if (v.fault[f])
          atomicOr(reinterpret_cast<unsigned long long*>(io + io_len + f),
                   static_cast<unsigned long long>(v.fault[f]));
        io[io_len + v.n_fifos + f] = v.hw[f];
      }
#endif
    }
    return;
  }
#ifdef MK_CLOCK_SPLIT
  long long clk_sched = 0, clk_wait = 0, n_wait = 0;
  long long clk_kind[K_MED + 1] = {}, n_kind[K_MED + 1] = {};
  const long long clk_start = clock64();
#endif
  long long seen = 0;  // warp 0: every block has passed command `seen`
  for (long long n = 0;; ++n) {
    const int i = static_cast<int>(n % RING);
#ifdef MK_CLOCK_SPLIT
    const long long t0 = clock64();
#endif
    mbar_wait(&full[i], static_cast<uint32_t>((n / RING) & 1));
#ifdef MK_CLOCK_SPLIT
    const long long t1 = clock64();
    clk_sched += t1 - t0;
#endif
    const Cmd& cmd = slots[i];
    const bool last = cmd.kind == CMD_DONE;
    if (!last) {
      // Warp 0 acquires the watcher's least progress until it covers
      // wait_for; the block barrier hands that on.
      bool waited = false;
      if (tid < 32 && cmd.wait_for > seen) {
        const long long since = clock64();
        seen = load_acquire_cta(&least);
        while (seen < cmd.wait_for) {
          waited = true;
          watchdog(since);
          seen = load_acquire_cta(&least);
        }
      }
      body_sync();
#ifdef MK_CLOCK_SPLIT
      if (waited) {
        clk_wait += clock64() - t1;
        n_wait += 1;
      }
#endif
#ifdef MK_CLOCK_SPLIT
      const long long t2 = clock64();
#endif
      bool moe_cmd = false;
      if constexpr (MOE) moe_cmd = cmd.kind >= K_ROUTER;
      if (moe_cmd && cmd.kind > K_PACKER) {
        run_ext(v, cmd, io + io_len);
      } else if (moe_cmd) {
#ifdef MK_GUARDS
        if (cmd.phase == 0) scan_inputs_wide(v, cmd);
#endif
        run_moe(v, cmd, stage);
#ifdef MK_GUARDS
        body_sync();
        if (tid == 0) flush_bad_wide(v, cmd, io + io_len);
#endif
      } else {
#ifdef MK_GUARDS
        scan_inputs(cmd);
        if (dom_any && scan_domains(cmd))
          run_body_domain(cmd, stage);
        else
#endif
        if (cmd.cb_mask)
          run_body_copy_back(cmd, stage);
        else
          run_body<0>(cmd, stage);
#ifdef MK_GUARDS
        body_sync();
        if (tid == 0) flush_bad(cmd, io + io_len);
#endif
      }
#ifdef MK_CLOCK_SPLIT
      if (cmd.kind <= K_MED) {
        clk_kind[cmd.kind] += clock64() - t2;
        n_kind[cmd.kind] += 1;
      }
#endif
    }
    __syncwarp();
    if (lane() == 0) mbar_arrive(&done[i]);
    if (last) break;
  }
  if (tid == 0) finished = 1;
#ifdef MK_CLOCK_SPLIT
  if (blockIdx.x == 0 && tid == 0) {
    long long* meta = io + n_state;
    meta[M_CLK_STALL] = (clk_sched & 0xffffffffLL) | (clk_wait << 32);
    meta[M_CLK_LOOP] = ((clock64() - clk_start) & ((1LL << 40) - 1)) | (n_wait << 40);
    for (int k = 0, w = M_CLK_KIND; k <= K_MED; ++k)
      if (k != K_CONFIG) meta[w++] = (clk_kind[k] & ((1LL << 40) - 1)) | (n_kind[k] << 40);
  }
#endif
}

}  // namespace

// Launch B2 once on `stream` (PyTorch's current stream) as a cooperative
// grid of one block per SM.  `prog` is the packed program (prog_len int32
// words, with n_actors actors and H_SCRATCH = scratch_words, which size the
// shared memory, and H_MOE = moe, which picks the kernel's instance), `args`
// the run's block (n_ptrs addresses, then io_len io words),
// `progress` n_progress 8-byte words of scratch (the blocks' progress, which
// the kernel zeroes), all on the current device.  Returns
// cudaGetLastError(), or the error of the failed query or refused launch.
//
// The MK_GUARDS build writes, after the io_len io words, a fault word and a
// high-water mark per channel; the MK_TRACE build takes a trace ring of
// trace_cap rows of 3 + channels int32 words and writes the event count
// after those.
extern "C" int megakernel_run(const int* prog, int prog_len, long long* args,
                              int n_ptrs, int io_len, int max_sweeps,
                              int multi_firing, unsigned long long* progress,
                              int n_progress, void* stream, int n_actors,
                              int scratch_words, int moe
#ifdef MK_TRACE
                              , int* trace, int trace_cap
#endif
                              ) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms > n_progress) return static_cast<int>(cudaErrorInvalidValue);
  // [program | io words | phases | guard words] as ints, padded to 8
  // bytes, then [addresses | segment trackers] as 8-byte words; channels
  // <= n_ptrs.
  const size_t ints =
      static_cast<size_t>(prog_len + io_len - META_WORDS + (2 + GUARD_INTS) * n_ptrs);
  const size_t smem = (ints + 1) / 2 * 8 +
                      (static_cast<size_t>(1 + 2 * SEGS) * n_ptrs + n_actors) * 8 +
                      static_cast<size_t>(scratch_words) * 4;
  const void* kernel = moe ? reinterpret_cast<const void*>(megakernel<true>)
                          : reinterpret_cast<const void*>(megakernel<false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
#ifdef MK_TRACE
  if (trace_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* kargs[] = {&prog,         &args,     &n_ptrs, &io_len, &max_sweeps,
                   &multi_firing, &progress, &trace,  &trace_cap};
#else
  void* kargs[] = {&prog, &args, &n_ptrs, &io_len, &max_sweeps, &multi_firing, &progress};
#endif
  err = cudaLaunchCooperativeKernel(kernel, dim3(sms),
                                    dim3(THREADS), kargs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* megakernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
