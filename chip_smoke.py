"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --b2 SRC    # B2's time alone, from another src tree
    python3 chip_smoke.py --b2-split SRC  # B2's clock split, from another tree
    python3 chip_smoke.py --b5 SRC    # B5's time alone, from another src tree
    python3 chip_smoke.py --b6 SRC    # B6's time alone, from another src tree
    python3 chip_smoke.py --b7 SRC    # B7's time alone, from another src tree
    python3 chip_smoke.py --b1 SRC    # B1's time, wrapper and DPD's wall, from SRC
    python3 chip_smoke.py --b3 SRC    # B3's time, wrapper and MD's wall, from SRC
    python3 chip_smoke.py --b4 SRC    # B4's time, wrapper and R probe, from SRC
    python3 chip_smoke.py --train     # phase 24 alone (with phase 1)
    python3 chip_smoke.py --shard     # phase 25 alone (with phase 1)

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
``sm_90a``, one ``nvcc`` per library, all seven started together:
``dyn_fir`` B1, ``megakernel`` B2, ``gauss5x5`` B3, ``motion_post`` B4,
``flash_attention`` B5, ``ssd`` B6, ``rglru`` B7) and, on the card:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds kernel B1 against its plain PyTorch version at the main path's
   shapes, bit for bit, on an aligned window and on a view 36 bytes off
   one, and times both (CUDA events; the kernel's own time from replays
   of a CUDA graph of its launches, so the host wrapper is out of it),
   beside two yardsticks timed the same way: ``copy_`` over the same
   bytes and a one-element ``zero_()``, the launch floor;
3. drives the main path — the DPD network at full width (block 32 768,
   10 branches, 64 firings, dynamic mode) — with every launch count set to
   0 just before and read just after, and holds its structure (exactly)
   and its floats (``1e-5 * max|y|`` per plane) against the same run on the
   CPU;
6. (run right after 3, since 4 and 5 time it) drives the same network in
   ``mode="megakernel"``, again with every count set to 0 just before:
   one launch of kernel B2 per run and no launch of B1, and every leaf of
   the final state bit-identical to the phase-3 run and to B2's plain
   version (``core/megakernel/ref.py``) on the card, at ``cores=1`` and
   ``cores=2``; then times B2 and its plain version;
4. measures the paper's Table 4 rows (Msamples/s) in static, dynamic and
   megakernel mode, and the dynamic-rate gain in each mode (``min_active2``
   over the static all-10 network, and ``all10`` over ``min_active2``);
5. profiles the main path in dynamic and in megakernel mode: device time by
   kernel (``torch.profiler``; B1's device time per launch among them),
   the device's busy share against the median
   wall time of warm runs, and where the host's time goes in dynamic mode
   (``cProfile``);
7. holds kernels B3 (Gauss) and B4 (Thres + Med) against their plain
   versions at motion detection's shapes, (4, 240, 320): B3 bit-identical
   on u8 frames (one built to hold ``.5`` ties among them) and within
   ``rtol 1e-5, atol 1e-3`` on float frames; B4 bit-identical on float
   and on u8 frames (one launch each, u8 straight into the kernel) and at
   (3, 17, 13), which takes its element path; and times both, B3 beside
   the yardsticks of phase 2 over its u8 bytes, B4 on float and u8 frames
   beside ``torch.add`` into a float32 plane (its bytes exactly) and the
   launch floor, with a profile of B4 on u8 frames that must hold no other
   kernel;
8. drives the second path — motion detection at the paper's frame
   (960 frames of 240x320 u8, rate 4, seed 0, dynamic mode) — with every
   count set to 0 just before: 240 B3 launches and none of B2 or B4, 121
   sweeps and 240 firings per actor, every leaf bit-identical to the same
   run on the CPU;
9. drives it in ``mode="megakernel"`` at ``cores=1`` and ``cores=2``: one
   B2 launch and no B3 launch per run, every leaf bit-identical to the
   phase-8 run and to B2's plain version on the card; then times B2;
10. measures the paper's Table 3 rows (frames/s): interpreted at rate 1,
    static, dynamic and megakernel at rate 4, on the same video;
11. profiles motion detection in dynamic and megakernel mode: device time
    by kernel and the busy share against the median warm wall;
12. holds kernels B5 (flash attention), B6 (SSD) and B7 (RG-LRU) against
    their plain versions at the full-width serving shapes: B5 at
    recurrentgemma-2b's (q (4, 4096, 10, 256), k/v (4, 4096, 1, 256) bf16,
    causal, window 2048), B6 at mamba2-780m's (x (4, 4096, 48, 64) bf16,
    B/C (4, 4096, 128), chunk 256; and on float32 inputs), B7 at (4, 4096,
    2560) float32; B5 within one bf16 step plus ``B5_ROW_TOL`` of its
    row's RMS, a bar three planted faults (the plain version with one key
    tile skipped, the causal or the window edge one key off) must break;
    B6 within ``B6_TOL`` of the plain version and of the step-by-step
    recurrence ``ssd_naive`` (under strong decays, dt up to 5 at A = -16,
    of ``ssd_naive`` only), a bar a planted fault (the plain version put
    together chunk by chunk with the state entering each chunk taken one
    chunk late) must break; B7 bit-identical (``torch.equal`` on h_seq
    and hT), with the largest difference printed;
    times each (CUDA graph replays), its plain version and, for B5,
    ``scaled_dot_product_attention`` with the same boolean mask and
    ``enable_gqa=True`` as the library yardstick (never used by the port);
    also B5's float32 and f16 route (``flash_fwd_ffma``) at
    recurrentgemma-2b's shape through the entry, float32 within
    ``B5_F32_TOL`` and f16 within one f16 step plus ``B5_F16_ROW_TOL`` of
    the row's RMS, timed beside SDPA in float32 with the same mask; B6's
    SIMT route (any (P, N)) at mamba2's smoke shape (P 16, N 16, the
    serving batch and prompt), on float32 and f16 inputs, within
    ``B6_TOL`` of its plain version, timed; B7 on bf16 inputs through the
    entry (cast to float32), bit-identical to the plain version on the cast
    operands;
13. serves recurrentgemma-2b at its published width (weights from a seeded
    generator): 8 requests with prompt lengths from
    ``numpy.random.default_rng(0)`` in 2048-4096, left-padded to 4096,
    batch 4, 32 new tokens, no EOS, through ``repro_torch.serve.Engine``,
    with every count set to 0 just before: 16 B5 and 36 B7 launches (8 and
    18 per prefill) and none of B1-B4 or B6; logs prefill ms per batch,
    decode ms per step and tokens/s; then a short run (batch 2, prompt 256,
    4 new tokens, the same weights) on the card and on the CPU (the plain
    path): every layer's mixer and MLP, fed the CPU's input, element by
    element within one bf16 step plus ``MIX_ROW_TOL`` of the row's RMS;
    logits at every prompt position within ``LOGIT_SENS`` times the CPU
    model's own sensitivity there to one bf16 step at its input (random
    full-width weights amplify rounding noise; at least 3e-2), a bar that
    must lie below the logits' magnitude at some positions; the Engine's
    logits within the last position's bar and its tokens identical
    wherever the CPU's top-2 margin exceeds twice the step's largest logit
    difference;
14. the same for mamba2-780m: 96 B6 launches (48 per prefill) and no B5 or
    B7; then mamba2's smoke configuration served on the card (B6's SIMT
    route, one launch a layer a prefill) and held to the CPU model on the
    same weights as in 13 (each layer, the logits, the Engine);
15. profiles one prefill (4 x 4096 tokens) and one decode step of each
    model: device time by kernel, B5-B7 each summed over its CUDA kernels
    (B5 ``flash_fwd_wgmma``, B6 3 per call, B7 ``rglru_kernel``), and the
    busy share against the median wall of warm runs (printed after 13 and
    after 14);
16. (run after 11) B2's clock split per run on DPD's main path and on
    motion detection (:func:`b2_split`): the build of ``megakernel.cu``
    with ``-DMK_CLOCK_SPLIT`` (the main path's build leaves it off), timed
    as phases 6 and 9 time B2, with block 0's cycles split into waiting
    for the scheduler, waiting on other blocks (with the count of waits)
    and the rest (bodies, also by kind), and its scheduler warp's time
    deciding and waiting for a free command slot;
17. (run after 16) the health layer, the firing trace and fault injection
    (ROADMAP A7) at full width: DPD (phase 3's network) and motion
    detection (phase 8's) run guarded and traced in dynamic mode, and in
    megakernel mode at ``cores=1`` and ``2`` with each of B2's three health
    builds (``-DMK_GUARDS``, ``-DMK_TRACE``, both), with every count set to
    0 just before each run: the same launches as phases 3, 6, 8 and 9 (one
    B2 launch of that build per megakernel run), every leaf bit-identical
    to phase 3's and 8's states, and the diagnostics (fault words,
    high-water marks) and trace events equal across the host dynamic run,
    B2 and B2's plain version on the card; then each of five faults
    (overflow, underflow, a corrupted cursor, NaN poison, and a window of
    1e3 on ``f_in`` declaring the domain ``F_IN_DOMAIN``, which every clean
    sample lies in: DOMAIN on a data channel) injected on DPD's ``f_in``,
    run by B2 at ``cores=1`` and ``2`` (no channel forwarded), by its plain
    version and by the host dynamic executor, guarded and traced: the same
    named diagnostics, the same trace events and the same partial state,
    bit for bit, from all three; and B2's time per run from the main build
    and the three health builds, in turns;
18. (run after 17) the MoE actor network (``graphs/moe_as_actors.py``)
    at one olmoe-1b-7b layer's published widths (D 2048, 64 experts,
    top-8, F 1024, capacity factor 1.25; 512 tokens a firing, 8 firings,
    C = 80; weights ``moe_init`` seed 0, tokens numpy seed 0): the host
    dynamic mode (torch bodies, no kernel of the port), B2 at cores 1 and
    2 (one launch a run) and B2's guarded and traced build: fire counts,
    sweeps and cursors equal; the integer rings (slots, counts, the packed
    token) equal unless a near-tie lies under the margin rule (the tokens
    whose top-8 logit margin is at most twice the largest difference
    between the host's and B2's router logits are counted and printed);
    B2's output within ``MOE_Y_TOL`` of max|y| from the host run's; B2
    against its plain version bit for bit at make_moe's width and at D 256
    / E 8; B2 timed (CUDA events) beside its bound and the host run;
19. (run after 14) olmoe-1b-7b served at its published width as in 13
    (16 layers, d 2048, 16 heads of 128, 64 experts top-8, vocab 50 304,
    6.9 B parameters, random weights from seed 0): 32 B5 launches (16 a
    prefill), prefill and decode times, tokens/s; parity with the CPU on
    a model cut to ``PARITY_MOE_LAYERS`` layers, its MoE MLPs held in two
    parts (the router's logits within ``MOE_LOGIT_TOL``; dispatch, experts
    and combine fed the CPU's routing, within 13's bar); its phase-15
    profile with the MoE layers' share of the prefill.  Phase 12 also
    holds B5 at olmoe's shape (q (4, 4096, 16, 128), causal, no window)
    against its plain version and times it beside SDPA;
20. (run after 19) whisper-small (the audio family) served at its
    published width (12 decoder and 12 encoder layers, d 768, 12 heads of
    64, vocab 51 865, encoder n_ctx 1500; random weights from seed 0)
    through ``LM.prefill(tokens, frames=...)`` and greedy
    ``LM.decode_step``s (the Engine feeds tokens only): 8 requests, batch
    4, prompts of 64-384 tokens from ``numpy.random.default_rng(0)``
    left-padded to 384, stub frames (4, 1500, 768) standard normal from the
    same generator, 32 new tokens; 48 B5 launches (24 a prefill: 12
    non-causal in the encoder, counted inside ``LM.encode``, and 12
    causal); times, tokens/s, its phase-15 profile; parity with the CPU on
    a model cut to ``PARITY_FAMILY_LAYERS`` decoder and encoder layers:
    every encoder layer's attention and MLP, every decoder layer's
    self-attention, cross attention and MLP within 13's bar, the logits
    at every position, the greedy run's logits and tokens;
21. internvl2-1b (the vision family: 24 layers, d 896, 14 query heads on
    2 KV heads of 64, vocab 151 655) served likewise with 256 stub vision
    embeddings (4, 256, 896) before prompts of 1792-3840 tokens
    left-padded to 3840 (S = 4096): 48 B5 launches, its profile and
    parity at full depth; then served as text through the Engine (as 13:
    48 B5 launches, tokens/s); then its decode on the int8 KV cache
    (``kv_quant_int8=True``, the same weights) against the bf16 cache,
    step by step in turns, with both caches' bytes; the card's int8 slots
    equal to the CPU's quantization of the card's own bf16 k and v, bit for
    bit; the card's int8 greedy run held to the CPU port's within the bf16
    parity's last-position bar, tokens under the margin rule.  Phase 12
    also holds B5 at whisper's encoder shape (q (4, 1500, 12, 64),
    non-causal), at its decoder's (q (4, 384, 12, 64), causal) and at
    internvl's (q (4, 4096, 14, 64), k/v (4, 4096, 2, 64), causal)
    against its plain version and times each beside SDPA.
22. (run after 13) recurrentgemma-2b served through ``ActorEngine``
    (``graphs/serving.py``'s admission/gate/decode/merge/retire network on
    the host dynamic executor) at its published width, on phase 13's
    traffic, eos_id None: the closed loop's tokens equal the ``Engine``'s
    bit for bit; an open loop (budgets 32 and 8 in turn, arrivals
    ``poisson_trace(8, 0.25, seed=7)``) gives each request its closed-loop
    prefix; fire counts, sweeps, latency steps and statuses, and a guarded,
    traced closed loop's high-water marks and trace events, equal a CPU run
    of the port at the smoke config on the same budgets, arrivals, B and
    N; ``expire_deadline``, ``queue_depth=0`` and a poisoned request
    quarantined, each against that CPU run's statuses (the survivors keep
    their closed-loop tokens); 8 B5 and 18 B7 launches per decode firing
    that ran a prefill; out-of-range ids through ``embed_lookup`` and
    argmax over NaN logits as on the CPU (C12); ``ActorEngine.generate``
    timed against ``Engine.generate`` in turns, 3 each.
23. durable and heterogeneous runs (ROADMAP A10, A11): (a, run after 17)
    phase 3's network streamed (``accelerated`` = every actor but source
    and sink, ``n_iterations=16``, 4 chunks) in megakernel mode
    (``specialize=False``): 4 B2 launches chunked and 1 persistent, both
    bit-identical to each other and to phase 6's sink slab as windows, fire
    counts, sweeps and staged bytes equal the CPU port's stream; in dynamic
    mode 398 B1 launches, bit-identical to phase 3; chunked against
    persistent timed in turns, 3 each; (b) child processes killed by
    SIGKILL from the snapshot hook and resumed by fresh ones: the
    megakernel stream and a traced dynamic stream after chunk 2 of 4
    (``resume_stream``: outputs, fire counts, sweeps and trace events
    bit-identical), ``run_checkpointed`` in megakernel and dynamic mode
    (at least 3 segments) after segment 1 (``resume_run``: every leaf,
    counts and sweeps bit-identical to ``Program.run``); one segmented run
    in this process makes one B2 launch a segment; (c, run after 14, on its
    model) mamba2-780m as the LM stage network (4 stages of 12 layers, 4
    microbatches of 4096 tokens from ``numpy.random.default_rng(0)``)
    streamed in dynamic mode, 2 chunks, chunked and persistent: 192 B6
    calls a stream, activations bit-identical to the static run, to
    ``pipeline_reference`` and (as logits) to
    ``pipeline_forward_reference``, the logits within phases 13-14's rule of
    ``LM.forward`` at batch 4; a durable stream resumed by a fresh program
    from its chunk-1 snapshot, bit-identical; walls and tokens/s.  Phase
    12 also holds B6 at batch 1 (x (1, 4096, 48, 64)) against its plain
    version and times it.
    Phase 4 also checks that ``runtime_mode=RuntimeMode.STATIC_DAL`` refuses DPD's
    dynamic network in static, dynamic and megakernel mode, and runs its
    static all-10 rows under it.
24. (run after 14's smoke config and 19-21) training on the card
    (ROADMAP A13a), mamba2-780m at its published widths (48 SSD layers, d
    1536, 48 heads of 64, state 128, vocab 50 280, 0.86 B parameters;
    weights from seed 0, data ``SyntheticLM`` seed 0): (a) cut to
    ``TRAIN_CUT`` layers, one ``LM.train_loss`` and backward of a 2 x 512
    batch (``kernel_impl="xla"``: no kernel launches, counted) on the card
    and on the CPU on the same weights, ce within ``CE_REL`` and every
    gradient row within ``GRAD_ROW_SENS`` times the CPU model's own change
    under a bf16 step at its embedded input (the CPU tests' bars), the
    worst leaf printed; one ``train_step`` whole and one in 2 microbatches
    (float32 grads, no warmup): each step's gradient, read from its first
    AdamW moment, under the same row rule against the CPU's (the
    microbatched one against the whole batch's), ``grad_norm`` within the
    rule's norm, and AdamW on the card within the CPU tests' bars of the
    CPU's on the same inputs; (b) full depth through
    ``Trainer``: 8 steps of 8 x 2048 tokens (AdamW lr 1e-3, warmup 2,
    remat, bf16 grads, a checkpoint every 4 steps into a temporary
    directory), each loss (finite; the last two's mean at least 0.2 below
    the first), the median step time over steps 2-8, tokens/s and the peak
    memory; one more step profiled (its busy share, launches and the device
    time of its ``train_step.loss_and_grad`` and ``train_step.adamw``
    spans, all from that step); (c) at the cut, a
    failure injected at step 6 and recovered from the step-4 checkpoint
    against an uninterrupted run, under deterministic algorithms: params
    bit for bit or within rtol = atol = 1e-5; (d) (b)'s trained weights
    served: one prefill of phase 14's first 4 prompts (left-padded to
    4096) through B6 (48 launches, counted) and through the plain
    versions, the logits within phase 14's rule (``LOGIT_SENS`` times the
    plain run's change under a bf16 step at its embedded input, at least
    ``LOGIT_TOL``).
25. (run last) the multi-device runtime (ROADMAP A12): each sub-phase
    in k ranks spawned on this one card (``repro_torch.launch.group.
    spawn_group``: a gloo group through a ``file://`` rendezvous, rings
    staged through host buffers, a deadline; a failure in any rank fails
    the run), the kernels built by phase 1 before the spawn: (a) phase 3's
    DPD at ``devices`` 1 (this process), 2 and 4: every rank's state bit
    for bit the single-process run's (sha256 per leaf), fire counts equal,
    B1's launches summed over the ranks 398; rounds, collective bytes per
    sweep, the wall (median of ``SHARD_RUNS`` after a warm-up) and each
    rank's B1 launches; at 2 ranks ``device_assign`` and guards plus trace
    (clean, merged trace counts equal to the fire counts); (b)
    recurrentgemma-2b through ``ActorEngine(plan=ExecutionPlan(devices=2))``
    on phase 22's closed loop, tokens bit for bit the single-device
    ActorEngine's (rank 0), B5 and B7 launches summed equal to its, walls
    in turns; (c) mamba2-780m through ``pipeline_forward``, 4 stages of 12
    layers on 4 ranks, 4 microbatches of 4096 tokens: every rank's logits
    bit for bit ``pipeline_forward_reference`` run in one process (rank 0,
    the others waiting; in turns, for the walls), 48 B6 calls a rank (192
    in all). DPD's runs also give each rank's host time by part (visit,
    exchange, flag, merge) (a ``phase 25 shard {...}`` line).

Every launch count is set to 0 just before each path is driven and read
just after; launches made to compare a kernel with its plain version or
to time it are outside those windows.  Every phase fails the run; nothing
is caught.  The line before the last
is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero with no result when no
CUDA device is visible.

``--b2 SRC`` times kernel B2 alone (as phases 6 and 9 do, and its
``MK_GUARDS`` build as phase 17 does, where that tree has it) from the
``repro_torch`` package under ``SRC`` and prints one ``b2 {...}`` line;
``--b2-split SRC`` prints phase 16's split from ``SRC`` (a ``b2_split
{...}`` line; the tree's wrapper must take ``clock_split``);
``--b5 SRC``, ``--b6 SRC`` and ``--b7 SRC`` do the same for B5, B6 and
B7 (as phase 12 does; a ``b5 {...}``, ``b6 {...}`` or ``b7 {...}``
line).  ``--b1 SRC`` and ``--b3 SRC`` print B1's and B3's graph-replay
time, their wrapper's time per call, the ``copy_`` yardstick over the
same bytes and the launch floor, and the warm wall of the host-mode path
that launches them (DPD / motion detection in dynamic mode, median of 7;
a ``b1 {...}`` or ``b3 {...}`` line).  ``--b4 SRC`` prints B4's
graph-replay and wrapper time on phase 7's float frames beside
``torch.add`` over the same bytes and the launch floor, and, where that
tree's B4 takes u8 frames, the same on u8 frames and the R probe: B4 built
for R = 1, 2, 4 and 8 rows a thread, each checked and timed (a ``b4
{...}`` line).  Run in turns from two
trees they compare a kernel across commits on one card.
``--lm`` runs phases 1, 12-15, 19-22, 23(c) and 24 only (the LM path), for
work on it; ``--train`` runs phases 1 and 24 (building B6 only) and prints
phase 24's record before the last line; ``--shard`` runs phases 1 and 25
(building B1, B5, B6 and B7) and prints phase 25's record before the last
line.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# The card's published rates (H100 SXM data sheet, dense): memory
# bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12     # tensor cores, dense

BLOCK_L = 32768
N_FIRINGS = 64
REL_TOL = 1e-5          # |Δ| <= REL_TOL * max|y_ref|, per plane
KERNEL_TOL = 2e-3       # rtol = atol of tests/test_kernels.py
GAUSS_RTOL, GAUSS_ATOL = 1e-5, 1e-3   # B3 on float frames, tests/test_kernels.py:20

MD_FRAMES, MD_RATE, MD_HW = 960, 4, (240, 320)
GAUSS_FLOP_PER_PX = 20  # separable 5 + 5 multiply-adds per interior pixel

# LM serving (phases 12-15).
LM_REQUESTS, LM_BATCH, LM_PROMPT, LM_NEW = 8, 4, 4096, 32
LM_PROMPT_MIN = 2048       # prompt lengths drawn in LM_PROMPT_MIN..LM_PROMPT
PARITY_BATCH, PARITY_PROMPT, PARITY_NEW = 2, 256, 4
# B5 (bf16 out): |got - want| <= 2^-7 |want| + B5_ROW_TOL * rms, rms the
# RMS of want's (batch, position, head) row: one bf16 step at |want| (the
# two sides may round to neighbours), plus a term in the row's own scale
# (a softmax average over n keys shrinks as n^-1/2, and so does the error
# of its bf16-rounded weights).  B5_ROW_TOL, MIX_ROW_TOL and LOGIT_SENS
# are each the smallest power of two at least twice the largest reading of
# sound runs on an H100 (B5 0.0081; PERF.md has every reading); phase 12
# also checks that planted faults break B5's bar (they read 1.8-2.8).
B5_ROW_TOL = 2.0 ** -5
B5_FAULT_TILE = 2048       # the planted skipped key tile starts here
B6_TOL = 3e-4       # of max|ref|: tests/test_kernels.py:92; y (bf16) also
                    # gets one bf16 step at |y|: two float32 values that
                    # differ in the last bits may round to neighbours
# Full-width parity, card vs CPU (phases 13-14).  Each mixer's and each
# MLP's output, fed the CPU's input: |d| <= 2^-7 |ref| + MIX_ROW_TOL * rms
# of ref's (batch, position) row (readings up to 0.022).  Logits at every
# prompt position: within LOGIT_SENS times the CPU model's own change when
# its embedded prompt moves one bf16 step (readings up to 1.26 times it),
# and never below LOGIT_TOL (tests/test_torch_lm.py's bar).
MIX_ROW_TOL = 2.0 ** -4
LOGIT_SENS = 4.0
LOGIT_TOL = 3e-2
# MoE layers in the parity run (phase 19): the router's logits on the card
# (float32 product of the bf16 operands) within MOE_LOGIT_TOL of their
# largest magnitude of the CPU's (the same rule; reading 2.47e-7 on an
# H100); olmoe-1b-7b's parity model is cut to PARITY_MOE_LAYERS layers (the
# CPU's time), same widths.
MOE_LOGIT_TOL = 2.0 ** -20
PARITY_MOE_LAYERS = 4
# B5's float32 and f16 route against the plain version (float32 softmax):
# float32 within rtol = atol = 2e-4 (tests/test_kernels.py's float32 bar);
# f16 within one f16 step at |want| (2^-10 |want|: two float32 results that
# differ in the last bits may round to neighbouring f16 values) plus
# B5_F16_ROW_TOL of the row's RMS.  B6's f16 output likewise gets one f16
# step at |y|.
B5_F32_TOL = 2e-4
B5_F16_ROW_TOL = 2.0 ** -10
A7_TRACE_CAPACITY = 4096   # the reference's TRACE_CAPACITY_DEFAULT
# Phase 18: the MoE actor network at one olmoe-1b-7b layer's widths, N
# tokens a firing.  MOE_Y_TOL bounds B2's output against the host dynamic
# run's (torch.matmul bodies) in units of max|y|: the smallest power of two
# at least twice the largest sound reading (3.21e-6 on an H100, PERF.md).
MOE_N, MOE_FIRINGS = 512, 8
MOE_Y_TOL = 2.0 ** -17
# Phases 20-21: the audio and vision families.  Prompt lengths (drawn in
# the first..second, left-padded to the second): whisper's decoder prompts
# plus the 32-token budget stay inside its 448-token text context;
# internvl's text plus its 256 vision embeddings make S = 4096, as in
# phases 13, 14 and 19.  whisper's parity model is cut to
# PARITY_FAMILY_LAYERS decoder and encoder layers (the CPU's time).
FAMILY_PROMPTS = {"whisper-small": (64, 384), "internvl2-1b": (1792, 3840)}
PARITY_FAMILY_LAYERS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def plane_rel_err(ref: np.ndarray, got: np.ndarray) -> float:
    """max |got - ref| / max |ref| over each (re, im) plane; the worst plane."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    if ref.ndim >= 2 and ref.shape[-2] == 2:
        planes = [(ref[..., p, :], got[..., p, :]) for p in range(2)]
    else:
        planes = [(ref, got)]
    worst = 0.0
    for r, g in planes:
        scale = np.abs(r).max() if r.size else 0.0
        err = np.abs(g - r).max() if r.size else 0.0
        worst = max(worst, err / scale if scale else err)
    return worst


def cuda_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def graph_ms(fn, copies: int = 1, reps: int = 5, inner: int = 20) -> float:
    """Per-call device time of ``fn``'s launches: ``copies`` calls captured
    once in a CUDA graph and replayed, so the host wrapper's time is out of
    the number and the graph's own launch is shared by the copies."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            fn()
    return cuda_ms(graph.replay, reps, inner) / copies


def yardsticks(shape: tuple, dtype, dev) -> tuple:
    """``(copy_ ms, launch floor ms)``, both by CUDA graph replay as the
    kernels are timed: ``copy_`` of a ``shape`` tensor of ``dtype`` into
    another (a kernel's bytes read and written, by one of PyTorch's own
    kernels), and a one-element ``zero_()``, the least one launch costs in
    that replay loop."""
    src = torch.zeros(shape, dtype=dtype, device=dev)
    dst = torch.empty_like(src)
    one = torch.zeros(1, device=dev)
    return (graph_ms(lambda: dst.copy_(src), copies=10),
            graph_ms(lambda: one.zero_(), copies=10))


def add_ms(cur: torch.Tensor, prev: torch.Tensor) -> float:
    """B4's yardstick by CUDA graph replay: ``torch.add(cur, prev, out=o)``
    into a float32 ``o``, which reads the two input planes and writes one
    float32 plane, B4's bytes exactly (for float32 and for u8 frames)."""
    o = torch.empty(cur.shape, dtype=torch.float32, device=cur.device)
    return graph_ms(lambda: torch.add(cur, prev, out=o), copies=10)


def md_kernel_frames(dev) -> tuple:
    """Phase 7's frames, (MD_RATE, 240, 320) from ``default_rng(0)``: u8
    frames whose frame 0 is built to blur to exact .5 values (isolated
    128s give 128/256 = 0.5 at their corners, 64s give 64 * 6/256 = 1.5
    beside them), float frames and a second float set moved by noise of
    scale 45, and a second u8 set moved by up to +-80: ``(x_u8, x_f, prev_f,
    prev_u8)``."""
    shape = (MD_RATE,) + MD_HW
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, shape).astype(np.uint8)
    frames[0] = 0
    frames[0, 4::9, 4::11] = 128
    frames[0, 8::9, 8::11] = 64
    x_f = torch.tensor(rng.uniform(0, 255, shape).astype(np.float32), device=dev)
    prev_f = torch.clamp(x_f + torch.tensor(
        rng.normal(scale=45.0, size=shape).astype(np.float32), device=dev), 0, 255)
    prev_u8 = np.clip(frames.astype(np.int16) + rng.integers(-80, 81, shape), 0, 255)
    return (torch.tensor(frames, device=dev), x_f, prev_f,
            torch.tensor(prev_u8.astype(np.uint8), device=dev))


def profile_run(run) -> tuple:
    """Device time by kernel of one ``run()`` under ``torch.profiler``:
    ``(total device ms, [(name, count, device ms), ...] by time, wall ms
    of the run)``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("the profiler saw no device time")
    events.sort(key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in events) / 1e3,
            [(e.key[:80], e.count, e.self_device_time_total / 1e3) for e in events],
            wall)


def profile_program(prog, runs: int) -> tuple:
    """:func:`profile_run` over ``runs`` runs of ``prog`` from fresh states
    made beforehand: ``(device ms per run, kernels, wall ms per run, B2 ms
    of each launch)``.

    Every launch of B2 in these runs is bracketed by CUDA events, and in
    megakernel mode (one B2 launch per run, no other kernel) a run's
    device time is its launch's time by those events: the profiler has
    dropped single B2 launches on an H100, so its list is kept as the
    breakdown only.  The run's two small copies are left out of it.

    The runner's module is given a timing wrapper for these runs; the
    wrapped launcher counts its launches under its own module-level name,
    so the wrapper carries that count and hands it back."""
    from repro_torch.core.megakernel import kernel as mk
    states = [prog.init_state() for _ in range(runs)]
    launch, events = mk.megakernel_cuda, []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*args, **kw)
        end.record()
        events.append((start, end))

    def run():
        for st in states:
            prog.run(st, in_place=True)

    timed.launches = launch.launches
    timed.build_launches = launch.build_launches
    mk.megakernel_cuda = timed
    try:
        device_ms, kernels, wall = profile_run(run)
    finally:
        mk.megakernel_cuda = launch
        launch.launches = timed.launches
        launch.build_launches = timed.build_launches
    b2_ms = [start.elapsed_time(end) for start, end in events]
    if prog.plan.mode == "megakernel":
        if len(b2_ms) != runs:
            fail(f"{len(b2_ms)} B2 launches in {runs} megakernel runs")
        device_ms = sum(b2_ms)
    return device_ms / runs, kernels, wall / runs, b2_ms


def b2_timed(net, dev, clock_split: bool = False, guards: bool = False,
             trace: bool = False) -> tuple:
    """B2's own time per run of ``net``: launches back to back on a staged
    argument block, reset before each launch, so the runner's staging is
    out of it (the rings keep the last run's bytes, which changes no work:
    forwarded rings are re-zeroed by the kernel and the same bodies run on
    the same windows).  ``clock_split`` times the build that writes the
    clock split instead; ``guards`` and ``trace`` the health builds (a ring
    of ``A7_TRACE_CAPACITY`` events).  Returns ``(ms, meta words after the
    last launch)``."""
    from repro_torch.core.megakernel import compile_megakernel, megakernel_cuda
    from repro_torch.core.megakernel.program import stage
    dp = compile_megakernel(net).device_program
    # (An older tree's stage takes no health words: pass them only when used.)
    extra = {"health_words": True} if guards or trace else {}
    consts = ([t.to(dev) for _, t in dp.consts]
              + [torch.zeros(n, device=dev) for _, n in getattr(dp, "scratch", ())])
    tensors, io = stage(dp, net.init_state(), dev, consts, **extra)
    args0 = torch.tensor([0 if t is None else t.data_ptr() for t in tensors] + io,
                         dtype=torch.int64, device=dev)
    args = args0.clone()
    table = dp.table.to(dev)

    kw = {"clock_split": True} if clock_split else {}
    # (An older tree's wrapper sizes shared memory from the pointers alone.)
    if "n_actors" in inspect.signature(megakernel_cuda).parameters:
        kw.update(n_actors=dp.n_actors, scratch_words=int(dp.table[10]),
                  moe=bool(dp.table[11]))
    if guards or trace:
        kw.update(io_len=dp.io_len, guards=guards)
    if trace:
        kw["trace"] = torch.zeros((A7_TRACE_CAPACITY, 3 + dp.n_fifos), dtype=torch.int32,
                                  device=dev)

    def launch():
        args.copy_(args0)
        megakernel_cuda(table, args, dp.n_ptrs, 1_000_000, True, **kw)

    ms = cuda_ms(launch, reps=7, inner=5)
    return ms, args[dp.n_ptrs + dp.io_meta:].cpu().tolist()


def b2_split(net, dev) -> dict:
    """B2's clock split per run of ``net``: the build with the split
    counters timed as :func:`b2_timed` times B2, and block 0's cycles in
    its last run by where its body threads were: waiting for the scheduler
    (``sched``: today a step it takes alone, once a scheduler warp runs
    ahead the ring running dry), waiting on other blocks (``wait``: grid
    barriers, or dependency waits, ``waits`` of them) and the rest
    (``body``); each share of the loop also as ms of the timed run, and
    where the kernel splits them, the bodies' ms and count by kind and the
    scheduler warp's ms deciding and waiting for a free command slot."""
    from repro_torch.core.megakernel.kernel import decode_clock_split
    ms, meta = b2_timed(net, dev, clock_split=True)
    sp = decode_clock_split(meta)
    loop = sp["loop"]
    cycles = {"sched": sp["stall_sched"], "wait": sp["stall_wait"],
              "body": loop - sp["stall_sched"] - sp["stall_wait"]}
    share = {k: v / loop for k, v in cycles.items()}
    rec = {"ms": ms, "loop_cycles": loop, "waits": sp["waits"],
           "cycles": cycles, "share": share,
           "ms_split": {k: v * ms for k, v in share.items()},
           "sweeps": meta[0]}
    if "bodies" in sp:  # a tree whose kernel also splits the bodies by kind
        rec["bodies_ms"] = {k: {"ms": b["cycles"] / loop * ms, "count": b["count"]}
                            for k, b in sp["bodies"].items() if b["count"]}
        rec["scheduler_ms"] = {"busy": sp["sched_busy"] / loop * ms,
                               "ring_full": sp["sched_full"] / loop * ms}
    return rec


def diag_key(d) -> tuple:
    """Everything a Diagnostics decodes, as plain values."""
    faults = tuple((f.fifo, f.src_actor, f.dst_actor, int(f.bits), f.faults,
                    int(f.high_water)) for f in d.faults)
    stall = None if d.stall is None else (d.stall.runnable, d.stall.blocked)
    return (bool(d.ok), bool(d.stalled), faults, dict(d.high_water), stall)


#: A domain every sample of DPD's staged normal signal lies in (phase 17's
#: fifth fault puts one window of 1e3 outside it).
F_IN_DOMAIN = (-16.0, 16.0)


def with_domain(net, domains: dict):
    """``net`` with each channel of ``domains`` declaring its domain."""
    import dataclasses
    from repro_torch.core import Network
    fifos = [dataclasses.replace(s, domain=domains[n]) if n in domains else s
             for n, s in net.fifos.items()]
    return Network(list(net.actors.values()), fifos, list(net.edges),
                   initial_tokens=net.initial_tokens, device=net.device)


def state_bits(state) -> list:
    """Every leaf of a state as bytes (NaN compares by its bits)."""
    return [x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            if isinstance(x, torch.Tensor) else x for x in state.leaves()]


def a7_phase(dev, smi: str, zero_counts, expect_counts, dpd: tuple, md: tuple,
             bounds: dict) -> list:
    """Phase 17: guards, trace and fault injection at full width.  ``dpd``
    and ``md`` are ``(network, phase-3 / phase-8 result, launches of that
    dynamic run)``; ``bounds`` each network's B2 ``(bound_ms, bound_by)``.
    Returns the kernels line's records of B2's three health builds."""
    from repro_torch.core import ExecutionPlan
    from repro_torch.core.executor import run_dynamic
    from repro_torch.core.faultinject import (corrupt_cursor, inject_overflow,
                                              inject_underflow, poison_tokens)
    from repro_torch.core.health import (CURSOR_INVALID, DOMAIN, NONFINITE, OVERFLOW,
                                         UNDERFLOW, decode_health, fault_names)
    from repro_torch.core.megakernel import (compile_megakernel, lower_network,
                                             megakernel_cuda, partition_layout)
    from repro_torch.core.trace import decode_trace
    from repro_torch.graphs.factories import states_equal

    builds = {"guards": (True, False), "trace": (False, True), "guards+trace": (True, True)}
    launches = {b: 0 for b in builds}
    rec: dict = {"card": smi}
    for label, (net, base, dyn_launches) in (("dpd", dpd), ("md", md)):
        # Host dynamic, guarded and traced: phase 3's / 8's launches and state.
        prog = net.compile(ExecutionPlan(mode="dynamic", guards=True, trace=True))
        torch.cuda.synchronize()
        zero_counts()
        dyn = prog.run()
        torch.cuda.synchronize()
        expect_counts(f"A7 {label} dynamic guarded+traced", dyn_launches)
        if (dyn.sweeps, dyn.fire_counts) != (base.sweeps, base.fire_counts) \
                or not states_equal(dyn.state, base.state):
            fail(f"A7 {label}: the guarded, traced dynamic run differs from the unguarded one")
        want_diag, want_ev = diag_key(dyn.diagnostics), dyn.trace.events
        if not dyn.diagnostics.ok:
            fail(f"A7 {label}: a clean run reads {dyn.diagnostics.summary()}")
        for cores in (1, 2):
            for build, (g, t) in builds.items():
                prog = net.compile(ExecutionPlan(mode="megakernel", cores=cores, guards=g,
                                                 trace=t))
                torch.cuda.synchronize()
                zero_counts()
                res = prog.run()
                torch.cuda.synchronize()
                expect_counts(f"A7 {label} megakernel cores={cores} {build}", {"B2": 1})
                if megakernel_cuda.build_launches != {build: 1}:
                    fail(f"A7 {label}: launches by build {megakernel_cuda.build_launches}")
                launches[build] += 1
                if (res.sweeps, res.fire_counts) != (base.sweeps, base.fire_counts) \
                        or not states_equal(res.state, base.state):
                    fail(f"A7 {label} cores={cores} {build}: state differs from phase 3/8")
                if g and diag_key(res.diagnostics) != want_diag:
                    fail(f"A7 {label} cores={cores} {build}: diagnostics differ")
                if t and not np.array_equal(res.trace.events, want_ev):
                    fail(f"A7 {label} cores={cores} {build}: trace differs")
            # B2's plain version on the card, guarded and traced.
            runner = compile_megakernel(net, cores=cores, guards=True,
                                        trace_capacity=A7_TRACE_CAPACITY)
            st = net.init_state()
            pr = runner.plain(st)
            torch.cuda.synchronize()
            if not states_equal(st, base.state) \
                    or diag_key(decode_health(net, pr.health, pr[3])) != want_diag \
                    or not np.array_equal(decode_trace(net, pr.trace).events, want_ev):
                fail(f"A7 {label} cores={cores}: B2's plain version differs")
        rec[label] = {"events": int(len(want_ev)),
                      "dropped": int(dyn.trace.dropped),
                      "attempts": int(sum(dyn.trace.attempt_counts().values())),
                      "high_water": dyn.diagnostics.high_water}
        log(f"A7 {label} clean, guarded and traced: host dynamic, B2 (3 builds, cores 1 "
            f"and 2) and its plain version agree; states bit-identical to the unguarded "
            f"runs; {len(want_ev)} trace events kept, {dyn.trace.dropped} dropped")

    # Faults on DPD's f_in: B2 (no channel forwarded), plain, host dynamic.
    # The fifth (C11) runs DPD with f_in declaring a domain every clean
    # sample lies in, and one finite window of 1e3 appended.
    dom_net = with_domain(dpd[0], {"f_in": F_IN_DOMAIN})
    faults = {"overflow": (inject_overflow, OVERFLOW, dpd[0]),
              "underflow": (inject_underflow, UNDERFLOW, dpd[0]),
              "cursor": (lambda n, s, f: corrupt_cursor(n, s, f, occ=1), CURSOR_INVALID,
                         dpd[0]),
              "nonfinite": (poison_tokens, NONFINITE, dpd[0]),
              "domain": (lambda n, s, f: poison_tokens(n, s, f, value=1e3), DOMAIN, dom_net)}
    fault_rec = {}
    for name, (inject, bit, net) in faults.items():
        layout = lower_network(net)
        bad = inject(net, net.init_state(), "f_in")
        sides = {}
        dres = run_dynamic(net, bad.clone(), guards=True, trace_capacity=A7_TRACE_CAPACITY)
        sides["dynamic"] = dres
        for cores in (1, 2):
            runner = compile_megakernel(
                net, layout=layout, guards=True, trace_capacity=A7_TRACE_CAPACITY,
                partition=partition_layout(net, layout, cores, forward_transients=False))
            sides[f"b2_cores{cores}"] = runner(bad.clone())
            sides[f"plain_cores{cores}"] = runner.plain(bad.clone())
        torch.cuda.synchronize()
        keys = {k: (diag_key(decode_health(net, r.health, r[3], r[0] if r[3] else None)),
                    np.asarray(r.trace.ring).tobytes() if not isinstance(r.trace.ring, torch.Tensor)
                    else r.trace.ring.cpu().numpy().tobytes(), r.trace.count,
                    state_bits(r[0]), r[1], r[2])
                for k, r in sides.items()}
        first = keys["dynamic"]
        for k, v in keys.items():
            if v != first:
                parts = [n for n, a, b in zip(("diagnostics", "trace ring", "events",
                                               "state", "counts", "sweeps"), v, first)
                         if a != b]
                fail(f"A7 fault {name}: {k} differs from the host dynamic run in {parts}")
        named = {f[0]: f[3] for f in first[0][2]}
        if "f_in" not in named or not set(fault_names(bit)) <= set(fault_names(named["f_in"])):
            fail(f"A7 fault {name}: f_in not named with {fault_names(bit)}: {named}")
        fault_rec[name] = {"faulting_channels": {k: list(fault_names(v))
                                                 for k, v in named.items()},
                           "events": int(first[2]), "sweeps": int(first[5])}
    rec["faults"] = fault_rec
    log("A7 faults on f_in, host dynamic == B2 (cores 1, 2) == plain, bit for bit: "
        + json.dumps(fault_rec))

    # B2's time per run, main build and the three health builds, in turns.
    times = {label: {b: [] for b in ("main", *builds)} for label in ("dpd", "md")}
    order = ("main", "guards", "trace", "guards+trace")
    for label, n in (("dpd", dpd[0]), ("md", md[0])):
        for build in order + order[::-1]:
            g, t = builds.get(build, (False, False))
            times[label][build].append(b2_timed(n, dev, guards=g, trace=t)[0])
    med = {label: {b: float(np.median(v)) for b, v in bt.items()} for label, bt in times.items()}
    rec["b2_ms"] = times
    log(f"A7 B2 timing ({smi}), ms per run, in turns main, guards, trace, both, then "
        f"back: " + json.dumps(times))
    log("a7 " + json.dumps(rec))
    out = []
    for build, (g, t) in builds.items():
        runner = compile_megakernel(dpd[0], guards=g,
                                    trace_capacity=A7_TRACE_CAPACITY if t else None)
        st = dpd[0].init_state()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        runner.plain(st)
        end.record()
        torch.cuda.synchronize()
        out.append({"name": f"megakernel.b2_{build.replace('+', '_')}", "route": "cuda",
                    "source": "src/repro_torch/csrc/megakernel.cu",
                    "replaces": "src/repro/core/megakernel/kernel.py:780",
                    "function": f"compile_megakernel({', '.join(('guards=True',) * g + ('trace_capacity=N',) * t)})",
                    "build": build, "launches": launches[build], "max_abs_err": 0.0,
                    "ms": med["dpd"][build], "main_build_ms": med["dpd"]["main"],
                    "plain_ms": start.elapsed_time(end),
                    "bound_ms": bounds["dpd"][0], "bound_by": bounds["dpd"][1],
                    "library_ms": None, "network": "dpd",
                    "motion_detection": {"ms": med["md"][build],
                                         "main_build_ms": med["md"]["main"],
                                         "bound_ms": bounds["md"][0]}})
    return out


def moe_phase(dev, smi: str, zero_counts, expect_counts) -> dict:
    """Phase 18: the MoE actor network (``graphs/moe_as_actors.py``) at one
    olmoe-1b-7b layer's published widths (D 2048, 64 experts, top-8, F
    1024, capacity factor 1.25; N = 512 tokens a firing, 8 firings, C =
    80), weights from ``moe_init`` on seed 0, the token stream from numpy
    seed 0.  The host dynamic mode (torch bodies), B2 at cores 1 and 2 and
    B2's guarded and traced builds: fire counts, sweeps and cursors equal;
    counts and slots equal under the margin rule; B2's output within
    MOE_Y_TOL of the host run's; B2 against its plain version bit for bit
    at make_moe's width and at D 256 / E 8; B2 timed beside its bound."""
    from repro_torch.configs import get_config
    from repro_torch.core.megakernel import compile_megakernel, megakernel_cuda
    from repro_torch.core.megakernel.ref import moe_logits
    from repro_torch.graphs.factories import make_moe, states_equal
    from repro_torch.graphs.moe_as_actors import build_moe_network
    from repro_torch.models.moe import capacity_for, moe_init, route, router_logits
    t_phase = time.perf_counter()
    cfg = get_config("olmoe-1b-7b")
    D, E, k, Fd = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert
    cf = cfg.moe.capacity_factor
    C = capacity_for(MOE_N, E, k, cf)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = moe_init(D, E, Fd, gen, device=dev)
    xs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(MOE_FIRINGS * MOE_N, D)).astype(np.float32)).to(dev)
    net = build_moe_network(params, MOE_N, D, k, cf, MOE_FIRINGS, xs, device=dev)

    # ---- the host dynamic mode: torch bodies on the card ---------------- #
    dyn_prog = net.compile(mode="dynamic")
    st = dyn_prog.init_state()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    dyn = dyn_prog.run(st, in_place=True)
    torch.cuda.synchronize()
    dyn_cold = (time.perf_counter() - t0) * 1e3
    expect_counts("MoE dynamic", {})
    dyn_walls = warm_wall_ms(dyn_prog, runs=3)
    dyn_device, dyn_kernels, _, _ = profile_program(dyn_prog, 1)
    y_host = dyn.state.actor("sink")[0]
    ymax = float(y_host.abs().max())
    if not bool(torch.isfinite(y_host).all()) or ymax == 0.0:
        fail("MoE dynamic: the output is not finite or all zero")

    # ---- routing on both backends' logits: the margin rule -------------- #
    under, logit_diff, enabled = [], 0.0, []
    for f in range(MOE_FIRINGS):
        x = xs[f * MOE_N:(f + 1) * MOE_N]
        lh = router_logits(params["router"], x)
        lb = moe_logits(x, params["router"])
        d = float((lh - lb).abs().max())
        logit_diff = max(logit_diff, d)
        srt = torch.sort(lh, dim=-1, descending=True).values
        margin = srt[:, k - 1] - srt[:, k]
        under.append(int((margin <= 2 * d).sum()))
        r = route(lh, k)
        kept = (r.rank < C)
        counts = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
            0, r.gate_e[kept], torch.ones_like(r.gate_e[kept]))
        enabled.append(int((counts > 0).sum()))
    log(f"phase 18 router margin: {sum(under)} of {MOE_FIRINGS * MOE_N} tokens have a "
        f"top-{k} margin at most twice the largest logit difference {logit_diff:.3g} "
        f"(host torch.matmul vs B2's ordered sums), per firing {under}")

    def ring_ints(state):
        return {n: state.fifo(n).buf.cpu().clone() for n, sp in net.fifos.items()
                if sp.dtype == torch.int32}

    # ---- B2, main build, cores 1 and 2 ---------------------------------- #
    rec = {"card": smi, "N": MOE_N, "firings": MOE_FIRINGS, "D": D, "E": E, "k": k,
           "F": Fd, "C": C, "sweeps": dyn.sweeps, "tokens_under_margin": sum(under),
           "router_logit_max_diff": logit_diff, "enabled_experts": enabled,
           "host_dynamic": {"cold_wall_ms": dyn_cold, "warm_walls_ms": dyn_walls,
                            "device_ms": dyn_device,
                            "top": [{"kernel": kk, "count": n, "device_ms": ms}
                                    for kk, n, ms in dyn_kernels[:5]]}}
    y_err = 0.0
    launches = None
    for cores in (1, 2):
        prog = net.compile(mode="megakernel", cores=cores)
        st = prog.init_state()
        torch.cuda.synchronize()
        zero_counts()
        res = prog.run(st, in_place=True)
        torch.cuda.synchronize()
        got = expect_counts(f"MoE megakernel cores={cores}", {"B2": 1})["B2"]
        launches = got if launches is None else launches
        if (res.sweeps, res.fire_counts) != (dyn.sweeps, dyn.fire_counts):
            fail(f"MoE megakernel cores={cores}: sweeps {res.sweeps} counts "
                 f"{res.fire_counts} vs {dyn.sweeps} {dyn.fire_counts}")
        for a, b in zip(res.state.fifos, dyn.state.fifos):
            if (a.rd, a.wr, a.occ) != (b.rd, b.wr, b.occ):
                fail(f"MoE megakernel cores={cores}: cursors differ")
        y = res.state.actor("sink")[0]
        if not bool(torch.isfinite(y).all()):
            fail(f"MoE megakernel cores={cores}: non-finite output")
        y_err = max(y_err, float((y - y_host).abs().max()) / ymax)
    if y_err > MOE_Y_TOL:
        fail(f"MoE megakernel: output {y_err:.3g} * max|y| from the host run "
             f"(> {MOE_Y_TOL:.3g})")
    # Integer tokens (slots, counts, the packed token) where the state keeps
    # them: the unspecialized program keeps every ring.
    un = net.compile(mode="megakernel", specialize=False).run()
    want_ints = ring_ints(dyn.state)
    got_ints = ring_ints(un.state)
    last_two_clear = under[-1] == 0 and under[-2] == 0
    for name, want in want_ints.items():
        if not torch.equal(got_ints[name], want):
            if last_two_clear:
                fail(f"MoE megakernel: integer ring {name} differs from the host run "
                     "with every token of its firings over the margin")
            log(f"phase 18: integer ring {name} differs under a near-tie")
    log(f"phase 18 MoE megakernel ({smi}): sweeps {dyn.sweeps}, counts and cursors "
        f"equal the host run at cores 1 and 2; output within {y_err:.3g} * max|y| "
        f"(bar {MOE_Y_TOL:.3g}); integer rings "
        f"{'equal' if all(torch.equal(got_ints[n], w) for n, w in want_ints.items()) else 'differ under a near-tie'}")

    # ---- guarded and traced builds -------------------------------------- #
    dyn_gt = net.compile(mode="dynamic", guards=True, trace=True).run()
    for cores in (1, 2):
        prog = net.compile(mode="megakernel", cores=cores, specialize=False, guards=True,
                           trace=True)
        torch.cuda.synchronize()
        zero_counts()
        res = prog.run()
        torch.cuda.synchronize()
        expect_counts(f"MoE megakernel guarded+traced cores={cores}", {"B2": 1})
        if megakernel_cuda.build_launches != {"guards+trace": 1}:
            fail(f"MoE guarded+traced: builds {megakernel_cuda.build_launches}")
        if (res.sweeps, res.fire_counts) != (dyn.sweeps, dyn.fire_counts) \
                or not res.diagnostics.ok \
                or res.diagnostics.high_water != dyn_gt.diagnostics.high_water \
                or res.trace.attempt_counts() != dyn_gt.trace.attempt_counts() \
                or res.trace.n_events != dyn_gt.trace.n_events:
            fail(f"MoE guarded+traced cores={cores}: diagnostics or trace differ "
                 "from the host run")
    log(f"phase 18: B2's guarded and traced build on MoE equals the host run's "
        f"diagnostics and {dyn_gt.trace.n_events} trace events at cores 1 and 2")

    # ---- B2 against its plain version, bit for bit ---------------------- #
    bits = {}
    for label, kw in (("default", {}), ("middle", dict(d_model=256, n_experts=8))):
        small, _ = make_moe(3, seed=1, device=dev, **kw)
        runner = compile_megakernel(small)
        a = runner(small.init_state())      # (state, fire counts, sweeps, stalled)
        b = runner.plain(small.init_state())
        torch.cuda.synchronize()
        if not states_equal(a[0], b[0]) or tuple(a[1:3]) != tuple(b[1:3]):
            fail(f"MoE megakernel at the {label} width differs from its plain version")
        bits[label] = {"B2_ms": cuda_ms(lambda: runner(small.init_state()), reps=3, inner=3),
                       "plain_ms": cuda_ms(lambda: runner.plain(small.init_state()),
                                           reps=1, inner=1)}
    log(f"phase 18: B2 equals its plain version bit for bit at make_moe's width and at "
        f"D 256 / E 8 ({smi}): " + json.dumps(bits))

    # ---- B2's time and its bound ---------------------------------------- #
    b2_ms, meta = b2_timed(net, dev)
    if meta[0] != dyn.sweeps:
        fail(f"timed MoE B2 launches ran {meta[0]} sweeps")
    flops = float(sum(e * C * 3 * 2 * D * Fd for e in enabled)
                  + MOE_FIRINGS * 2 * MOE_N * D * E)
    nbytes = float(sum(e * 3 * D * Fd * 2 for e in enabled) + MOE_FIRINGS * D * E * 2
                   + 2 * MOE_FIRINGS * MOE_N * D * 4)
    bound, by = bound_of(nbytes, flops, FP32_FLOP_PER_S)
    log(f"phase 18 MoE timing ({smi}): B2 {b2_ms:.4f} ms per run (CUDA events), bound "
        f"{bound:.4f} ms ({by}: {flops:.4g} flop at 67 TFLOP/s; the weights' "
        f"{nbytes:.4g} B at 3.35 TB/s take {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
        f"host dynamic run warm {float(np.median(dyn_walls)):.2f} ms, device "
        f"{dyn_device:.3f} ms")
    rec.update({"launches": launches, "ms": b2_ms, "bound_ms": bound, "bound_by": by,
                "flops": flops, "bytes": nbytes, "y_err_over_max": y_err,
                "y_bar": MOE_Y_TOL, "plain_bits": bits,
                "phase_s": time.perf_counter() - t_phase})
    log("phase 18 moe " + json.dumps(rec))
    del net, dyn, params, xs
    torch.cuda.empty_cache()
    return rec


def warm_wall_ms(prog, runs: int = 5) -> list:
    """Wall times of ``runs`` warm runs of ``prog`` from fresh states."""
    walls = []
    for _ in range(runs):
        st = prog.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.run(st, in_place=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def max_abs_diff(a, b) -> float:
    """The largest elementwise difference between two states' leaves."""
    from repro_torch.convert import state_to_numpy
    return max((float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max())
                for x, y in zip(state_to_numpy(a), state_to_numpy(b)) if x.size),
               default=0.0)


def first_diff(a, b) -> list:
    """Indices of the leaves in which two states differ."""
    from repro_torch.convert import state_to_numpy
    return [i for i, (x, y) in enumerate(zip(state_to_numpy(a), state_to_numpy(b)))
            if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y)]


def bound_of(nbytes: float, flops: float, flop_rate: float) -> tuple:
    """(least ms for ``nbytes`` of memory traffic and ``flops`` at
    ``flop_rate``, which of the two bounds it)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / flop_rate * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def b1_phase(dev, smi: str) -> dict:
    """Phase 2: kernel B1 against its plain version at the main path's L,
    orders 1..10, bit for bit (``torch.equal`` on the output and the next
    history) and within ``REL_TOL`` and ``KERNEL_TOL``, on a 16-byte-aligned
    window (the main path's ring slots are aligned) and on a view 36 bytes
    off one with a row stride of L + 9.  Times, per launch and averaged over
    the ten orders (the main path mixes them): the kernel by CUDA graph
    replay on each window, so the wrapper's host time is out of it; the
    wrapper per call back to back; the plain version; and the yardsticks.
    Returns the kernels line's record (without the launches)."""
    from repro_torch.kernels.dyn_fir import N_TAPS, poly_branch, poly_ref
    rng = np.random.default_rng(0)
    L = BLOCK_L
    x = torch.tensor(rng.normal(size=(2, L + N_TAPS - 1)).astype(np.float32), device=dev)
    taps = torch.tensor(rng.normal(scale=0.3, size=(2, N_TAPS)).astype(np.float32),
                        device=dev)
    hist, view = x[:, :N_TAPS - 1], x[:, N_TAPS - 1:]
    win = view.contiguous()
    worst_rel = worst_abs = 0.0
    for label, w in (("aligned", win), ("36 bytes off", view)):
        for order in range(1, N_TAPS + 1):
            y, next_hist = poly_branch(hist, w, taps, order)
            p_y, p_next = poly_ref(hist, w, taps, order)
            torch.cuda.synchronize()
            if not torch.equal(next_hist, p_next):
                fail(f"dyn_fir order {order} ({label}): next history differs from "
                     "the plain version")
            g, r = y.cpu().numpy(), p_y.cpu().numpy()
            if not np.all(np.isfinite(g)):
                fail(f"dyn_fir order {order} ({label}): non-finite kernel output")
            np.testing.assert_allclose(g, r, rtol=KERNEL_TOL, atol=KERNEL_TOL)
            rel = plane_rel_err(r, g)
            if rel > REL_TOL:
                fail(f"dyn_fir order {order} ({label}): rel err {rel:.3g} > {REL_TOL}")
            if not torch.equal(y, p_y):
                fail(f"dyn_fir order {order} ({label}): {int((y != p_y).sum())} "
                     "samples differ from the plain version's bits")
            worst_rel = max(worst_rel, rel)
            worst_abs = max(worst_abs, float(np.abs(g - r).max()))
    log(f"dyn_fir kernel vs plain, L={L}, orders 1..10, aligned window and a view "
        f"36 bytes off: bit-identical (max_abs_err {worst_abs:.3g}, max rel "
        f"{worst_rel:.3g})")

    def all_orders(fn, w):
        return lambda: [fn(hist, w, taps, order) for order in range(1, N_TAPS + 1)]

    k_ms = graph_ms(all_orders(poly_branch, win)) / N_TAPS
    view_ms = graph_ms(all_orders(poly_branch, view)) / N_TAPS
    wrapper_ms = cuda_ms(all_orders(poly_branch, win)) / N_TAPS
    p_ms = cuda_ms(all_orders(poly_ref, win)) / N_TAPS
    copy_ms, floor_ms = yardsticks((2, L), torch.float32, dev)
    # Bound: each input byte read once (stream, taps), each output written
    # once (samples, next history).
    bytes_moved = 4 * (2 * (L + N_TAPS - 1) + 2 * N_TAPS + 2 * L + 2 * (N_TAPS - 1))
    mean_order = (N_TAPS + 1) / 2
    flops = L * (5 + (mean_order - 1) + 8 * N_TAPS)
    bound_ms, bound_by = bound_of(bytes_moved, flops, FP32_FLOP_PER_S)
    log(f"dyn_fir timing ({smi}): kernel {k_ms:.5f} ms/launch (CUDA graph "
        f"replay; the view 36 bytes off {view_ms:.5f}), wrapper {wrapper_ms:.5f} "
        f"ms/call back to back, plain {p_ms:.5f} ms/call, copy_ of the same "
        f"bytes {copy_ms:.5f} ms, launch floor {floor_ms:.5f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}: {bytes_moved} B, {flops:.0f} flop)")
    return {"max_abs_err": worst_abs, "max_err_rel": worst_rel, "ms": k_ms,
            "ms_view": view_ms, "wrapper_ms": wrapper_ms, "plain_ms": p_ms,
            "copy_ms": copy_ms, "floor_ms": floor_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def motion_detection(dev, smi: str, zero_counts, expect_counts) -> dict:
    """Phases 7-11; returns the kernels line's records of B3, B4 and B2's
    motion detection numbers."""
    from repro_torch.core.megakernel import compile_megakernel
    from repro_torch.graphs.factories import states_equal
    from repro_torch.graphs.motion_detection import bench_workload
    from repro_torch.kernels.gauss5x5 import (gauss5x5, gauss5x5_ref, gauss5x5_u8,
                                              gauss5x5_u8_ref)
    from repro_torch.kernels.motion_post import (motion_post, motion_post_cuda,
                                                 motion_post_ref)

    H, W = MD_HW
    shape = (MD_RATE, H, W)
    n_px = MD_RATE * H * W

    # ---- 7. B3 and B4 against their plain versions ---------------------- #
    x_u8, x_f, prev_f, prev_u8 = md_kernel_frames(dev)
    blurred = gauss5x5_ref(x_u8.to(torch.float32))
    ties = int(torch.count_nonzero(blurred - torch.floor(blurred) == 0.5))
    ties0 = int(torch.count_nonzero(blurred[0] - torch.floor(blurred[0]) == 0.5))
    if ties0 == 0:
        fail("B3: the tie frame blurs to no .5 value")
    got_u8, want_u8 = gauss5x5_u8(x_u8), gauss5x5_u8_ref(x_u8)
    torch.cuda.synchronize()
    if got_u8.dtype != torch.uint8 or not torch.equal(got_u8, want_u8):
        bad = int(torch.count_nonzero(got_u8 != want_u8))
        fail(f"B3 u8: {bad} pixels differ from the plain version")
    got_f, want_f = gauss5x5(x_f), gauss5x5_ref(x_f)
    torch.cuda.synchronize()
    g, r = got_f.cpu().numpy(), want_f.cpu().numpy()
    if not np.all(np.isfinite(g)):
        fail("B3 float: non-finite output")
    np.testing.assert_allclose(g, r, rtol=GAUSS_RTOL, atol=GAUSS_ATOL)
    b3_err = float(np.abs(g - r).max())
    # B4 bit for bit on float and u8 frames (u8 straight into the kernel:
    # one launch each) and at an odd shape, W % 4 != 0, which takes its
    # element path, for both types.
    odd = np.random.default_rng(1).integers(0, 256, (2, 3, 17, 13)).astype(np.uint8)
    b4_cases = [("float", x_f, prev_f), ("u8", x_u8, prev_u8)] + [
        (f"{dt} (3, 17, 13)", torch.tensor(odd[0], device=dev).to(dt),
         torch.tensor(odd[1], device=dev).to(dt)) for dt in (torch.float32, torch.uint8)]
    b4_err = 0.0
    for label, c, p in b4_cases:
        before = motion_post_cuda.launches
        got_m, want_m = motion_post(c, p), motion_post_ref(c.float(), p.float())
        torch.cuda.synchronize()
        if motion_post_cuda.launches != before + 1:
            fail(f"B4 {label}: {motion_post_cuda.launches - before} launches, not 1")
        if got_m.dtype != torch.float32 or not torch.equal(got_m, want_m):
            fail(f"B4 {label}: {int(torch.count_nonzero(got_m != want_m))} pixels "
                 "differ from the plain version")
        b4_err = max(b4_err, float((got_m - want_m).abs().max()))
    log(f"B3 vs plain on {shape}: u8 bit-identical ({ties} .5 ties, {ties0} "
        f"in the built frame), float max_abs_err {b3_err:.3g}; B4 bit-identical on "
        f"{', '.join(label for label, _, _ in b4_cases)}")

    b3_ms = graph_ms(lambda: gauss5x5_u8(x_u8), copies=10)
    b3_wrapper_ms = cuda_ms(lambda: gauss5x5_u8(x_u8))
    b3_plain_ms = cuda_ms(lambda: gauss5x5_u8_ref(x_u8))
    b3f_ms = graph_ms(lambda: gauss5x5(x_f), copies=10)
    b4_ms = graph_ms(lambda: motion_post(x_f, prev_f), copies=10)
    b4u_ms = graph_ms(lambda: motion_post(x_u8, prev_u8), copies=10)
    b3_copy_ms, b3_floor_ms = yardsticks(shape, torch.uint8, dev)
    b4_add_ms, b4u_add_ms = add_ms(x_f, prev_f), add_ms(x_u8, prev_u8)
    b4_wrapper_ms = cuda_ms(lambda: motion_post(x_f, prev_f))
    b4u_wrapper_ms = cuda_ms(lambda: motion_post(x_u8, prev_u8))
    b4_plain_ms = cuda_ms(lambda: motion_post_ref(x_f, prev_f))
    _, b3_prof, _ = profile_run(lambda: [gauss5x5_u8(x_u8) for _ in range(20)])
    _, b4_prof, _ = profile_run(lambda: [motion_post(x_f, prev_f) for _ in range(20)])
    _, b4u_prof, _ = profile_run(lambda: [motion_post(x_u8, prev_u8) for _ in range(20)])
    b3_dev = [ms / n for k, n, ms in b3_prof if "gauss5x5" in k]
    b4_dev = [ms / n for k, n, ms in b4_prof if "motion_post" in k]
    b4u_dev = [ms / n for k, n, ms in b4u_prof if "motion_post" in k]
    if not b3_dev or not b4_dev or not b4u_dev:
        fail("the profiler saw no B3 or B4 launch")
    if any("motion_post" not in k for k, _, _ in b4u_prof):
        fail(f"B4 on u8 frames launched other kernels: {b4u_prof}")
    # Bounds: each input byte read once, each output written once; the
    # operations are what the functions need: the blur's separable 5 + 5
    # multiply-adds (20 flop) per interior pixel, as the Gauss actor's
    # cost_flops counts them (B3 runs 25 taps in the plain version's order
    # for bit-identity; the bound does not charge that choice), and B4's
    # subtract, abs and compare plus 8 min/max per pixel (fp32).
    interior = MD_RATE * (H - 4) * (W - 4)
    b3_bytes, b3_flops = 2 * n_px, GAUSS_FLOP_PER_PX * interior
    # B4 on u8 frames reads 2 bytes and writes 4 a pixel.
    b4_bytes, b4_flops = 3 * 4 * n_px, 11 * n_px
    b4u_bytes = (2 + 4) * n_px
    b3f_bytes = 2 * 4 * n_px

    b3_bound, b3_by = bound_of(b3_bytes, b3_flops, FP32_FLOP_PER_S)
    b3f_bound, _ = bound_of(b3f_bytes, b3_flops, FP32_FLOP_PER_S)
    b4_bound, b4_by = bound_of(b4_bytes, b4_flops, FP32_FLOP_PER_S)
    b4u_bound, _ = bound_of(b4u_bytes, b4_flops, FP32_FLOP_PER_S)
    log(f"B3 timing ({smi}): u8 {b3_ms:.5f} ms/launch (CUDA graph replay; "
        f"profiler {b3_dev[0]:.5f}), wrapper {b3_wrapper_ms:.5f} ms/call back "
        f"to back, plain {b3_plain_ms:.5f} ms/call, copy_ of the same bytes "
        f"{b3_copy_ms:.5f} ms, launch floor {b3_floor_ms:.5f} ms, bound {b3_bound:.6f} ms "
        f"({b3_by}: {b3_bytes} B, {b3_flops} flop); float {b3f_ms:.5f} "
        f"ms/launch, bound {b3f_bound:.6f} ms")
    log(f"B4 timing ({smi}): float {b4_ms:.5f} ms/launch (CUDA graph "
        f"replay; profiler {b4_dev[0]:.5f}), u8 {b4u_ms:.5f} (profiler "
        f"{b4u_dev[0]:.5f}); wrapper float {b4_wrapper_ms:.5f}, u8 "
        f"{b4u_wrapper_ms:.5f} ms/call back to back; plain {b4_plain_ms:.5f} "
        f"ms/call; torch.add over the same bytes float {b4_add_ms:.5f}, u8 "
        f"{b4u_add_ms:.5f} ms; launch floor {b3_floor_ms:.5f} ms; bound float "
        f"{b4_bound:.6f} ms ({b4_by}: {b4_bytes} B, {b4_flops} flop), u8 "
        f"{b4u_bound:.6f} ms ({b4u_bytes} B)")

    # ---- 8. motion detection, dynamic mode ------------------------------ #
    net = bench_workload(MD_FRAMES, rate=MD_RATE, frame_hw=MD_HW, seed=0, device=dev)
    n_fire = MD_FRAMES // MD_RATE
    if net.buffer_bytes() != 3_456_000:
        fail(f"MD Eq. 1 buffer bytes {net.buffer_bytes()} != 3456000")
    prog_dyn = net.compile(mode="dynamic")
    st = prog_dyn.init_state()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res_dyn = prog_dyn.run(st, in_place=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    md_b3_launches = expect_counts("MD dynamic", {"B1": 0, "B2": 0, "B3": n_fire,
                                                  "B4": 0})["B3"]
    if res_dyn.sweeps != 121 or res_dyn.fire_counts != {a: n_fire for a in net.actors}:
        fail(f"MD dynamic: sweeps {res_dyn.sweeps}, counts {res_dyn.fire_counts}; "
             f"want 121 and {n_fire} per actor")
    sink = res_dyn.state.actor("sink")[0]
    if sink.dtype != torch.uint8 or tuple(sink.shape) != (MD_FRAMES, H, W) \
            or not sink.is_cuda:
        fail(f"MD sink slab {sink.dtype} {tuple(sink.shape)} on {sink.device}")
    net_cpu = bench_workload(MD_FRAMES, rate=MD_RATE, frame_hw=MD_HW, seed=0,
                             device="cpu")
    res_cpu = net_cpu.compile(mode="dynamic").run()
    if res_cpu.sweeps != res_dyn.sweeps or res_cpu.fire_counts != res_dyn.fire_counts:
        fail("MD dynamic: structure differs from the CPU run")
    if not states_equal(res_dyn.state, res_cpu.state):
        fail(f"MD dynamic: leaves {first_diff(res_dyn.state, res_cpu.state)} "
             "differ from the CPU run")
    moving = float((sink == 255).float().mean())
    log(f"MD dynamic on the card: {wall * 1e3:.1f} ms cold, sweeps "
        f"{res_dyn.sweeps}, {n_fire} firings per actor, B3 launches "
        f"{md_b3_launches}; every leaf bit-identical to the CPU run "
        f"(motion in {moving:.3f} of the sink's pixels)")

    # ---- 9. motion detection, megakernel mode --------------------------- #
    for cores in (1, 2):
        prog_mk = net.compile(mode="megakernel", cores=cores)
        st = prog_mk.init_state()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res_mk = prog_mk.run(st, in_place=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        md_b2_launches = expect_counts(f"MD megakernel cores={cores}",
                                       {"B1": 0, "B2": 1, "B3": 0, "B4": 0})["B2"]
        if res_mk.sweeps != res_dyn.sweeps or res_mk.fire_counts != res_dyn.fire_counts:
            fail(f"MD megakernel cores={cores}: sweeps {res_mk.sweeps}, counts "
                 f"{res_mk.fire_counts}")
        if not states_equal(res_mk.state, res_dyn.state):
            fail(f"MD megakernel cores={cores}: leaves "
                 f"{first_diff(res_mk.state, res_dyn.state)} differ from the "
                 "dynamic run")
        plain_state = prog_mk.init_state()
        compile_megakernel(net, cores=cores).plain(plain_state)
        torch.cuda.synchronize()
        md_b2_err = max_abs_diff(res_mk.state, plain_state)
        if md_b2_err != 0.0 or not states_equal(res_mk.state, plain_state):
            fail(f"MD megakernel cores={cores}: leaves "
                 f"{first_diff(res_mk.state, plain_state)} differ from its plain "
                 f"version on the card, max_abs_err {md_b2_err}")
        log(f"MD megakernel cores={cores} on the card: {wall * 1e3:.2f} ms cold, "
            f"sweeps {res_mk.sweeps}, B2 launches {md_b2_launches}, B3 launches 0; "
            "every leaf bit-identical to the dynamic run and to the plain version")

    b2_ms, b2_meta = b2_timed(net, dev)
    if b2_meta[0] != res_dyn.sweeps:
        fail("timed MD B2 launches ran another number of sweeps")
    runner = compile_megakernel(net)
    plain_times = []
    for _ in range(3):
        st = net.init_state()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        runner.plain(st)
        end.record()
        torch.cuda.synchronize()
        plain_times.append(start.elapsed_time(end))
    b2_plain_ms = float(np.median(plain_times))
    # Bound: the source and sink slabs and the Eq. 1 rings, each read once
    # and written once; operations: B3's and B4's per-pixel counts on every
    # window (gauss on interior pixels, thres and med on all).
    slab = MD_FRAMES * H * W
    b2_bytes = 2 * slab + 2 * net.buffer_bytes()
    b2_flops = n_fire * (GAUSS_FLOP_PER_PX * interior + 11 * n_px)
    b2_bound, b2_by = bound_of(b2_bytes, b2_flops, FP32_FLOP_PER_S)
    log(f"MD megakernel timing ({smi}): B2 {b2_ms:.4f} ms per run (CUDA events, "
        f"back to back), plain version {b2_plain_ms:.1f} ms per run, bound "
        f"{b2_bound:.5f} ms ({b2_by}: {b2_bytes} B, {b2_flops} flop)")

    # ---- 10. Table 3: frames/s ------------------------------------------ #
    rows = []
    for mode, rate in (("interpreted", 1), ("static", MD_RATE),
                       ("dynamic", MD_RATE), ("megakernel", MD_RATE)):
        net_t = net if rate == MD_RATE else bench_workload(
            MD_FRAMES, rate=rate, frame_hw=MD_HW, seed=0, device=dev)
        n_it = MD_FRAMES // rate if mode in ("interpreted", "static") else None
        prog = net_t.compile(mode=mode, n_iterations=n_it)
        walls = warm_wall_ms(prog, runs=8)
        dt = float(np.median(walls[1:])) / 1e3
        rows.append({"mode": mode, "rate": rate, "frames_per_s": MD_FRAMES / dt,
                     "ms": dt * 1e3})
        log(f"table3 {mode:11s} rate {rate}: {MD_FRAMES / dt:12.1f} frames/s "
            f"({dt * 1e3:.2f} ms for {MD_FRAMES} frames; {smi})")
    log("table3 " + json.dumps({"card": smi, "frames": MD_FRAMES, "rows": rows}))

    # ---- 11. where the time goes ---------------------------------------- #
    # Busy share: device time per profiled run (megakernel mode: B2's time
    # by CUDA events around its launch, over three runs; dynamic mode: the
    # profiler's, over one run) against the median wall of warm runs.
    b2_dev = None
    for mode, runs in (("megakernel", 3), ("dynamic", 1)):
        prog = net.compile(mode=mode)
        walls = warm_wall_ms(prog)
        device_ms, kernels, profiled_ms, launch_ms = profile_program(prog, runs)
        warm = float(np.median(walls))
        rec = {"card": smi, "warm_wall_ms": warm, "warm_walls_ms": walls,
               "profiled_wall_ms": profiled_ms, "device_ms": device_ms,
               "busy_share": device_ms / warm, "runs_profiled": runs,
               "b2_launch_ms": launch_ms,
               "top": [{"kernel": k, "count": n, "device_ms": ms}
                       for k, n, ms in kernels[:8]]}
        log(f"profile_md_{mode} " + json.dumps(rec))
        if mode == "megakernel":
            b2_dev = device_ms

    return {
        "B3": {"launches": md_b3_launches, "max_abs_err": b3_err, "ms": b3_ms,
               "wrapper_ms": b3_wrapper_ms, "device_ms": b3_dev[0],
               "plain_ms": b3_plain_ms, "copy_ms": b3_copy_ms, "floor_ms": b3_floor_ms,
               "bound_ms": b3_bound, "bound_by": b3_by,
               "float_ms": b3f_ms, "float_bound_ms": b3f_bound, "ties": ties},
        "B4": {"launches": 0, "max_abs_err": b4_err, "ms": b4_ms, "u8_ms": b4u_ms,
               "wrapper_ms": b4_wrapper_ms, "u8_wrapper_ms": b4u_wrapper_ms,
               "device_ms": b4_dev[0], "u8_device_ms": b4u_dev[0],
               "plain_ms": b4_plain_ms, "add_ms": b4_add_ms, "u8_add_ms": b4u_add_ms,
               "floor_ms": b3_floor_ms, "bound_ms": b4_bound, "bound_by": b4_by,
               "u8_bound_ms": b4u_bound},
        "B2": {"launches": md_b2_launches, "max_abs_err": md_b2_err, "ms": b2_ms,
               "device_ms": b2_dev, "plain_ms": b2_plain_ms,
               "bound_ms": b2_bound, "bound_by": b2_by},
        "net": net, "result": res_dyn,
    }


def row_excess(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per element: |got - ref| beyond one bf16 step of |ref|, in units of
    the RMS of ref's last-axis row (float32); on an all-zero row, 0 where
    got is 0 too, else inf."""
    ref = ref.float()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    excess = (got.float() - ref).abs() - 2.0 ** -7 * ref.abs()
    # A row of zeros (an MoE token whose every assignment was dropped) has
    # no scale: any difference there is infinitely far.
    zero = rms == 0
    return torch.where(zero, torch.where(excess > 0, float("inf"), 0.0),
                       excess / torch.where(zero, 1.0, rms))


def b6_inputs(dev, gen, dtype, strong: bool = False, batch: int = LM_BATCH) -> tuple:
    """B6's operands at mamba2-780m's prefill shape (batch LM_BATCH, or
    ``batch``, LM_PROMPT steps, 48 heads of 64, state 128): x, B, C in
    ``dtype``; dt = softplus(randn), A from -1 to -16, float32; or,
    ``strong``, dt uniform in 0-5 at A = -16 (a chunk's cumsum of dt A
    reaches -1e4)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    mc = get_config("mamba2-780m")
    s = mc.ssm
    nh, P, N = s.n_heads(mc.d_model), s.head_dim, s.state_dim
    B, S = batch, LM_PROMPT

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt = F.softplus(randn(B, S, nh))
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, nh, device=dev)))
    if strong:
        dt = torch.rand((B, S, nh), generator=gen, device=dev) * 5.0
        A = torch.full((nh,), -16.0, device=dev)
    return (randn(B, S, nh, P).to(dtype), dt, A, randn(B, S, N).to(dtype),
            randn(B, S, N).to(dtype))


def b6_reading(y, hT, yr, hr) -> tuple:
    """(y, hT) against the plain version's (yr, hr), as multiples of B6's
    bar: |dy| <= B6_TOL max|yr| (plus one bf16 step of |yr| on bf16 y),
    |dhT| <= B6_TOL max|hr|.  A reading above 1 fails it."""
    y_bar = B6_TOL * float(yr.float().abs().max())
    if yr.dtype == torch.bfloat16:   # one bf16 step at |y| is at most 2^-7 |y|
        y_bar = y_bar + 2.0 ** -7 * yr.float().abs()
    ry = float(((y.float() - yr.float()).abs() / y_bar).max())
    rh = float((hT - hr).abs().max()) / (B6_TOL * float(hr.abs().max()))
    return ry, rh


def b6_chunkwise(x, dt, A, Bm, Cm, c: int, lag: int) -> torch.Tensor:
    """y of the SSD scan put together chunk by chunk from the plain version:
    each chunk's own output and final state from a zero state
    (``ssd_ref`` on that chunk alone), the states passed over the chunks,
    and exp(cum_t) C_t h^T added for the state h that entered the chunk
    ``lag`` chunks before (zero before the first).  At lag 0 it is the
    scan; at lag 1 it is the planted fault of a wrong state pass, the state
    entering each chunk taken one chunk late."""
    from repro_torch.kernels.ssd import ssd_ref
    Bsz, L, H, P = x.shape
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]), device=x.device)
    ys, h_in = [], []
    for z0 in range(0, L, c):
        s = slice(z0, z0 + c)
        y0, S = ssd_ref(x[:, s].float(), dt[:, s], A, Bm[:, s].float(), Cm[:, s].float(), c)
        cum = torch.cumsum(dt[:, s] * A, dim=1)                             # (B, c, H)
        h_in.append(h)
        h_late = h_in[-1 - lag] if len(h_in) > lag else torch.zeros_like(h)
        ys.append(y0 + torch.exp(cum)[..., None]
                  * torch.einsum("bcn,bhpn->bchp", Cm[:, s].float(), h_late))
        h = h * torch.exp(cum[:, -1])[..., None, None] + S
    return torch.cat(ys, dim=1).to(x.dtype)


def b7_inputs(dev, gen) -> tuple:
    """B7's operands at recurrentgemma-2b's RG-LRU in phase 12: log_a in
    [-2.01, -0.01) and gx standard normal, (LM_BATCH, LM_PROMPT, lru_width)
    float32."""
    from repro_torch.configs import get_config
    shape = (LM_BATCH, LM_PROMPT, get_config("recurrentgemma-2b").rglru.lru_width)
    la = -(torch.rand(shape, generator=gen, device=dev) * 2.0 + 0.01)
    return la, torch.randn(shape, generator=gen, device=dev)


def b7_reading(la, gx) -> float:
    """B7 against its plain version on the same inputs: fails unless h_seq
    and hT are bit-identical (both round exp, the product and the sum each
    on its own, in time order); returns the largest difference."""
    from repro_torch.kernels.rglru import rglru, rglru_ref
    h, t = rglru(la, gx)
    hr, tr = rglru_ref(la, gx)
    err = max(float((h - hr).abs().max()), float((t - tr).abs().max()))
    if not (torch.equal(h, hr) and torch.equal(t, tr)):
        fail(f"B7 differs from its plain version: max |dh|, |dhT| {err:.3g}")
    return err


def b5_at_shape(dev, gen, smi: str, label: str, B: int, S: int, H: int, Hkv: int,
                hd: int, causal: bool) -> dict:
    """B5 against its plain version at one model's prefill shape (bf16, no
    window), within one bf16 step plus ``B5_ROW_TOL`` of the row's RMS;
    timed by CUDA graph replay beside its plain version, SDPA with the same
    boolean mask and ``enable_gqa=True``, and the operations bound (4 hd
    flop per live (query, key) pair at the bf16 tensor-core rate)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_mask, flash_attention,
                                                     flash_attention_ref)
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=dev).to(torch.bfloat16)
               for n in (H, Hkv, Hkv))
    got = flash_attention(q, k, v, causal=causal).float()
    want = flash_attention_ref(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    excess = float(row_excess(got, want).max())
    if not torch.isfinite(got).all() or not excess <= B5_ROW_TOL:
        fail(f"B5 at {label}: {excess:.3g} row-RMS beyond one bf16 step > {B5_ROW_TOL}")
    mask = attention_mask(S, causal, None, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err = float((sdpa().transpose(1, 2).float() - want).abs().max())
    del got, want
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=causal), inner=10)
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal), reps=3, inner=1)
    lib = cuda_ms(sdpa, reps=3, inner=5)
    live = S * (S + 1) // 2 if causal else S * S          # (q, k) pairs per (b, h)
    flops = 4 * hd * live * B * H
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound, by = bound_of(nbytes, flops, BF16_FLOP_PER_S)
    log(f"B5 at {label}, q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, "
        f"{'causal' if causal else 'non-causal'}, no window ({smi}): {ms:.4f} ms/launch "
        f"(CUDA graph replay), plain {plain:.3f} ms, SDPA {lib:.4f} ms (max |diff| vs plain "
        f"{lib_err:.3g}), bound {bound:.4f} ms ({by}: {flops:.4g} flop); max_abs_err "
        f"{err:.3g}, row-RMS excess {excess:.4g} (bar {B5_ROW_TOL:.4g})")
    return {"q": list(q.shape), "kv": list(k.shape), "causal": causal, "window": None,
            "max_abs_err": err, "row_rms_excess": excess, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "library_max_abs_err": lib_err}


def lm_kernels(dev, smi: str) -> dict:
    """Phase 12: B5, B6 and B7 against their plain versions at the serving
    shapes, with their times and bounds; returns their records."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_mask, flash_attention,
                                                     flash_attention_ref,
                                                     masked_attention_ref)
    from repro_torch.kernels.rglru import rglru, rglru_ref
    from repro_torch.kernels.ssd import ssd, ssd_cuda, ssd_naive, ssd_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, S = LM_BATCH, LM_PROMPT
    recs = {}

    # ---- B5 at recurrentgemma-2b's local attention ---------------------- #
    rc = get_config("recurrentgemma-2b")
    q, k, v, win = b5_inputs(dev, gen)
    H, hd = rc.n_heads, rc.hd
    got = flash_attention(q, k, v, causal=True, window=win).float()
    want = flash_attention_ref(q, k, v, causal=True, window=win).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    b5_err = float(diff.max())
    b5_excess = float(row_excess(got, want).max())
    # Planted faults, made with the plain version under a wrong mask: what
    # a kernel that skipped one 64-key tile, or missed the causal or the
    # window edge by one key, would read against the bar.
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    right = attention_mask(S, True, win, dev)
    tile = (j >= B5_FAULT_TILE) & (j < B5_FAULT_TILE + 64)
    faults = {f"key tile {B5_FAULT_TILE}-{B5_FAULT_TILE + 63} skipped": right & ~tile,
              "causal edge one key late (rows >= 512)": right | ((j == i + 1) & (i >= 512)),
              "window one key wider": attention_mask(S, True, win + 1, dev)}
    fault_excess = {name: float(row_excess(masked_attention_ref(q, k, v, m), want).max())
                    for name, m in faults.items()}
    del i, j, right, tile, faults
    log(f"B5 vs plain: max |diff| {b5_err:.4g}, median |want| "
        f"{float(want.abs().median()):.4g}; beyond one bf16 step, in row-RMS "
        f"units: sound {b5_excess:.4g}, bar {B5_ROW_TOL:.4g}, planted faults "
        + json.dumps(fault_excess))
    if not torch.isfinite(got).all() or not b5_excess <= B5_ROW_TOL:
        fail(f"B5: {b5_excess:.3g} row-RMS beyond one bf16 step > {B5_ROW_TOL}")
    for name, ex in fault_excess.items():
        if not ex > B5_ROW_TOL:
            fail(f"B5: the bar cannot see a planted fault ({name}: {ex:.3g})")
    mask = attention_mask(S, True, win, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err = float((sdpa().transpose(1, 2).float() - want).abs().max())
    del got, want, diff
    b5_ms = graph_ms(lambda: flash_attention(q, k, v, causal=True, window=win), inner=10)
    b5_wrapper = cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=win), inner=10)
    b5_plain = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True, window=win),
                       reps=3, inner=1)
    b5_lib = cuda_ms(sdpa, reps=3, inner=5)
    live = sum(min(p + 1, win) for p in range(S))          # (q, k) pairs per (b, h)
    b5_flops = 4 * hd * live * B * H
    b5_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b5_bound, b5_by = bound_of(b5_bytes, b5_flops, BF16_FLOP_PER_S)
    log(f"B5 vs plain, q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, causal, window "
        f"{win}: max_abs_err {b5_err:.3g} (SDPA vs plain {lib_err:.3g})")
    log(f"B5 timing ({smi}): {b5_ms:.4f} ms/launch (CUDA graph replay), wrapper "
        f"{b5_wrapper:.4f} ms/call, plain {b5_plain:.3f} ms, SDPA {b5_lib:.4f} ms, "
        f"bound {b5_bound:.4f} ms ({b5_by}: {b5_flops:.4g} flop, {b5_bytes} B)")
    recs["B5"] = {"max_abs_err": b5_err, "row_rms_excess": b5_excess,
                  "planted_fault_excess": fault_excess, "ms": b5_ms, "wrapper_ms": b5_wrapper,
                  "plain_ms": b5_plain, "bound_ms": b5_bound, "bound_by": b5_by,
                  "library_ms": b5_lib, "library_max_abs_err": lib_err,
                  "library": "torch.nn.functional.scaled_dot_product_attention "
                             "(boolean causal+window mask, enable_gqa=True)"}

    # ---- B5 at the other models' prefill shapes: no window ------------- #
    # olmoe-1b-7b's (hd 128, causal); then whisper-small's encoder (hd 64,
    # bidirectional, S = 1500: a partial last query and key tile with no
    # causal mask to hide it) and internvl2-1b's (hd 64, causal, 14 query
    # heads on 2 KV heads: G = 7), these two from their own generator so
    # the draws of the phases after them stay as they were.
    oc = get_config("olmoe-1b-7b")
    recs["B5"]["olmoe_shape"] = b5_at_shape(dev, gen, smi, "olmoe-1b-7b's prefill", B, S,
                                            oc.n_heads, oc.n_kv_heads, oc.hd, True)
    gen64 = torch.Generator(device=dev)
    gen64.manual_seed(64)
    wc, ic = get_config("whisper-small"), get_config("internvl2-1b")
    recs["B5"]["whisper_enc_shape"] = b5_at_shape(
        dev, gen64, smi, "whisper-small's encoder", B, wc.encoder.n_ctx, wc.encoder.n_heads,
        wc.encoder.n_heads, wc.encoder.d_model // wc.encoder.n_heads, False)
    recs["B5"]["whisper_dec_shape"] = b5_at_shape(
        dev, gen64, smi, "whisper-small's decoder", B, FAMILY_PROMPTS["whisper-small"][1],
        wc.n_heads, wc.n_kv_heads, wc.hd, True)
    recs["B5"]["internvl_shape"] = b5_at_shape(
        dev, gen64, smi, "internvl2-1b's prefill", B, S, ic.n_heads, ic.n_kv_heads, ic.hd,
        True)

    # ---- B5's float32 and f16 route (flash_fwd_ffma), same shape -------- #
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    b5f = {}
    b5f_launches = 0      # of the two checked calls; the timing's are not counted
    for dtype in (torch.float32, torch.float16):
        qf, kf, vf = (t.to(dtype) for t in (q, k, v))
        before = flash_attention_cuda.route_launches["ffma"]
        got = flash_attention(qf, kf, vf, causal=True, window=win)
        b5f_launches += flash_attention_cuda.route_launches["ffma"] - before
        want = flash_attention_ref(qf, kf, vf, causal=True, window=win)
        torch.cuda.synchronize()
        if got.dtype != dtype or not torch.isfinite(got).all():
            fail(f"B5 {dtype}: output {got.dtype}, finite {bool(torch.isfinite(got).all())}")
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.float32:
            reading = float(((got - want).abs() / (B5_F32_TOL * (1 + want.abs()))).max())
        else:
            w = want.float()
            rms = w.pow(2).mean(-1, keepdim=True).sqrt()
            reading = float((((got.float() - w).abs() - 2.0 ** -10 * w.abs()) / rms).max()
                            / B5_F16_ROW_TOL)
        if not reading <= 1.0:
            fail(f"B5 {dtype}: {reading:.3g} times its bar (max |diff| {err:.3g})")
        ms = graph_ms(lambda: flash_attention(qf, kf, vf, causal=True, window=win),
                      reps=3, inner=3)
        b5f[str(dtype)] = {"max_abs_err": err, "over_bar": reading, "ms": ms}
        del got, want
    if b5f_launches != 2:
        fail(f"B5 float route: {b5f_launches} ffma launches for 2 calls")
    q32, k32, v32 = (t.float() for t in (q, k, v))
    qt32, kt32, vt32 = (t.transpose(1, 2) for t in (q32, k32, v32))
    b5f_plain = cuda_ms(lambda: flash_attention_ref(q32, k32, v32, causal=True, window=win),
                        reps=3, inner=1)
    b5f_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt32, kt32, vt32, attn_mask=mask, enable_gqa=True), reps=3, inner=1)
    b5f_bound, b5f_by = bound_of(4 * (2 * q.numel() + k.numel() + v.numel()), b5_flops,
                                 FP32_FLOP_PER_S)
    log(f"B5 float route vs plain (q {tuple(q.shape)}, causal, window {win}): "
        + json.dumps(b5f))
    log(f"B5 float route timing ({smi}): float32 {b5f['torch.float32']['ms']:.4f} ms, "
        f"f16 {b5f['torch.float16']['ms']:.4f} ms per launch (CUDA graph replay), plain "
        f"float32 {b5f_plain:.3f} ms, SDPA float32 {b5f_lib:.3f} ms, bound "
        f"{b5f_bound:.4f} ms ({b5f_by}: {b5_flops:.4g} flop at {FP32_FLOP_PER_S:.3g}/s)")
    recs["B5_ffma"] = {"launches": b5f_launches,
                       "max_abs_err": b5f["torch.float32"]["max_abs_err"],
                       "ms": b5f["torch.float32"]["ms"], "f16_ms": b5f["torch.float16"]["ms"],
                       "errors": b5f, "plain_ms": b5f_plain, "bound_ms": b5f_bound,
                       "bound_by": b5f_by, "library_ms": b5f_lib,
                       "library": "torch.nn.functional.scaled_dot_product_attention in "
                                  "float32 (boolean causal+window mask, enable_gqa=True)",
                       "launches_from": "phase 12: one float32 and one f16 call "
                                        "through flash_attention"}
    del q, k, v, qt, kt, vt, mask, q32, k32, v32, qt32, kt32, vt32

    # ---- B6 at mamba2-780m's SSD ---------------------------------------- #
    # B6 against the plain version and against the step-by-step recurrence
    # (ssd_naive, independent of the chunked algorithm).  Then the plain
    # version put together chunk by chunk (b6_chunkwise): at lag 0 it must
    # hold the bar, which shows the construction sound; at lag 1, the state
    # entering each chunk taken one chunk late (the likeliest fault of a
    # chunk-parallel scan), it must break it.  A reading above 1 fails it.
    c = get_config("mamba2-780m").ssm.chunk
    b6_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, Bm, Cm = b6_inputs(dev, gen, dtype)
        y, hT = ssd(x, dt, A, Bm, Cm, chunk=c)
        yr, hr = ssd_ref(x, dt, A, Bm, Cm, c)
        yn, hn = ssd_naive(x, dt, A, Bm, Cm)
        torch.cuda.synchronize()
        ry, rh = b6_reading(y, hT, yr, hr)
        ny, nh = b6_reading(y, hT, yn, hn)
        py, ph = b6_reading(yr, hr, yn, hn)
        sound = b6_reading(b6_chunkwise(x, dt, A, Bm, Cm, c, lag=0), hr, yr, hr)[0]
        fault = b6_reading(b6_chunkwise(x, dt, A, Bm, Cm, c, lag=1), hr, yr, hr)[0]
        b6_err[str(dtype)] = {"y": float((y.float() - yr.float()).abs().max()),
                              "hT": float((hT - hr).abs().max()),
                              "max_y": float(yr.float().abs().max()),
                              "max_hT": float(hr.abs().max()),
                              "y_over_bar": ry, "hT_over_bar": rh,
                              "vs_naive_y_over_bar": ny, "vs_naive_hT_over_bar": nh,
                              "plain_vs_naive_y_over_bar": py,
                              "plain_vs_naive_hT_over_bar": ph,
                              "chunkwise_lag0_y_over_bar": sound,
                              "late_state_fault_y_over_bar": fault}
        if not torch.isfinite(y.float()).all() or not max(ry, rh, ny, nh) <= 1.0:
            fail(f"B6 {dtype}: {json.dumps(b6_err[str(dtype)])}")
        if not sound <= 1.0:
            fail(f"B6 {dtype}: the chunk-by-chunk plain version reads {sound:.3g} "
                 "over the bar at lag 0")
        if not fault > 1.0:
            fail(f"B6 {dtype}: the bar cannot see a state taken one chunk late "
                 f"(reading {fault:.3g})")
        del x, dt, A, Bm, Cm, y, hT, yr, hr, yn, hn
    # Under strong decays B6 is held against ssd_naive only: there the
    # plain version's float32 cumsum cancels (cum_t - cum_s of two values
    # near -1e4), so its readings are logged, not gated.
    x, dt, A, Bm, Cm = b6_inputs(dev, gen, torch.float32, strong=True)
    y, hT = ssd(x, dt, A, Bm, Cm, chunk=c)
    yr, hr = ssd_ref(x, dt, A, Bm, Cm, c)
    yn, hn = ssd_naive(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    ny, nh = b6_reading(y, hT, yn, hn)
    ry, rh = b6_reading(y, hT, yr, hr)
    py, ph = b6_reading(yr, hr, yn, hn)
    b6_err["strong decays, float32"] = {
        "vs_naive_y_over_bar": ny, "vs_naive_hT_over_bar": nh,
        "vs_plain_y_over_bar": ry, "vs_plain_hT_over_bar": rh,
        "plain_vs_naive_y_over_bar": py, "plain_vs_naive_hT_over_bar": ph}
    if not torch.isfinite(y).all() or not torch.isfinite(hT).all() or not max(ny, nh) <= 1.0:
        fail(f"B6 under strong decays: {json.dumps(b6_err['strong decays, float32'])}")
    del x, dt, A, Bm, Cm, y, hT, yr, hr, yn, hn
    x, dt, A, Bm, Cm = b6_inputs(dev, gen, torch.bfloat16)
    b6_ms = graph_ms(lambda: ssd(x, dt, A, Bm, Cm, chunk=c), inner=10)
    b6_wrapper = cuda_ms(lambda: ssd(x, dt, A, Bm, Cm, chunk=c), inner=10)
    b6_plain = cuda_ms(lambda: ssd_ref(x, dt, A, Bm, Cm, c), reps=3, inner=1)
    # B6's CUDA kernels per call and its time split over them, from the
    # profiler over 20 calls.  The profiler has dropped launches on an H100
    # (it saw 12 of 15 in one full run) but never adds one, so with fewer
    # than 20 dropped the count rounded up over 20 calls is exact; each
    # kernel's time is per launch it saw (one launch a call).
    n_calls = 20
    _, ks, _ = profile_run(lambda: [ssd(x, dt, A, Bm, Cm, chunk=c) for _ in range(n_calls)])
    b6_split = {re.search(r"ssd_\w+", k).group(0): ms / n for k, n, ms in ks if "ssd_" in k}
    b6_count = sum(n for k, n, _ in ks if "ssd_" in k)
    b6_kernels = -(-b6_count // n_calls)
    if b6_kernels != ssd_cuda.kernels_per_call:
        fail(f"B6: the profiler saw {b6_count} CUDA kernels in {n_calls} calls, the "
             f"wrapper says {ssd_cuda.kernels_per_call} per call")
    # Bytes: x and y bf16, dt float32, B and C bf16, hT float32.  Flop: the
    # chunked algorithm at chunk c with C B^T once per (batch, chunk) (its
    # causal half), then per head the (C B^T * L)(dt x) product, the chunk
    # state and the inter-chunk term, at the bf16 tensor-core rate of the
    # inputs' type.
    nh, P = x.shape[2], x.shape[3]
    N, nc = Bm.shape[-1], -(-S // c)
    tri = c * (c + 1) // 2
    b6_flops = B * nc * (2 * tri * N + nh * (2 * tri * P + 4 * c * P * N))
    b6_bytes = 2 * 2 * x.numel() + 4 * dt.numel() + 4 * nh + 2 * 2 * Bm.numel() \
        + 4 * B * nh * P * N
    b6_bound, b6_by = bound_of(b6_bytes, b6_flops, BF16_FLOP_PER_S)
    log(f"B6 vs plain and vs ssd_naive, x {tuple(x.shape)}, B/C {tuple(Bm.shape)}, chunk "
        f"{c}; readings over the bar, sound and planted fault: {json.dumps(b6_err)}")
    log(f"B6 timing ({smi}): {b6_ms:.4f} ms/call (CUDA graph replay), {b6_kernels} "
        f"kernels per call (profiler: {b6_count} in {n_calls} calls), wrapper {b6_wrapper:.4f} ms/call, plain {b6_plain:.3f} ms, "
        f"bound {b6_bound:.4f} ms ({b6_by}: {b6_flops:.4g} flop, {b6_bytes} B); "
        f"by kernel (profiler) {json.dumps(b6_split)}")
    # B6 at batch 1: the LM stage network's microbatch (phase 23(c)).
    x1, dt1, A1, B1m, C1m = b6_inputs(dev, gen, torch.bfloat16, batch=1)
    y1, h1 = ssd(x1, dt1, A1, B1m, C1m, chunk=c)
    y1r, h1r = ssd_ref(x1, dt1, A1, B1m, C1m, c)
    torch.cuda.synchronize()
    r1y, r1h = b6_reading(y1, h1, y1r, h1r)
    if not torch.isfinite(y1.float()).all() or not max(r1y, r1h) <= 1.0:
        fail(f"B6 at batch 1: readings {r1y:.3g}, {r1h:.3g} over the bar")
    b1_ms = graph_ms(lambda: ssd(x1, dt1, A1, B1m, C1m, chunk=c), inner=10)
    b1_plain = cuda_ms(lambda: ssd_ref(x1, dt1, A1, B1m, C1m, c), reps=3, inner=1)
    b1_flops = nc * (2 * tri * N + nh * (2 * tri * P + 4 * c * P * N))
    b1_bytes = 2 * 2 * x1.numel() + 4 * dt1.numel() + 4 * nh + 2 * 2 * B1m.numel() \
        + 4 * nh * P * N
    b1_bound, b1_by = bound_of(b1_bytes, b1_flops, BF16_FLOP_PER_S)
    batch1 = {"shape": [list(x1.shape), list(B1m.shape)], "ms": b1_ms, "plain_ms": b1_plain,
              "bound_ms": b1_bound, "bound_by": b1_by,
              "max_abs_err": float((y1.float() - y1r.float()).abs().max()),
              "y_over_bar": r1y, "hT_over_bar": r1h}
    log(f"B6 at batch 1 ({smi}): x {tuple(x1.shape)}, {b1_ms:.4f} ms/call (CUDA graph "
        f"replay), plain {b1_plain:.3f} ms, bound {b1_bound:.4f} ms ({b1_by}); readings "
        f"over the bar y {r1y:.3g}, hT {r1h:.3g}")
    del x1, dt1, A1, B1m, C1m, y1, h1, y1r, h1r
    recs["B6"] = {"max_abs_err": b6_err["torch.bfloat16"]["y"], "errors": b6_err,
                  "batch1": batch1,
                  "ms_by_kernel": b6_split,
                  "ms": b6_ms, "wrapper_ms": b6_wrapper, "plain_ms": b6_plain,
                  "bound_ms": b6_bound, "bound_by": b6_by, "library_ms": None,
                  "kernels_per_call": b6_kernels,
                  "library": "none: no single PyTorch call runs the SSD scan"}
    del x, Bm, Cm, dt

    # ---- B6's SIMT route at mamba2's smoke shape (P 16, N 16) ----------- #
    from repro_torch.configs import smoke_config
    sm = smoke_config("mamba2-780m").ssm
    Hs = 8
    simt = {}
    for dtype in (torch.float32, torch.float16):
        x = randn(B, S, Hs, sm.head_dim).to(dtype)
        dt = F.softplus(randn(B, S, Hs))
        A = -torch.linspace(1.0, 16.0, Hs, device=dev)
        Bm, Cm = randn(B, S, sm.state_dim).to(dtype), randn(B, S, sm.state_dim).to(dtype)
        before = ssd_cuda.route_launches["simt"]
        y, hT = ssd(x, dt, A, Bm, Cm)
        yr, hr = ssd_ref(x.float(), dt, A, Bm.float(), Cm.float(), 256)
        torch.cuda.synchronize()
        if ssd_cuda.route_launches["simt"] != before + 1 or y.dtype != dtype:
            fail(f"B6 SIMT {dtype}: route launches or output type {y.dtype}")
        ry, rh = b6_reading(y, hT, yr, hr)
        if dtype == torch.float16:
            ry = float(((y.float() - yr).abs() / (B6_TOL * yr.abs().max()
                                                   + 2.0 ** -10 * yr.abs())).max())
        if not torch.isfinite(y.float()).all() or not max(ry, rh) <= 1.0:
            fail(f"B6 SIMT {dtype}: y {ry:.3g}, hT {rh:.3g} times the bar")
        simt[str(dtype)] = {"y": float((y.float() - yr).abs().max()),
                            "y_over_bar": ry, "hT_over_bar": rh}
        if dtype == torch.float32:
            simt_ms = graph_ms(lambda: ssd(x, dt, A, Bm, Cm), reps=3, inner=3)
            simt_plain = cuda_ms(lambda: ssd_ref(x, dt, A, Bm, Cm, 256), reps=3, inner=1)
            simt_bytes = 4 * (2 * x.numel() + dt.numel() + Hs + 2 * Bm.numel()
                              + B * Hs * sm.head_dim * sm.state_dim)
            simt_bound, simt_by = bound_of(simt_bytes, 0.0, FP32_FLOP_PER_S)
        del x, dt, A, Bm, Cm, y, hT, yr, hr
    log(f"B6 SIMT route vs plain, x (4, {S}, {Hs}, {sm.head_dim}), B/C (4, {S}, "
        f"{sm.state_dim}): " + json.dumps(simt))
    log(f"B6 SIMT timing ({smi}): {simt_ms:.4f} ms/call (CUDA graph replay), plain "
        f"{simt_plain:.3f} ms, bound {simt_bound:.5f} ms ({simt_by}: {simt_bytes} B)")
    recs["B6_simt"] = {"max_abs_err": simt["torch.float32"]["y"], "errors": simt,
                       "ms": simt_ms, "plain_ms": simt_plain, "bound_ms": simt_bound,
                       "bound_by": simt_by, "library_ms": None,
                       "shape": [B, S, Hs, sm.head_dim, sm.state_dim]}

    # ---- B7 at recurrentgemma-2b's RG-LRU ------------------------------- #
    la, gx = b7_inputs(dev, gen)
    W = la.shape[-1]
    b7_err = b7_reading(la, gx)
    b7_ms = graph_ms(lambda: rglru(la, gx), inner=10)
    b7_wrapper = cuda_ms(lambda: rglru(la, gx), inner=10)
    b7_plain = cuda_ms(lambda: rglru_ref(la, gx), reps=3, inner=1)
    b7_bytes = 4 * (3 * la.numel() + B * W)
    b7_bound, b7_by = bound_of(b7_bytes, 3 * la.numel(), FP32_FLOP_PER_S)
    log(f"B7 vs plain, (log_a, gx) {tuple(la.shape)} float32: bit-identical "
        f"(max_abs_err {b7_err:.3g})")
    # bf16 operands through the entry: cast to float32, then B7.
    lab, gxb = la.bfloat16(), gx.bfloat16()
    hb, tb = rglru(lab, gxb)
    hr, tr = rglru_ref(lab.float(), gxb.float())
    if hb.dtype != torch.float32 or not (torch.equal(hb, hr) and torch.equal(tb, tr)):
        fail(f"B7 on bf16 inputs: {hb.dtype}, max |diff| {float((hb - hr).abs().max()):.3g}")
    log("B7 on bf16 inputs through the entry: float32 out, bit-identical to the plain "
        "version on the cast operands")
    del lab, gxb, hb, tb, hr, tr
    log(f"B7 timing ({smi}): {b7_ms:.4f} ms/launch (CUDA graph replay), wrapper "
        f"{b7_wrapper:.4f} ms/call, plain {b7_plain:.3f} ms, bound {b7_bound:.4f} ms "
        f"({b7_by}: {b7_bytes} B)")
    recs["B7"] = {"max_abs_err": b7_err, "bf16_entry_bit_identical": True,
                  "ms": b7_ms, "wrapper_ms": b7_wrapper,
                  "plain_ms": b7_plain, "bound_ms": b7_bound, "bound_by": b7_by,
                  "library_ms": None,
                  "library": "none: no single PyTorch call runs a linear recurrence"}
    return recs


def capture_logits(model) -> list:
    """Record the logits of every prefill and decode_step of ``model`` (an
    instance wrapper; ``release_logits`` removes it)."""
    seen: list = []
    prefill, decode = model.prefill, model.decode_step

    def pre(*a, **kw):
        out = prefill(*a, **kw)
        seen.append(out[0].float().cpu())
        return out

    def dec(*a, **kw):
        out = decode(*a, **kw)
        seen.append(out[0].float().cpu())
        return out

    model.prefill, model.decode_step = pre, dec
    return seen


def release_logits(model) -> None:
    del model.prefill, model.decode_step


def bf16_step_noise(x: torch.Tensor) -> torch.Tensor:
    """``x`` (bf16, finite) moved one representable step up or down in
    magnitude at every element, the direction drawn from a fixed seed: one
    rounding step of noise.  A zero steps up (a step down would give a NaN
    bit pattern) and the largest finite value down."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(5)
    step = (torch.randint(0, 2, x.shape, generator=gen, device=x.device) * 2 - 1
            ).to(torch.int16)
    bits = x.view(torch.int16)
    mag = bits & 0x7FFF
    step = torch.where(mag == 0, torch.ones_like(step), step)
    step = torch.where(mag == 0x7F7F, -torch.ones_like(step), step)
    return (bits + step).view(torch.bfloat16)


def stub_inputs(cfg, rng, n: int) -> dict:
    """The frontend stub's inputs of the audio and vision families for n
    sequences, standard normal from ``rng``, bf16 on the CPU: whisper's
    frame embeddings (n, n_ctx, d), internvl's patch embeddings (n,
    n_vision_tokens, d); nothing for the other families."""
    if cfg.family == "audio":
        shape, key = (n, cfg.encoder.n_ctx, cfg.encoder.d_model), "frames"
    elif cfg.family == "vlm":
        shape, key = (n, cfg.n_vision_tokens, cfg.d_model), "vision_embeds"
    else:
        return {}
    return {key: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(torch.bfloat16)}


def greedy(model, toks: torch.Tensor, extra: dict, new: int) -> np.ndarray:
    """Prefill ``toks`` (B, P) with the stub inputs ``extra`` (the vision
    embeddings come before the tokens), then ``new - 1`` greedy decode
    steps: the (B, new) generated tokens."""
    B, P = toks.shape
    if "vision_embeds" in extra:
        P += extra["vision_embeds"].shape[1]
    logits, caches = model.prefill(toks, max_cache_len=P + new, **extra)
    nxt = torch.argmax(logits, dim=-1)[:, None]
    out = [nxt]
    pos = torch.full((B,), P, dtype=torch.int64, device=toks.device)
    for _ in range(new - 1):
        logits, caches = model.decode_step(nxt, pos, caches)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        pos = pos + 1
        out.append(nxt)
    return torch.cat(out, dim=1).cpu().numpy()


def left_pad(prompts: list, P: int) -> np.ndarray:
    """Prompts left-padded with token 0 to P, as the Engine pads them."""
    toks = np.zeros((len(prompts), P), np.int64)
    for i, p in enumerate(prompts):
        toks[i, P - len(p):] = p
    return toks


def compare_steps(cfg, g_tok, g_lg, c_tok, c_lg, bar_last) -> tuple:
    """Greedy runs on the card (g) and the CPU (c): each step's logits
    within the row's last-position bar, tokens identical while the CPU's
    top-2 margin exceeds twice the step's largest logit difference (a row
    is compared up to its first allowed flip).  Returns (largest
    difference, tokens compared, allowed flips, steps whose bar is below
    the logits' magnitude)."""
    V = cfg.vocab
    worst, compared, flips, step_power = 0.0, 0, 0, 0
    for i in range(g_tok.shape[0]):
        step_bar = float(bar_last[i])
        for step in range(g_tok.shape[1]):
            if step and not np.array_equal(g_tok[i, :step], c_tok[i, :step]):
                break        # an allowed flip earlier: the paths differ now
            g, c = g_lg[step][i].numpy()[:V], c_lg[step][i].numpy()[:V]
            if not np.all(np.isfinite(g)):
                fail(f"{cfg.name}: non-finite logits on the card")
            e = float(np.abs(g - c).max())
            if e > step_bar:
                fail(f"{cfg.name} parity: row {i} step {step} logits differ by "
                     f"{e:.3g} > {step_bar:.3g}")
            worst = max(worst, e)
            step_power += step_bar < float(np.abs(c).max())
            top2 = np.sort(c)[-2:]
            if top2[1] - top2[0] > 2 * e:
                if g_tok[i, step] != c_tok[i, step]:
                    fail(f"{cfg.name} parity: row {i} step {step} token "
                         f"{g_tok[i, step]} vs {c_tok[i, step]}, margin "
                         f"{top2[1] - top2[0]:.3g} > 2 x {e:.3g}")
                compared += 1
            elif g_tok[i, step] != c_tok[i, step]:
                flips += 1
    return worst, compared, flips, step_power


def serve_parity(cfg, model, dev) -> dict:
    """The short full-width run on the card and on the CPU (the plain
    path), same weights.

    * Every layer: the card's mixer (attention, RG-LRU or Mamba2), cross
      attention (whisper's decoder) and MLP, and every whisper encoder
      layer's attention and MLP, each fed the CPU's input, against the
      CPU's, element by element before the residual add: within one bf16
      step plus MIX_ROW_TOL of the row's RMS.
    * Logits at every position (the card's own forward against the
      CPU's): within LOGIT_SENS times the CPU model's sensitivity at that
      position (the change of its logits when its inputs, the embedded
      prompt and the stub's embeddings, move one bf16 step at every
      element; random full-width weights amplify rounding noise), never
      below LOGIT_TOL.  A position's bar has power where it is below the
      logits' largest magnitude there; some must.
    * The Engine on both (the audio and vision families: prefill with
      their stub inputs, then greedy decode steps): each step's logits
      within the last position's bar, and tokens identical while the
      CPU's top-2 margin exceeds twice the step's largest logit
      difference."""
    from repro_torch.models import LM
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.moe import Routing, route, router_logits
    from repro_torch.serve import Engine, Request, ServeConfig
    t0 = time.perf_counter()
    cpu = LM(cfg, device="cpu", seed=None)
    cpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (PARITY_BATCH, PARITY_PROMPT))
    # The audio and vision families' stub inputs (CPU, bf16).
    extra = stub_inputs(cfg, rng, PARITY_BATCH)
    on_dev = {k: t.to(dev) for k, t in extra.items()}
    V = cfg.vocab

    # ---- layer by layer: each mixer and MLP fed the CPU's input ---------- #
    toks = torch.tensor(prompts)
    mix_worst: dict = {}
    router_worst = [0.0]
    # MoE: the CPU's routing of each layer, which the card's forward is fed
    # (a near-tie top-k that goes the other way would cascade through the
    # capacity ranks: ROADMAP's margin rule holds the routing itself).
    cpu_routing: list = [None] * len(cpu.layers)

    def check(i, key, fn, bg, bc, xc):
        """Part ``key`` of layer ``i`` on the CPU and on the card, fed the
        CPU's input: the CPU's output, after the card's is held to it."""
        yc = fn(cpu, bc, xc)
        ex = float(row_excess(fn(model, bg, xc.to(dev)).cpu(), yc).max())
        mix_worst[key] = max(mix_worst.get(key, -1.0), ex)
        if not ex <= MIX_ROW_TOL:
            fail(f"{cfg.name} parity: layer {i} {key} is {ex:.3g} row-RMS beyond "
                 f"one bf16 step of the CPU's (> {MIX_ROW_TOL})")
        return yc

    with torch.inference_mode():
        enc_c = None
        if cfg.family == "audio":
            # The encoder's layers (attention through B5, non-causal; the
            # GELU MLP), then its final norm on the CPU's input.
            ec = extra["frames"]
            for i, (bg, bc) in enumerate(zip(model.encoder.blocks, cpu.encoder.blocks)):
                ec = ec + check(i, "enc attn", lambda m, b, x: m._enc_attn(b, x), bg, bc, ec)
                ec = ec + check(i, "enc mlp", lambda m, b, x: m._enc_mlp(b, x), bg, bc, ec)
            enc_c = rmsnorm(ec, cpu.encoder.norm.scale, cfg.rms_eps)
        xc = cpu._embed(toks, extra.get("vision_embeds"))
        for i, (bg, bc) in enumerate(zip(model.layers, cpu.layers)):
            parts = [("mixer", lambda m, b, x: m._mixer(b, x, mode="train")[0])]
            if bc.kind == "xdec":
                # Cross attention: the encoder output (the CPU's) projected
                # and attended on each side.
                parts.append(("cross", lambda m, b, x: m._cross(
                    b, x, m._cross_kv(b, enc_c.to(x.device)))))
            if bc.kind != "ssd" and cfg.moe is not None:
                # The MoE MLP in two parts: the router's logits within
                # MOE_LOGIT_TOL of their largest magnitude of the CPU's, on
                # the CPU's input; dispatch, experts and combine fed the
                # CPU's routing.  fn runs on the CPU first, then the card.
                def moe_fn(m, b, x, _i=i, _seen={}):
                    if not x.is_cuda:
                        h = rmsnorm(x, b.norm2.scale, cfg.rms_eps).reshape(-1, cfg.d_model)
                        _seen["h"] = h
                        _seen["lc"] = router_logits(b.mlp.router, h)
                        _seen["rc"] = route(_seen["lc"], cfg.moe.top_k)
                        cpu_routing[_i] = _seen["rc"]
                        return m._mlp(b, x, _seen["rc"])[0]
                    lc = _seen["lc"]
                    lg = router_logits(b.mlp.router, _seen["h"].to(dev)).cpu()
                    rerr = float((lg - lc).abs().max()) / float(lc.abs().max())
                    router_worst[0] = max(router_worst[0], rerr)
                    if not rerr <= MOE_LOGIT_TOL:
                        fail(f"{cfg.name} parity: layer {_i} router logits {rerr:.3g} of "
                             f"max from the CPU's (> {MOE_LOGIT_TOL})")
                    return m._mlp(b, x, Routing(*(t.to(dev) for t in _seen["rc"])))[0]
                parts.append(("moe", moe_fn))
            elif bc.kind != "ssd":
                parts.append(("mlp", lambda m, b, x: m._mlp(b, x)[0]))
            for part, fn in parts:
                xc = xc + check(i, f"{bc.kind} {part}", fn, bg, bc, xc)
        cpu_lg = cpu._logits(xc)[..., :V].float()

        # ---- logits at every position, and the CPU's sensitivity ------- #
        fed = None
        if cfg.moe is not None:
            fed = [None if r is None else Routing(*(t.to(dev) for t in r))
                   for r in cpu_routing]
        card_lg = model(toks.to(dev), mode="train", routing=fed,
                        **on_dev)[0][..., :V].float().cpu()
        # One bf16 step at every input: the embedded prompt (the vision
        # embeddings with it) and, for audio, the encoder's frames.
        x = bf16_step_noise(cpu._embed(toks, extra.get("vision_embeds")))
        enc_n = cpu.encode(bf16_step_noise(extra["frames"])) if enc_c is not None else None
        for i, bc in enumerate(cpu.layers):
            x, _, _ = cpu._block(bc, x, mode="train", routing=cpu_routing[i], enc_out=enc_n)
        sens = (cpu._logits(x)[..., :V].float() - cpu_lg).abs().amax(-1)
    if not bool(torch.isfinite(sens).all()):
        fail(f"{cfg.name} parity: the CPU model's sensitivity is not finite")
    err = (card_lg - cpu_lg).abs().amax(-1)
    mag = cpu_lg.abs().amax(-1)
    bar = torch.clamp(LOGIT_SENS * sens, min=LOGIT_TOL)
    if not bool(torch.isfinite(card_lg).all()):
        fail(f"{cfg.name}: non-finite logits on the card")
    if bool((err > bar).any()):
        b, p = (int(t) for t in divmod(int((err - bar).argmax()), err.shape[1]))
        fail(f"{cfg.name} parity: row {b} position {p} logits differ by "
             f"{float(err[b, p]):.3g} > {float(bar[b, p]):.3g}")
    power = bar < mag
    if not bool(power.any()):
        fail(f"{cfg.name} parity: the logit bar is above the logits at every position")
    first_blind = [int(r.logical_not().int().argmax()) if not bool(r.all()) else None
                   for r in power]
    del card_lg, x

    # ---- the Engine on both --------------------------------------------- #
    reqs = [Request(p.astype(np.int32), PARITY_NEW) for p in prompts]
    scfg = ServeConfig(batch_size=PARITY_BATCH, max_prompt=PARITY_PROMPT,
                       max_new=PARITY_NEW)
    out = {}
    # MoE: the card's Engine replays the CPU Engine's routing, call by call.
    import repro_torch.models.moe as moe_mod
    own_route, routes, at = moe_mod.route, [], [0]

    def recorded(logits, k, gate_e=None):
        r = own_route(logits, k, gate_e)
        routes.append(r)
        return r

    def replayed(logits, k, gate_e=None):
        r = routes[at[0]]
        at[0] += 1
        if tuple(r.probs.shape) != tuple(logits.shape):
            fail(f"{cfg.name} parity: routing replay out of step")
        return Routing(*(t.to(logits.device) for t in r))

    for name, m in (("cpu", cpu), ("gpu", model)):
        seen = capture_logits(m)
        if cfg.moe is not None:
            moe_mod.route = recorded if name == "cpu" else replayed
        try:
            if extra:
                # The families with stub inputs: prefill with them, then
                # greedy decode steps (the Engine feeds tokens only).
                toks_out = greedy(m, toks.to(m.device), extra if name == "cpu" else on_dev,
                                  PARITY_NEW)
            else:
                toks_out = np.stack([r.tokens for r in Engine(cfg, m, scfg).generate(reqs)])
        finally:
            moe_mod.route = own_route
        release_logits(m)
        out[name] = (toks_out, seen)
    (g_tok, g_lg), (c_tok, c_lg) = out["gpu"], out["cpu"]
    worst, compared, flips, step_power = compare_steps(cfg, g_tok, g_lg, c_tok, c_lg,
                                                       bar[:, -1])
    del cpu
    return {"mixer_mlp_row_excess": mix_worst, "mixer_mlp_bar": MIX_ROW_TOL,
            "router_logit_err_over_max": router_worst[0] if cfg.moe is not None else None,
            "router_logit_bar": MOE_LOGIT_TOL if cfg.moe is not None else None,
            "logit_err_over_sens_max": float((err / sens).max()),
            "logit_err_max": float(err.max()), "sensitivity_max": float(sens.max()),
            "sensitivity_last": [float(t) for t in sens[:, -1]],
            "logit_bar_last": [float(t) for t in bar[:, -1]],
            "max_abs_logit": float(mag.max()),
            "positions_with_power": int(power.sum()), "positions": int(power.numel()),
            "first_position_without_power": first_blind,
            "engine_max_abs_logit_diff": worst, "engine_steps_with_power": step_power,
            "tokens_compared": compared, "allowed_flips": flips,
            "tokens_equal": bool(np.array_equal(g_tok, c_tok)),
            "parity_s": time.perf_counter() - t0}


def timed_calls(model) -> dict:
    """Wrap ``model.prefill`` and ``model.decode_step`` so each call's wall
    (synchronised on both ends) is recorded in ms; ``del model.prefill,
    model.decode_step`` removes the wrappers."""
    times: dict = {"prefill": [], "decode_step": []}
    for name in times:
        fn = getattr(model, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times[_name].append((time.perf_counter() - t) * 1e3)
            return out
        setattr(model, name, timed)
    return times


def lm_profile(arch: str, smi: str, prefill, step) -> dict:
    """Phase 15: one prefill and one decode step (``prefill()`` and
    ``step()`` run them) by the profiler: device time by kernel, B5-B7
    each summed over its CUDA kernels, launches, and the busy share against
    the median wall of warm runs."""
    prof = {"card": smi, "arch": arch}
    for name, fn, runs in (("prefill", prefill, 3), ("decode_step", step, 9)):
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        device_ms, kernels, profiled = profile_run(fn)
        warm_ms = float(np.median(walls))
        # The port's kernels, each summed over its CUDA kernels (B6 has 3).
        ours = {label: [(n, ms) for k, n, ms in kernels if part in k]
                for label, part in (("B5", "flash_fwd_wgmma"), ("B6", "ssd_"),
                                    ("B7", "rglru_kernel"))}
        prof[name] = {"warm_wall_ms": warm_ms, "warm_walls_ms": walls,
                      "profiled_wall_ms": profiled, "device_ms": device_ms,
                      "busy_share": device_ms / warm_ms,
                      "by_port_kernel": {label: {"launches": sum(n for n, _ in v),
                                                 "device_ms": sum(ms for _, ms in v)}
                                         for label, v in ours.items() if v},
                      "kernels": len(kernels),
                      "launches": sum(n for _, n, _ in kernels),
                      "top": [{"kernel": k, "count": n, "device_ms": ms}
                              for k, n, ms in kernels[:10]]}
    return prof


def lm_model(arch: str, dev) -> tuple:
    """``arch`` at full width on the card, random weights from seed 0, its
    LM head in float32; returns (model, seconds to build it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    t0 = time.perf_counter()
    model = LM(get_config(arch), device=dev, seed=0)
    model.head_f32()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def engine_traffic(model) -> tuple:
    """The Engine's traffic (phases 13, 14, 19 and 21 as text):
    LM_REQUESTS requests of LM_PROMPT_MIN..LM_PROMPT tokens from
    ``numpy.random.default_rng(0)``, LM_NEW new tokens each, batch LM_BATCH.
    Returns (generate, batches, record fields) for :func:`serve_run`; the
    one batch is the whole request list, which the Engine batches."""
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = model.cfg
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(LM_PROMPT_MIN, LM_PROMPT + 1, LM_REQUESTS)]
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), LM_NEW) for n in lens]
    engine = Engine(cfg, model, ServeConfig(batch_size=LM_BATCH, max_prompt=LM_PROMPT,
                                            max_new=LM_NEW))

    def generate(batch):
        out = engine.generate(batch)
        if [r.prompt_len for r in out] != [len(r.prompt) for r in batch] \
                or any(r.tokens.shape != (LM_NEW,) for r in out):
            fail(f"{cfg.name}: results {[(r.prompt_len, r.tokens.shape) for r in out]}")
        return np.stack([r.tokens for r in out])
    return generate, [reqs], {"max_prompt": LM_PROMPT, "prompt_lens": lens}


def stub_traffic(model) -> tuple:
    """The audio and vision families' traffic (phases 20 and 21):
    LM_REQUESTS prompts with lengths from ``numpy.random.default_rng(0)``
    in ``FAMILY_PROMPTS``, left-padded, in batches of LM_BATCH with the
    frontend stub's inputs (standard normal from the same generator),
    each served by :func:`greedy` (``LM.prefill`` with the stub inputs,
    LM_NEW - 1 ``LM.decode_step``s).  Returns (generate, batches, record
    fields) for :func:`serve_run`."""
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(0)
    lo_len, P = FAMILY_PROMPTS[cfg.name]
    lens = [int(n) for n in rng.integers(lo_len, P + 1, LM_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    stub = stub_inputs(cfg, rng, LM_REQUESTS)
    batches = [(torch.from_numpy(left_pad(prompts[lo:lo + LM_BATCH], P)).to(dev),
                {k: t[lo:lo + LM_BATCH].to(dev) for k, t in stub.items()})
               for lo in range(0, LM_REQUESTS, LM_BATCH)]
    return (lambda batch: greedy(model, *batch, LM_NEW)), batches, {
        "max_prompt": P, "prompt_lens": lens,
        "stub": {k: list(t.shape) for k, t in stub.items()}}


def serve_run(model, smi: str, zero_counts, expect_counts, want: dict, phase: int,
              traffic: tuple, fields: dict) -> dict:
    """Full-width serving (phases 13, 14 and 19-21): ``generate(batch)``
    over every batch of ``traffic`` (from :func:`engine_traffic` or
    :func:`stub_traffic`) with every launch count set to 0 just before and
    held to ``want`` just after, each prefill and decode step timed, and
    B5's launches inside ``LM.encode`` counted apart; then a warm, untimed
    run of the same batches for tokens/s."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    cfg, dev = model.cfg, model.device
    generate, batches, traffic_fields = traffic
    n_batches = LM_REQUESTS // LM_BATCH
    times = timed_calls(model)
    enc_launches = [0]
    encode = model.encode

    def counted_encode(*a, **kw):
        before = flash_attention_cuda.launches
        out = encode(*a, **kw)
        enc_launches[0] += flash_attention_cuda.launches - before
        return out
    model.encode = counted_encode
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    tokens = np.concatenate([generate(b) for b in batches])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = expect_counts(f"{cfg.name} serving", want)
    del model.prefill, model.decode_step, model.encode
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if tokens.shape != (LM_REQUESTS, LM_NEW) \
            or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        fail(f"{cfg.name}: generated tokens {tokens.shape}, in vocab "
             f"{bool(((tokens >= 0) & (tokens < cfg.vocab)).all())}")
    if len(times["prefill"]) != n_batches \
            or len(times["decode_step"]) != n_batches * (LM_NEW - 1):
        fail(f"{cfg.name}: {len(times['prefill'])} prefills and "
             f"{len(times['decode_step'])} decode steps")
    if cfg.family == "audio" and enc_launches[0] != n_batches * cfg.encoder.n_layers:
        fail(f"{cfg.name}: {enc_launches[0]} B5 launches in the encoder")
    # Warm, untimed run: tokens/s over the whole run.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = np.concatenate([generate(b) for b in batches])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    n_tok = LM_REQUESTS * LM_NEW
    rec = {"card": smi, "arch": cfg.name, **fields, "requests": LM_REQUESTS,
           "batch": LM_BATCH, "max_new": LM_NEW, **traffic_fields,
           "launches": {k: v for k, v in counts.items() if v},
           "prefill_ms": times["prefill"],
           "decode_ms_per_step_median": float(np.median(times["decode_step"])),
           "decode_ms_per_step_first_batch": times["decode_step"][:LM_NEW - 1],
           "cold_wall_s": wall, "warm_wall_s": warm, "tokens": n_tok,
           "tokens_per_s_warm": n_tok / warm,
           "repeat_tokens_equal": bool(np.array_equal(tokens, again)),
           "peak_memory_gb": peak_gb}
    if cfg.family == "audio":
        rec["encoder_b5_launches"] = enc_launches[0]
    log(f"phase {phase} {cfg.name} serving ({smi}): " + json.dumps(rec))
    return rec


def profile_and_parity(model, smi: str, phase: int, batch=None) -> tuple:
    """Phase 15's profile of one prefill of ``batch`` (tokens and the stub
    inputs; by default random tokens at the Engine's padded shape) and one
    decode step, with the MoE layers' share of the prefill; then the parity
    run against the CPU on the same weights (MoE models cut to
    PARITY_MOE_LAYERS layers, whisper to PARITY_FAMILY_LAYERS decoder and
    encoder layers).  Returns (profile, parity)."""
    import dataclasses

    from repro_torch.models import LM
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    if batch is None:
        batch = (torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                               device=dev), {})
    toks, extra = batch
    P_all = toks.shape[1] + (extra["vision_embeds"].shape[1] if "vision_embeds" in extra
                             else 0)
    caches = [None]

    def prefill():
        caches[0] = model.prefill(toks, max_cache_len=P_all + LM_NEW, **extra)[1]

    nxt = toks[:, -1:]
    pos = torch.full((toks.shape[0],), P_all, dtype=torch.int64, device=dev)

    def step():
        model.decode_step(nxt, pos, caches[0])

    prof = lm_profile(cfg.name, smi, prefill, step)
    del caches
    if cfg.moe is not None:
        # The MoE layers' share of the prefill: one layer's MLP at the
        # prefill's shape, by CUDA events, times the layer count.
        h = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        blk = model.layers[0]
        with torch.inference_mode():
            moe_ms = cuda_ms(lambda: model._mlp(blk, h), reps=3, inner=2)
        prof["prefill"]["moe_layer_ms"] = moe_ms
        prof["prefill"]["moe_share_of_device"] = cfg.n_layers * moe_ms / \
            prof["prefill"]["device_ms"]
        del h
    log(f"phase 15 profile {cfg.name} " + json.dumps(prof))

    # ---- parity (after 15's profile): the same weights on the card and on the CPU ------------ #
    cut = {}
    if cfg.moe is not None:
        cut = {"n_layers": PARITY_MOE_LAYERS}
        depth = f"cut to {PARITY_MOE_LAYERS} of {cfg.n_layers} layers"
    elif cfg.family == "audio":
        cut = {"n_layers": PARITY_FAMILY_LAYERS,
               "encoder": dataclasses.replace(cfg.encoder, n_layers=PARITY_FAMILY_LAYERS)}
        depth = (f"cut to {PARITY_FAMILY_LAYERS} of {cfg.n_layers} decoder and "
                 f"{PARITY_FAMILY_LAYERS} of {cfg.encoder.n_layers} encoder layers")
    if cut:
        # The CPU's time: a model cut in depth, same widths and seed.
        pcfg = dataclasses.replace(cfg, **cut)
        pmodel = LM(pcfg, device=dev, seed=0)
        par = serve_parity(pcfg, pmodel, dev)
        par["depth"] = depth
        del pmodel
        torch.cuda.empty_cache()
    else:
        par = serve_parity(cfg, model, dev)
    log(f"phase {phase} {cfg.name} parity card vs CPU: " + json.dumps(par))
    return prof, par


def serve_model(arch: str, dev, smi: str, zero_counts, expect_counts, want: dict,
                phase: int, after=None) -> dict:
    """Phases 13, 14, 19 and 20 with this model's part of 15: ``arch``
    served at full width (the Engine's traffic; whisper's through
    ``LM.prefill(frames=)``), its profile and its parity run; then
    ``after(model)``, whose result lands under ``"after"``."""
    model, init_s = lm_model(arch, dev)
    traffic = (stub_traffic if model.cfg.family == "audio" else engine_traffic)(model)
    rec = serve_run(model, smi, zero_counts, expect_counts, want, phase, traffic,
                    {"params": sum(p.numel() for p in model.parameters()),
                     "init_s": init_s})
    batch = traffic[1][0] if model.cfg.family == "audio" else None
    rec["profile"], rec["parity"] = profile_and_parity(model, smi, phase, batch)
    if after is not None:
        rec["after"] = after(model)
    del model, traffic
    torch.cuda.empty_cache()
    return rec


def cache_bytes(caches: list) -> int:
    def leaves(c):
        for v in c.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))
    return sum(t.numel() * t.element_size() for c in caches for t in leaves(c))


def int8_decode(cfg, model, dev, smi: str, batches: list, bar_last) -> dict:
    """Phase 21's int8 KV cache: the model's decode with
    ``kv_quant_int8=True`` (the same weights) against its bf16 cache, step
    by step in turns (LM_NEW - 1 steps from one batch's prefill, the order
    swapped every step), with both caches' bytes; then the int8 path held
    to the CPU port's: the card quantizing its own bf16 prefill k and v
    gives the int8 slots and scales the CPU's quantization of the same
    values gives, bit for bit; and the card's int8 greedy run (the parity
    prompts) against the CPU's under the margin rule, within the bf16
    parity's last-position bar ``bar_last``."""
    import dataclasses

    from repro_torch.models import LM
    from repro_torch.models.attention import _quantize
    qcfg = dataclasses.replace(cfg, kv_quant_int8=True)
    qmodel = LM(qcfg, device=dev, seed=None)
    qmodel.load_state_dict(model.state_dict())
    toks, extra = batches[0]
    P_all = toks.shape[1] + extra["vision_embeds"].shape[1]
    lg, bf_c = model.prefill(toks, max_cache_len=P_all + LM_NEW, **extra)
    lq, q_c = qmodel.prefill(toks, max_cache_len=P_all + LM_NEW, **extra)
    if q_c[0]["k"].dtype != torch.int8 or not torch.equal(lg, lq):
        fail(f"{cfg.name} int8: cache {q_c[0]['k'].dtype}; prefill logits equal to the "
             f"bf16 model's: {bool(torch.equal(lg, lq))}")
    # The card's int8 prefill slots against the CPU's quantization of the
    # card's own bf16 k and v (the two prefills compute them alike).
    for i, (c, q) in enumerate(zip(bf_c, q_c)):
        for name in ("k", "v"):
            want_q, want_s = _quantize(c[name].cpu())
            live = c["pos"].cpu() >= 0
            if not (torch.equal(q[name].cpu()[live], want_q[live])
                    and torch.equal(q[f"{name}_scale"].cpu()[live], want_s[live])):
                fail(f"{cfg.name} int8: layer {i} {name} slots differ from the CPU's "
                     "quantization of the same bf16 values")
    sizes = {"bf16": cache_bytes(bf_c), "int8": cache_bytes(q_c)}
    pos = torch.full((LM_BATCH,), P_all, dtype=torch.int64, device=dev)
    nxt = {"bf16": torch.argmax(lg, -1)[:, None], "int8": torch.argmax(lq, -1)[:, None]}
    state = {"bf16": (model, bf_c), "int8": (qmodel, q_c)}
    ms: dict = {"bf16": [], "int8": []}
    agree = 0
    for step in range(LM_NEW - 1):
        order = ("bf16", "int8") if step % 2 == 0 else ("int8", "bf16")
        for name in order:
            m, c = state[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, c = m.decode_step(nxt[name], pos, c)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            state[name] = (m, c)
            nxt[name] = torch.argmax(logits, -1)[:, None]
        agree += int((nxt["bf16"] == nxt["int8"]).sum())
        pos = pos + 1
    # One more step of each under the profiler: device time, kernel
    # launches and copies to the device.
    split = {}
    for name, (m, c) in state.items():
        dev_ms, kernels, _ = profile_run(lambda: m.decode_step(nxt[name], pos, c))
        split[name] = {"device_ms": dev_ms, "launches": sum(n for _, n, _ in kernels),
                       "copies_to_device": sum(n for k, n, _ in kernels if "HtoD" in k)}
    del bf_c, q_c, state

    # ---- the int8 path, card against the CPU port ------------------------ #
    cpu = LM(qcfg, device="cpu", seed=None)
    cpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(1)
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (PARITY_BATCH, PARITY_PROMPT)))
    pextra = stub_inputs(cfg, rng, PARITY_BATCH)
    out = {}
    for name, m, kw in (("cpu", cpu, pextra),
                        ("gpu", qmodel, {k: t.to(dev) for k, t in pextra.items()})):
        seen = capture_logits(m)
        toks_out = greedy(m, prompts.to(m.device), kw, PARITY_NEW)
        release_logits(m)
        out[name] = (toks_out, seen)
    (g_tok, g_lg), (c_tok, c_lg) = out["gpu"], out["cpu"]
    worst, compared, flips, power = compare_steps(qcfg, g_tok, g_lg, c_tok, c_lg, bar_last)
    del cpu, qmodel
    torch.cuda.empty_cache()
    rec = {"card": smi, "decode_ms_per_step_median": {k: float(np.median(v))
                                                      for k, v in ms.items()},
           "decode_ms_per_step": ms, "profiled_step": split, "cache_bytes": sizes,
           "greedy_tokens_equal_to_bf16": f"{agree} of {LM_BATCH * (LM_NEW - 1)}",
           "slots_equal_cpu_quantization": True,
           "parity": {"engine_max_abs_logit_diff": worst, "tokens_compared": compared,
                      "allowed_flips": flips, "steps_with_power": power,
                      "tokens_equal": bool(np.array_equal(g_tok, c_tok))}}
    log(f"phase 21 {cfg.name} int8 KV cache ({smi}): " + json.dumps(rec))
    return rec


def serve_smoke(arch: str, dev, smi: str, zero_counts, expect_counts) -> dict:
    """Phase 14's smoke-configuration run: ``arch``'s smoke config (mamba2:
    head_dim 16, state_dim 16, B6's SIMT route) served on the card with the
    counts set to 0 just before, then held to the CPU model on the same
    weights by :func:`serve_parity` (each layer, the logits at every
    position, the Engine's logits and tokens)."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.ssd import ssd_cuda
    from repro_torch.models import LM
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = smoke_config(arch)
    model = LM(cfg, device=dev, seed=0)
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(0, cfg.vocab, 24).astype(np.int32), 4) for _ in range(2)]
    engine = Engine(cfg, model, ServeConfig(batch_size=2, max_prompt=32, max_new=4))
    n_ssd = sum(k == "ssd" for k in model.kinds)
    torch.cuda.synchronize()
    zero_counts()
    results = engine.generate(reqs)
    torch.cuda.synchronize()
    counts = expect_counts(f"{arch} smoke config serving", {"B6": n_ssd})
    if ssd_cuda.route_launches["simt"] != n_ssd:
        fail(f"{arch} smoke: {ssd_cuda.route_launches} B6 launches by route")
    par = serve_parity(cfg, model, dev)
    rec = {"card": smi, "arch": arch, "config": "smoke", "launches": counts["B6"],
           "simt_launches": n_ssd, "tokens": [r.tokens.tolist() for r in results],
           "parity": par}
    log(f"phase 14 {arch} smoke config on the card: " + json.dumps(rec))
    return rec


def served_tokens(out) -> list:
    return [r.tokens.tolist() for r in out]


def actor_network_run(eng, reqs: list, plan, arrivals=None) -> tuple:
    """The actor engine's network for ``reqs`` run once under ``plan``:
    (per-request tokens, RunResult, the retire sink)."""
    net = eng.build_network(reqs, arrivals=arrivals)
    prog = net.compile(plan)
    res = prog.run()
    sink = {k: v.cpu().numpy() for k, v in prog.collect("retire", res.state).items()}
    return ([sink["gen"][j, :sink["lens"][j]].tolist() for j in range(len(reqs))],
            res, sink)


def actor_serving(dev, smi: str, zero_counts, expect_counts) -> dict:
    """Phase 22: recurrentgemma-2b served through ``ActorEngine`` (the
    admission/gate/decode/merge/retire network, host dynamic executor) at
    its published width, random weights from seed 0, on phase 13's
    traffic, eos_id None: closed loop (every budget 32, every arrival 0)
    and open loop (budgets alternating 32 and 8, arrivals
    ``poisson_trace(8, 0.25, seed=7)``).  Checks: the closed loop's tokens
    equal the ``Engine``'s bit for bit, and decode, admission, merge and
    retire fire equally often; each open-loop request's tokens equal its
    closed-loop tokens up to its budget; fire counts, sweeps, latency steps
    and statuses, and under ``guards=True, trace=True`` the high-water
    marks and every trace event, equal a CPU run of the port at
    ``smoke_config("recurrentgemma-2b")`` on the same budgets, arrivals, B
    and N (prompts of 16); ``expire_deadline`` (request 2 a timeout with no
    tokens), ``queue_depth=0`` (the requests beyond the first 4 shed) and
    a poisoned request 3 under ``on_fault="quarantine"`` (retired as a
    fault after one retry, the other 7 with their closed-loop tokens), each
    against the CPU run's statuses; out-of-range ids give NaN rows and NaN
    logits argmax to the first NaN, as on the CPU (C12).  Every count is
    set to 0 just before each run: 8 B5 and 18 B7 launches per decode
    firing that ran a prefill.  Then ``ActorEngine.generate`` and
    ``Engine.generate`` on the closed loop, timed in turns, 3 each."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import ExecutionPlan
    from repro_torch.core.faultinject import POISON_VALUE, expire_deadline, poison_request
    from repro_torch.graphs.serving import ServingWorkload, left_pad_prompts, poisson_trace
    from repro_torch.models import LM
    from repro_torch.models.layers import embed_lookup
    from repro_torch.serve import ActorEngine, Engine, Request, ServeConfig

    # C12 on the card: the lookup's NaN rows and argmax over NaN logits.
    table = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    ids = torch.tensor([-2 ** 20, -10, -1, 0, 9, 10, 2 ** 20])
    got, want = embed_lookup(table.to(dev), ids.to(dev)).cpu(), embed_lookup(table, ids)
    if not torch.equal(torch.isnan(got), torch.isnan(want)) \
            or not torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0)) \
            or torch.isnan(want).any(-1).tolist() != [True, False, False, False, False,
                                                        True, True]:
        fail(f"embed_lookup on out-of-range ids: card {got.tolist()} vs CPU {want.tolist()}")
    lg = torch.tensor([[1.0, float("nan"), 3.0], [float("nan")] * 3])
    if torch.argmax(lg.to(dev), dim=-1).tolist() != [1, 0]:
        fail(f"argmax over NaN logits on the card: {torch.argmax(lg.to(dev), -1).tolist()}")

    model, init_s = lm_model("recurrentgemma-2b", dev)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(LM_PROMPT_MIN, LM_PROMPT + 1, LM_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    budgets = {"closed": [LM_NEW] * LM_REQUESTS,
               "open": [LM_NEW if i % 2 == 0 else 8 for i in range(LM_REQUESTS)]}
    arrivals = {"closed": None, "open": poisson_trace(LM_REQUESTS, 0.25, seed=7)}
    scfg = ServeConfig(batch_size=LM_BATCH, max_prompt=LM_PROMPT, max_new=LM_NEW)
    reqs = {k: [Request(p, m) for p, m in zip(prompts, b)] for k, b in budgets.items()}
    slab, plens = left_pad_prompts(prompts, LM_PROMPT)
    workload = ServingWorkload(prompts=slab, prompt_lens=plens,
                               budgets=np.asarray(budgets["closed"], np.int32),
                               arrivals=np.zeros(LM_REQUESTS, np.int32))
    deadlines = expire_deadline(workload, 2).deadlines
    poisoned = list(reqs["closed"])
    poisoned[3] = Request(poison_request(workload, 3).prompts[3], LM_NEW)
    guarded = ExecutionPlan(mode="dynamic", guards=True)
    traced = ExecutionPlan(mode="dynamic", guards=True, trace=True)

    # The CPU run of the same structure: smoke config, prompts of 16.
    ccfg = smoke_config("recurrentgemma-2b")
    cmodel = LM(ccfg, device="cpu", seed=0)
    crng = np.random.default_rng(1)
    creqs = {k: [Request(crng.integers(0, ccfg.vocab, 16).astype(np.int32), m) for m in b]
             for k, b in budgets.items()}
    cscfg = ServeConfig(batch_size=LM_BATCH, max_prompt=16, max_new=LM_NEW)
    cpu: dict = {}
    ceng = ActorEngine(ccfg, cmodel, cscfg)
    ceng.generate(creqs["open"], arrivals=arrivals["open"])
    cpu["open"] = (ceng.last_fire_counts, ceng.last_sweeps,
                   ceng.last_latency_steps.tolist(), ceng.last_status)
    _, cres, _ = actor_network_run(ActorEngine(ccfg, cmodel, cscfg, plan=traced),
                                   creqs["closed"], traced)
    cpu["traced"] = (cres.diagnostics.high_water, cres.trace.events)
    ceng.generate(creqs["closed"], deadlines=deadlines)
    cpu["expire"] = ceng.last_status
    shed = ActorEngine(ccfg, cmodel, cscfg, queue_depth=0)
    shed.generate(creqs["closed"])
    cpu["shed"] = shed.last_status
    cbad = list(creqs["closed"])
    cbad[3] = Request(np.full(16, POISON_VALUE, np.int32), LM_NEW)
    cq = ActorEngine(ccfg, cmodel, cscfg, plan=guarded)
    cq.generate(cbad, on_fault="quarantine")
    cpu["quarantine"] = (cq.last_status, cq.last_retries)

    # Decode firings that ran a prefill: LM.prefill is called by them only.
    n_prefill = [0]
    prefill = model.prefill

    def counted_prefill(*a, **kw):
        n_prefill[0] += 1
        return prefill(*a, **kw)
    model.prefill = counted_prefill

    def counted(label: str, fn):
        torch.cuda.synchronize()
        zero_counts()
        n_prefill[0] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts(f"phase 22 {label}", {"B5": 8 * n_prefill[0], "B7": 18 * n_prefill[0]})
        return out, wall, n_prefill[0]

    engine = Engine(cfg, model, scfg)
    want, _, _ = counted("Engine", lambda: served_tokens(engine.generate(reqs["closed"])))
    actor = ActorEngine(cfg, model, scfg)
    rec: dict = {"card": smi, "arch": cfg.name, "init_s": init_s, "requests": LM_REQUESTS,
                 "batch": LM_BATCH, "max_prompt": LM_PROMPT, "max_new": LM_NEW,
                 "prompt_lens": lens, "open_budgets": budgets["open"],
                 "open_arrivals": arrivals["open"].tolist()}

    # 1. Closed loop.
    closed, wall, pf = counted("closed loop", lambda: served_tokens(
        actor.generate(reqs["closed"])))
    if closed != want:
        bad = [i for i in range(LM_REQUESTS) if closed[i] != want[i]]
        fail(f"phase 22: closed-loop tokens of requests {bad} differ from the Engine's")
    fc = actor.last_fire_counts
    if not fc["decode"] == fc["admission"] == fc["merge"] == fc["retire"]:
        fail(f"phase 22: closed-loop fire counts {fc}")
    rec["closed"] = {"wall_s": wall, "prefill_firings": pf, "fire_counts": fc,
                     "sweeps": actor.last_sweeps, "b5": 8 * pf, "b7": 18 * pf,
                     "latency_steps": actor.last_latency_steps.tolist()}

    # 2. Open loop.
    opened, wall, pf = counted("open loop", lambda: served_tokens(
        actor.generate(reqs["open"], arrivals=arrivals["open"])))
    for i, b in enumerate(budgets["open"]):
        if opened[i] != closed[i][:b]:
            fail(f"phase 22: open-loop request {i} tokens differ from its closed-loop prefix")
    got = (actor.last_fire_counts, actor.last_sweeps, actor.last_latency_steps.tolist(),
           actor.last_status)
    if got != cpu["open"]:
        fail(f"phase 22: open-loop structure {got} vs the CPU run's {cpu['open']}")
    n_open = sum(budgets["open"])
    rec["open"] = {"wall_s": wall, "prefill_firings": pf, "fire_counts": got[0],
                   "sweeps": got[1], "latency_steps": got[2], "tokens": n_open,
                   "tokens_per_s": n_open / wall}

    # 3. Guards and trace on the closed loop.
    (toks, res, _), wall, pf = counted("closed loop guarded+traced", lambda: actor_network_run(
        ActorEngine(cfg, model, scfg, plan=traced), reqs["closed"], traced))
    if toks != closed or not res.diagnostics.ok:
        fail(f"phase 22: guarded closed loop: tokens equal {toks == closed}, "
             f"{res.diagnostics.summary()}")
    if res.diagnostics.high_water != cpu["traced"][0] \
            or not np.array_equal(res.trace.events, cpu["traced"][1]):
        fail("phase 22: guarded closed loop: high-water marks or trace events differ "
             "from the CPU run's")
    rec["guarded_traced"] = {"wall_s": wall, "events": int(res.trace.n_events),
                             "high_water": res.diagnostics.high_water}

    # 4. Resilience.
    out, wall, pf = counted("expire_deadline", lambda: actor.generate(
        reqs["closed"], deadlines=deadlines))
    if actor.last_status != cpu["expire"] or actor.last_status[2] != "timeout" \
            or out[2].tokens.size or [served_tokens(out)[i] for i in (0, 1, 3, 4, 5, 6, 7)] \
            != [closed[i] for i in (0, 1, 3, 4, 5, 6, 7)]:
        fail(f"phase 22: expire_deadline statuses {actor.last_status} vs {cpu['expire']}")
    rec["expire"] = {"status": actor.last_status, "wall_s": wall}
    shed = ActorEngine(cfg, model, scfg, queue_depth=0)
    out, wall, pf = counted("queue_depth=0", lambda: shed.generate(reqs["closed"]))
    if shed.last_status != cpu["shed"] or shed.last_status != ["ok"] * 4 + ["shed"] * 4 \
            or served_tokens(out)[:4] != closed[:4] or any(r.tokens.size for r in out[4:]):
        fail(f"phase 22: queue_depth=0 statuses {shed.last_status} vs {cpu['shed']}")
    rec["shed"] = {"status": shed.last_status, "wall_s": wall}
    quar = ActorEngine(cfg, model, scfg, plan=guarded)
    out, wall, pf = counted("quarantine", lambda: quar.generate(poisoned,
                                                                on_fault="quarantine"))
    got = (quar.last_status, quar.last_retries)
    if got != cpu["quarantine"] or quar.last_status[3] != "fault" \
            or quar.last_retries != 1 or out[3].tokens.size \
            or [served_tokens(out)[i] for i in range(LM_REQUESTS) if i != 3] \
            != [closed[i] for i in range(LM_REQUESTS) if i != 3]:
        fail(f"phase 22: quarantine {got} vs the CPU run's {cpu['quarantine']}")
    rec["quarantine"] = {"status": quar.last_status, "retries": quar.last_retries,
                         "prefill_firings": pf, "wall_s": wall}

    # 5. Timing, in turns: ActorEngine, Engine, three each.
    walls: dict = {"actor": [], "engine": []}
    for _ in range(3):
        for label, fn in (("actor", lambda: actor.generate(reqs["closed"])),
                          ("engine", lambda: engine.generate(reqs["closed"]))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
    n_tok = LM_REQUESTS * LM_NEW
    rec["timing"] = {
        "walls_s": walls,
        "tokens": n_tok,
        "tokens_per_s": {k: n_tok / float(np.median(v)) for k, v in walls.items()},
        "engine_decode_steps": engine.last_decode_steps * (LM_REQUESTS // LM_BATCH),
        "engine_prefills": LM_REQUESTS // LM_BATCH,
        "actor_decode_firings": actor.last_fire_counts["decode"],
        "actor_prefill_firings": rec["closed"]["prefill_firings"],
        "actor_sweeps": actor.last_sweeps}
    del model.prefill
    log("phase 22 recurrentgemma-2b through ActorEngine (" + smi + "): " + json.dumps(rec))
    log(f"phase 22 closed loop: ActorEngine {np.median(walls['actor']):.3f} s vs Engine "
        f"{np.median(walls['engine']):.3f} s (median of 3, in turns); "
        f"{rec['closed']['prefill_firings']} prefill firings -> "
        f"{8 * rec['closed']['prefill_firings']} B5 and "
        f"{18 * rec['closed']['prefill_firings']} B7 launches")
    del model, engine, actor, shed, quar
    torch.cuda.empty_cache()
    return rec


LM_STAGES, LM_MICRO = 4, 4       # phase 23(c): 4 stages, 4 microbatches


def lm_stage_phase(model, smi: str, zero_counts, expect_counts) -> dict:
    """Phase 23(c): mamba2-780m (phase 14's model and weights) as the LM
    stage network, 4 stages of 12 layers, streamed in dynamic mode over 4
    microbatches of LM_PROMPT tokens (2 chunks), chunked, persistent and
    resumed from a snapshot; held to the static run, to
    ``pipeline_forward_reference`` and to ``LM.forward`` at batch 4."""
    import shutil
    import tempfile
    from repro_torch.core.pipeline import pipeline_reference
    from repro_torch.graphs.lm_pipeline import (build_lm_stage_network, make_stage_fn,
                                                pipeline_forward_reference,
                                                stack_stage_params)
    cfg, V = model.cfg, model.cfg.vocab
    n_ssd = sum(k == "ssd" for k in model.kinds)
    per_stream = n_ssd * LM_MICRO                      # B6 calls a stream
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_MICRO, LM_PROMPT)))
    net = build_lm_stage_network(model, cfg, tokens, LM_STAGES)
    accel = tuple(f"stage{s}" for s in range(LM_STAGES))
    x = net.actors["source"].init()[0]                 # (4, S, D) bf16 embeddings
    feeds = {"f_s0": x[:, None]}
    prog = net.compile(mode="dynamic", n_iterations=LM_MICRO // 2, accelerated=accel)

    def counted(label, fn, want):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts(label, {"B6": want})
        return out, wall

    chunked, wall_c = counted("phase 23 LM stage stream, chunked",
                              lambda: prog.stream(feeds)["f_out"][:, 0], per_stream)
    persistent, wall_p = counted("phase 23 LM stage stream, persistent",
                                 lambda: prog.stream(feeds, persistent=True)["f_out"][:, 0],
                                 per_stream)
    full = net.compile(mode="static", n_iterations=LM_MICRO)
    static, _ = counted("phase 23 LM stage network, static",
                        lambda: full.collect("sink", full.run().state), per_stream)
    oracle, _ = counted("phase 23 pipeline_reference",
                        lambda: pipeline_reference(make_stage_fn(model),
                                                   stack_stage_params(model, cfg, LM_STAGES),
                                                   x), per_stream)
    if not (torch.equal(chunked, persistent) and torch.equal(chunked, static)
            and torch.equal(chunked, oracle)):
        fail("phase 23 LM stages: the streamed activations differ from the static run "
             "or pipeline_reference")
    with torch.no_grad():
        stage_lg = model._logits(chunked)[..., :V]
    ref_lg, _ = counted("phase 23 pipeline_forward_reference",
                        lambda: pipeline_forward_reference(model, cfg, tokens, LM_STAGES),
                        per_stream)
    if not torch.equal(stage_lg, ref_lg[..., :V]):
        fail("phase 23 LM stages: logits differ from pipeline_forward_reference")
    del ref_lg
    # LM.forward at batch 4, and its own change when the embedded input
    # moves one bf16 step: the logit bar of phases 13-14.
    with torch.no_grad():
        fwd = model(tokens.to(model.device), mode="train")[0][..., :V]
        xn = bf16_step_noise(model._embed(tokens.to(model.device)))
        for blk in model.layers:
            xn, _, _ = model._block(blk, xn, mode="train")
        sens = (model._logits(xn)[..., :V] - fwd).abs().amax(-1)
        err = (stage_lg - fwd).abs().amax(-1)
        mag = fwd.abs().amax(-1)
    del xn
    bar = torch.clamp(LOGIT_SENS * sens, min=LOGIT_TOL)
    if not bool(torch.isfinite(sens).all()):
        fail("phase 23 LM stages: LM.forward's sensitivity is not finite")
    if not bool(torch.isfinite(stage_lg).all()) or bool((err > bar).any()):
        fail(f"phase 23 LM stages: logits differ from LM.forward by {float(err.max()):.3g}, "
             f"bar {float(bar.min()):.3g}-{float(bar.max()):.3g}")
    logit = {"err_max": float(err.max()), "err_over_bar_max": float((err / bar).max()),
             "sensitivity_max": float(sens.max()), "logit_mag_min": float(mag.min()),
             "positions_with_power": int((bar < mag).sum())}
    del stage_lg, fwd, sens, err, mag, bar
    # Durable: a snapshot a chunk; a fresh program resumes from chunk 1's.
    d = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        _, wall_ck = counted("phase 23 LM stage stream, checkpointed",
                             lambda: prog.stream(feeds, checkpoint_dir=os.path.join(d, "all"),
                                                 checkpoint_every=1), per_stream)
        snap = os.path.join(d, "all", "chunk_00000001")
        snap_bytes = sum(os.path.getsize(os.path.join(snap, f)) for f in os.listdir(snap))
        shutil.copytree(snap, os.path.join(d, "one", "chunk_00000001"))
        fresh = net.compile(mode="dynamic", n_iterations=LM_MICRO // 2, accelerated=accel)
        resumed, wall_r = counted(
            "phase 23 LM stage stream, resumed",
            lambda: fresh.resume_stream(os.path.join(d, "one"), feeds)["f_out"][:, 0],
            per_stream // 2)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not torch.equal(resumed, chunked):
        fail("phase 23 LM stages: the resumed stream differs from the uninterrupted one")
    walls = {"chunked": [], "persistent": []}
    for _ in range(3):
        for label, kw in (("chunked", {}), ("persistent", {"persistent": True})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog.stream(feeds, **kw)
            torch.cuda.synchronize()
            walls[label].append((time.perf_counter() - t0) * 1e3)
    n_tok = LM_MICRO * LM_PROMPT
    rec = {"card": smi, "model": cfg.name, "stages": LM_STAGES, "microbatches": LM_MICRO,
           "tokens": n_tok, "b6_calls_per_stream": per_stream,
           "b6_cuda_launches_per_stream": per_stream * 3,
           "walls_ms": walls, "first_walls_ms": {"chunked": wall_c * 1e3,
                                                "persistent": wall_p * 1e3,
                                                "checkpointed": wall_ck * 1e3,
                                                "resumed": wall_r * 1e3},
           "tokens_per_s": {k: n_tok / (float(np.median(v)) / 1e3) for k, v in walls.items()},
           "snapshot_bytes_chunk1": snap_bytes, "logits_vs_forward": logit,
           "bit_identical": ["persistent", "static run", "pipeline_reference",
                             "pipeline_forward_reference logits", "resumed from chunk 1"]}
    log("phase 23 lm_stages " + json.dumps(rec))
    log(f"phase 23 LM stages ({smi}): mamba2-780m in {LM_STAGES} stages, "
        f"{n_tok} tokens: chunked {np.median(walls['chunked']):.1f} ms "
        f"({rec['tokens_per_s']['chunked']:.0f} tokens/s), persistent "
        f"{np.median(walls['persistent']):.1f} ms, {per_stream} B6 calls a stream; "
        f"snapshot {snap_bytes} B")
    return rec


def lm_serving(dev, smi: str, zero_counts, expect_counts) -> list:
    """Phases 12-15, 19-22 and 24; returns the kernels line's records of B5, B6
    and B7 and of B5's float route and B6's SIMT route."""
    recs = lm_kernels(dev, smi)
    torch.cuda.empty_cache()
    rg = serve_model("recurrentgemma-2b", dev, smi, zero_counts, expect_counts,
                     {"B5": 16, "B7": 36}, 13)
    # 22. recurrentgemma-2b through the actor engine.
    act = actor_serving(dev, smi, zero_counts, expect_counts)
    # 23(c). mamba2-780m's stage network, on phase 14's model.
    mb = serve_model("mamba2-780m", dev, smi, zero_counts, expect_counts, {"B6": 96}, 14,
                     after=lambda m: lm_stage_phase(m, smi, zero_counts, expect_counts))
    smoke = serve_smoke("mamba2-780m", dev, smi, zero_counts, expect_counts)
    ol = serve_model("olmoe-1b-7b", dev, smi, zero_counts, expect_counts, {"B5": 32}, 19)
    # 20. whisper-small: 12 encoder (non-causal) and 12 decoder B5 launches
    # a prefill, two batches.
    wh = serve_model("whisper-small", dev, smi, zero_counts, expect_counts, {"B5": 48}, 20)
    # 21. internvl2-1b: 24 B5 launches a prefill with the vision embeddings
    # and served as text through the Engine, then the int8 KV cache.
    imodel, init_s = lm_model("internvl2-1b", dev)
    icfg = imodel.cfg
    fields = {"params": sum(p.numel() for p in imodel.parameters()), "init_s": init_s}
    vision = stub_traffic(imodel)
    iv = serve_run(imodel, smi, zero_counts, expect_counts, {"B5": 48}, 21, vision, fields)
    iv["profile"], iv["parity"] = profile_and_parity(imodel, smi, 21, vision[1][0])
    it = serve_run(imodel, smi, zero_counts, expect_counts, {"B5": 48}, 21,
                   engine_traffic(imodel), fields)
    q8 = int8_decode(icfg, imodel, dev, smi, vision[1], iv["parity"]["logit_bar_last"])
    del imodel, vision
    torch.cuda.empty_cache()
    log("phase 21 internvl2-1b summary " + json.dumps({
        "card": smi, "vision_prefill_ms": iv["prefill_ms"],
        "vision_decode_ms_per_step_median": iv["decode_ms_per_step_median"],
        "vision_tokens_per_s_warm": iv["tokens_per_s_warm"],
        "text_engine_prefill_ms": it["prefill_ms"],
        "text_engine_decode_ms_per_step_median": it["decode_ms_per_step_median"],
        "text_engine_tokens_per_s_warm": it["tokens_per_s_warm"],
        "int8_decode_ms_per_step_median": q8["decode_ms_per_step_median"],
        "int8_profiled_step": q8["profiled_step"],
        "cache_bytes": q8["cache_bytes"]}))
    recs["B5"]["olmoe_shape"]["launches"] = ol["launches"]["B5"]
    recs["B5"]["olmoe_shape"]["launches_from"] = "phase 19: olmoe-1b-7b served"
    recs["B5"]["whisper_enc_shape"]["launches"] = wh["encoder_b5_launches"]
    recs["B5"]["whisper_enc_shape"]["launches_from"] = (
        "phase 20: whisper-small served, counted inside LM.encode")
    recs["B5"]["whisper_dec_shape"]["launches"] = \
        wh["launches"]["B5"] - wh["encoder_b5_launches"]
    recs["B5"]["whisper_dec_shape"]["launches_from"] = (
        f"phase 20: whisper-small served, its {wh['launches']['B5']} B5 launches less "
        "the encoder's")
    recs["B5"]["internvl_shape"]["launches"] = iv["launches"]["B5"]
    recs["B5"]["internvl_shape"]["launches_from"] = (
        f"phase 21: internvl2-1b served with its vision embeddings ({it['launches']['B5']} "
        "more at the same shape served as text through the Engine)")
    recs["B5"]["launches"] = rg["launches"]["B5"]
    recs["B7"]["launches"] = rg["launches"]["B7"]
    for k, per in (("B5", 8), ("B7", 18)):
        recs[k]["actor_serving"] = {
            "launches": per * act["closed"]["prefill_firings"],
            "launches_from": "phase 22: recurrentgemma-2b's closed loop through "
                             f"ActorEngine, {per} per decode firing that ran a prefill "
                             f"({act['closed']['prefill_firings']})"}
    recs["B6"]["launches"] = mb["launches"]["B6"]
    recs["B6"]["lm_stage"] = {
        "launches": mb["after"]["b6_calls_per_stream"],
        "launches_from": "phase 23(c): mamba2-780m's 4-stage network streamed, per stream "
                         "(48 calls a microbatch at batch 1)",
        "walls_ms": mb["after"]["walls_ms"], "tokens_per_s": mb["after"]["tokens_per_s"]}
    recs["B6_simt"]["launches"] = smoke["simt_launches"]
    recs["B6_simt"]["launches_from"] = "phase 14: mamba2-780m's smoke config served"
    # 24. mamba2-780m trained on the card, its trained weights served.
    train = train_phase(dev, smi, zero_counts, expect_counts)
    recs["B6"]["trained_weights"] = {
        "launches": train["d"]["b6_launches"],
        "launches_from": "phase 24(d): mamba2-780m's weights after phase 24(b)'s 8 steps, "
                         "one prefill of 4 x 4096 tokens",
        "logit_err": train["d"]["logit_err"], "bar": train["d"]["bar"]}
    out = [{"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
            "function": "flash_attention_pallas", **recs["B5"]},
           {"name": "ssd", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:63",
            "function": "ssd_pallas", **recs["B6"]},
           {"name": "rglru", "route": "cuda", "source": "src/repro_torch/csrc/rglru.cu",
            "replaces": "src/repro/kernels/rglru/kernel.py:43",
            "function": "rglru_pallas", **recs["B7"]},
           {"name": "flash_attention.ffma", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
            "function": "flash_attention_pallas (float32 and f16 inputs)",
            **recs["B5_ffma"]},
           {"name": "ssd.simt", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:63",
            "function": "ssd_pallas (any head and state width)", **recs["B6_simt"]}]
    return out


# ---- 23. durable and heterogeneous runs -------------------------------- #
STREAM_CHUNK = 16          # windows a chunk: 4 chunks of phase 3's 64 firings

# The child processes of phase 23(b): each resumes the job the last child
# left killed, then starts the next one and is killed from the snapshot
# hook (``repro_torch.core.program.save_stream_checkpoint``), as the
# reference's kill tests do (tests/test_resilience.py:262-272).
DURABLE_CHILD = r"""
import os, signal, sys
import torch
sys.path.insert(0, SRC)
from repro_torch.core import ExecutionPlan
from repro_torch.graphs.dpd import default_active_schedule
from repro_torch.graphs.factories import make_dpd
import repro_torch.core.program as P

net, _ = make_dpd(N, block_l=L, seed=0, device=DEV,
                  active_schedule=default_active_schedule(N, seed=0))
accel = tuple(a for a in net.actors if a not in ("source", "sink"))
wins = net.init_state().actor("source")[0].reshape(2, N, L).permute(1, 0, 2)
feeds = {"f_in": wins.contiguous()[:, None]}
PLANS = {
    "mk_stream": ExecutionPlan(mode="megakernel", n_iterations=CHUNK,
                               accelerated=accel, specialize=False),
    "dyn_stream": ExecutionPlan(mode="dynamic", n_iterations=CHUNK,
                                accelerated=accel, trace=True),
    "mk_run": ExecutionPlan(mode="megakernel", specialize=False),
    "dyn_run": ExecutionPlan(mode="dynamic"),
}


def resume(job):
    prog = net.compile(PLANS[job])
    ck = os.path.join(D, job)
    if job.endswith("stream"):
        out = prog.resume_stream(ck, feeds, checkpoint_every=1)["f_out"]
        tr = prog.last_stream_trace
        res = {"out": out.cpu(), "counts": prog.last_stream_fire_counts,
               "sweeps": prog.last_stream_sweeps,
               "events": None if tr is None else torch.from_numpy(tr.events)}
    else:
        r = prog.resume_run(ck)
        res = {"leaves": [x.cpu() if isinstance(x, torch.Tensor) else x
                          for x in r.state.leaves()],
               "counts": r.fire_counts, "sweeps": r.sweeps}
    torch.save(res, os.path.join(D, job + ".pt"))


def kill(job, after):
    orig = P.save_stream_checkpoint
    n = [0]

    def hooked(*a, **k):
        r = orig(*a, **k)
        n[0] += 1
        if n[0] == after:
            os.kill(os.getpid(), signal.SIGKILL)
        return r

    P.save_stream_checkpoint = hooked
    prog = net.compile(PLANS[job])
    ck = os.path.join(D, job)
    if job.endswith("stream"):
        prog.stream(feeds, checkpoint_dir=ck, checkpoint_every=1)
    else:
        prog.run_checkpointed(ck, every_sweeps=EVERY)
    raise SystemExit(job + " finished without being killed")


if RESUME:
    resume(RESUME)
if KILL:
    kill(*KILL)
"""


def durable_child(dev, d: str, every: int, resume_job, kill_job) -> float:
    """One child of phase 23(b): resume ``resume_job`` (results saved under
    ``d``), then run ``kill_job`` = (job, n) and check it died by SIGKILL
    after its n-th snapshot.  Returns the child's wall in seconds."""
    import signal
    head = (f"SRC = {str(Path(__file__).resolve().parent / 'src')!r}\nD = {d!r}\n"
            f"DEV = {str(dev)!r}\n"
            f"N, L, CHUNK, EVERY = {N_FIRINGS}, {BLOCK_L}, {STREAM_CHUNK}, {every}\n"
            f"RESUME = {resume_job!r}\nKILL = {kill_job!r}\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", head + DURABLE_CHILD],
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    want = -signal.SIGKILL if kill_job else 0
    if out.returncode != want:
        fail(f"phase 23 child (resume {resume_job}, kill {kill_job}) exited "
             f"{out.returncode}, want {want}\nstdout:\n{out.stdout[-2000:]}\n"
             f"stderr:\n{out.stderr[-4000:]}")
    return wall


def same_leaves(a: list, b: list) -> bool:
    """Two states' leaves (tensors on any device, host ints) bit for bit."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
                return False
        elif x != y:
            return False
    return True


def stream_phase(dev, smi: str, zero_counts, expect_counts, net_gpu, res_gpu,
                 mk_sink: torch.Tensor, n_b1: int) -> dict:
    """Phase 23(a) and (b): DPD streamed at full width through B2 (chunked
    and persistent) and B1, then killed and resumed in child processes
    (``stream(checkpoint_dir=...)`` and ``run_checkpointed``)."""
    import shutil
    import tempfile
    from repro_torch.core import ExecutionPlan
    from repro_torch.graphs.factories import make_dpd
    from repro_torch.graphs.dpd import default_active_schedule

    L, n, chunk = BLOCK_L, N_FIRINGS, STREAM_CHUNK
    n_chunks = n // chunk
    accel = tuple(a for a in net_gpu.actors if a not in ("source", "sink"))
    wins = net_gpu.init_state().actor("source")[0].reshape(2, n, L).permute(1, 0, 2)
    wins = wins.contiguous()[:, None]                     # (64, 1, 2, L)

    def as_windows(sink_slab):
        return sink_slab.reshape(2, n, L).permute(1, 0, 2)[:, None]

    def stream(prog, zero=True, **kw):
        torch.cuda.synchronize()
        if zero:
            zero_counts()
        t0 = time.perf_counter()
        out = prog.stream({"f_in": wins}, **kw)["f_out"]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- (a) megakernel: 4 launches chunked, 1 persistent ---------------- #
    mk_plan = ExecutionPlan(mode="megakernel", n_iterations=chunk, accelerated=accel,
                            specialize=False)
    prog = net_gpu.compile(mk_plan)
    out_c, wall_c = stream(prog)
    expect_counts("phase 23 DPD stream, megakernel, chunked", {"B2": n_chunks})
    st_c = prog.stats()
    counts_c, sweeps_c = prog.last_stream_fire_counts, prog.last_stream_sweeps
    out_p, wall_p = stream(prog, persistent=True)
    expect_counts("phase 23 DPD stream, megakernel, persistent", {"B2": 1})
    st_p = prog.stats()
    if not torch.equal(out_c, out_p):
        fail("phase 23: the persistent stream differs from the chunked one")
    if not torch.equal(out_c, as_windows(mk_sink)):
        fail("phase 23: the megakernel stream differs from phase 6's Program.run")
    sweeps_p = prog.last_stream_sweeps        # one run: fewer sweeps than 4
    if prog.last_stream_fire_counts != counts_c:
        fail(f"phase 23: persistent counts {prog.last_stream_fire_counts} vs "
             f"chunked {counts_c}")
    # The CPU port's stream at the same configuration (B2's plain version).
    net_cpu, _ = make_dpd(n, block_l=L, seed=0, device="cpu",
                          active_schedule=default_active_schedule(n, seed=0))
    cpu = net_cpu.compile(mk_plan)
    cpu_out = cpu.stream({"f_in": wins.cpu()})["f_out"]
    cpu_st = cpu.stats()
    if (cpu.last_stream_fire_counts != counts_c or cpu.last_stream_sweeps != sweeps_c
            or cpu_st.last_stream_staged_bytes_per_chunk
            != st_c.last_stream_staged_bytes_per_chunk
            or cpu_st.last_stream_total_staged_bytes != st_c.last_stream_total_staged_bytes):
        fail(f"phase 23: the card's stream structure differs from the CPU port's: "
             f"counts {counts_c} vs {cpu.last_stream_fire_counts}, sweeps {sweeps_c} vs "
             f"{cpu.last_stream_sweeps}, staged {st_c.last_stream_staged_bytes_per_chunk}"
             f"/{st_c.last_stream_total_staged_bytes} vs "
             f"{cpu_st.last_stream_staged_bytes_per_chunk}/"
             f"{cpu_st.last_stream_total_staged_bytes}")
    cpu_p = cpu.stream({"f_in": wins.cpu()}, persistent=True)
    cpu_st_p = cpu.stats()
    if (cpu_st_p.last_stream_staged_bytes_per_chunk != st_p.last_stream_staged_bytes_per_chunk
            or cpu_st_p.last_stream_total_staged_bytes != st_p.last_stream_total_staged_bytes
            or cpu.last_stream_sweeps != sweeps_p):
        fail("phase 23: the persistent stream's staged bytes or sweeps differ from the "
             "CPU port's")
    cpu_err = plane_rel_err(cpu_out.numpy(), out_c.cpu().numpy())
    del cpu_p, cpu_out, net_cpu, cpu
    if cpu_err > REL_TOL:
        fail(f"phase 23: the stream differs from the CPU port's by {cpu_err:.3g} * max|y|")
    # ---- (a) dynamic mode: B1 launches, bit-identical to phase 3 --------- #
    dyn_plan = ExecutionPlan(mode="dynamic", n_iterations=chunk, accelerated=accel)
    dprog = net_gpu.compile(dyn_plan)
    out_d, wall_d = stream(dprog)
    expect_counts("phase 23 DPD stream, dynamic", {"B1": n_b1})
    if not torch.equal(out_d, as_windows(res_gpu.state.actor("sink")[0])):
        fail("phase 23: the dynamic stream differs from phase 3's run")
    # Chunked against persistent in turns, 3 each.
    walls = {"chunked": [], "persistent": []}
    for _ in range(3):
        for label, kw in (("chunked", {}), ("persistent", {"persistent": True})):
            walls[label].append(stream(prog, zero=False, **kw)[1] * 1e3)
    a_rec = {
        "card": smi, "chunks": n_chunks, "chunk_windows": chunk,
        "b2_launches": {"chunked": n_chunks, "persistent": 1}, "b1_launches_dynamic": n_b1,
        "fire_counts": counts_c, "sweeps": {"chunked": sweeps_c, "persistent": sweeps_p},
        "staged_bytes_per_chunk": {"chunked": st_c.last_stream_staged_bytes_per_chunk,
                                   "persistent": st_p.last_stream_staged_bytes_per_chunk},
        "total_staged_bytes": {"chunked": st_c.last_stream_total_staged_bytes,
                               "persistent": st_p.last_stream_total_staged_bytes},
        "walls_ms": walls, "first_walls_ms": {"chunked": wall_c * 1e3,
                                             "persistent": wall_p * 1e3,
                                             "dynamic": wall_d * 1e3},
        "cpu_port_float_err_over_max": cpu_err}
    log("phase 23 stream " + json.dumps(a_rec))
    log(f"phase 23 stream ({smi}): megakernel chunked {np.median(walls['chunked']):.2f} ms "
        f"({n_chunks} B2 launches, {st_c.last_stream_staged_bytes_per_chunk} B staged a "
        f"chunk, {st_c.last_stream_total_staged_bytes} B in all), persistent "
        f"{np.median(walls['persistent']):.2f} ms (1 launch, "
        f"{st_p.last_stream_staged_bytes_per_chunk} B a chunk, "
        f"{st_p.last_stream_total_staged_bytes} B in all); dynamic {wall_d * 1e3:.1f} ms "
        f"with {n_b1} B1 launches; all bit-identical to phases 3 and 6")

    # ---- (b) kill -> resume in child processes ---------------------------- #
    # The uninterrupted references, in this process.
    tr_prog = net_gpu.compile(dataclasses.replace(dyn_plan, trace=True))
    out_t, _ = stream(tr_prog)
    expect_counts("phase 23 DPD stream, dynamic, traced", {"B1": n_b1})
    if not torch.equal(out_t, out_d):
        fail("phase 23: the traced dynamic stream differs from the untraced one")
    every = max(1, res_gpu.sweeps // 3)
    n_segments = -(-res_gpu.sweeps // every)
    mk_run_plan = ExecutionPlan(mode="megakernel", specialize=False)
    torch.cuda.synchronize()
    zero_counts()
    mk_ref = net_gpu.compile(mk_run_plan).run()
    expect_counts("phase 23 DPD megakernel run", {"B2": 1})
    refs = {"mk_stream": {"out": out_c, "counts": counts_c, "sweeps": sweeps_c},
            "dyn_stream": {"out": out_t, "counts": tr_prog.last_stream_fire_counts,
                           "sweeps": tr_prog.last_stream_sweeps,
                           "events": tr_prog.last_stream_trace.events},
            "mk_run": {"leaves": mk_ref.state.leaves(), "counts": mk_ref.fire_counts,
                       "sweeps": mk_ref.sweeps},
            "dyn_run": {"leaves": res_gpu.state.leaves(), "counts": res_gpu.fire_counts,
                        "sweeps": res_gpu.sweeps}}
    d = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    try:
        # One segmented run here: a B2 launch per segment, bit-identical.
        torch.cuda.synchronize()
        zero_counts()
        seg = net_gpu.compile(mk_run_plan).run_checkpointed(os.path.join(d, "segments"),
                                                            every_sweeps=every)
        torch.cuda.synchronize()
        seg_launches = expect_counts("phase 23 DPD run_checkpointed, megakernel",
                                     {"B2": n_segments})["B2"]
        if (seg.sweeps != mk_ref.sweeps or seg.fire_counts != mk_ref.fire_counts
                or not same_leaves(seg.state.leaves(), mk_ref.state.leaves())):
            fail("phase 23: run_checkpointed differs from Program.run in megakernel mode")
        chain = [(None, ("mk_stream", 2)), ("mk_stream", ("dyn_stream", 2)),
                 ("dyn_stream", ("mk_run", 1)), ("mk_run", ("dyn_run", 1)),
                 ("dyn_run", None)]
        child_walls = [durable_child(dev, d, every, r, k) for r, k in chain]
        checked = {}
        for job, ref in refs.items():
            got = torch.load(os.path.join(d, job + ".pt"))
            ok = got["counts"] == ref["counts"] and got["sweeps"] == ref["sweeps"]
            if "out" in ref:
                ok = ok and torch.equal(got["out"], ref["out"].cpu())
            if "events" in ref:
                ok = ok and np.array_equal(got["events"].numpy(), ref["events"])
            if "leaves" in ref:
                ok = ok and same_leaves(got["leaves"], ref["leaves"])
            if not ok:
                fail(f"phase 23: {job} killed and resumed differs from the "
                     "uninterrupted run")
            checked[job] = "bit-identical"
    finally:
        shutil.rmtree(d, ignore_errors=True)
    b_rec = {"card": smi, "every_sweeps": every, "segments": n_segments,
             "run_checkpointed_b2_launches": seg_launches, "resumed": checked,
             "child_walls_s": child_walls,
             "killed_after": {"mk_stream": "chunk 2 of 4", "dyn_stream": "chunk 2 of 4",
                              "mk_run": "segment 1", "dyn_run": "segment 1"}}
    log("phase 23 durable " + json.dumps(b_rec))
    return {"stream": a_rec, "durable": b_rec}


# ---- 24. training on one card ---------------------------------------------- #
TRAIN_ARCH = "mamba2-780m"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 2048      # (b): 16 384 tokens a step
TRAIN_CUT = 4                                         # layers in (a) and (c)
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 512         # (a)
TRAIN_FT_BATCH, TRAIN_FT_SEQ = 4, 1024                # (c)
# (a)'s bars are the CPU tests' (tests/test_torch_train_grads.py): every
# gradient row (a leaf's slice along its first axis) within GRAD_ROW_SENS
# times the CPU model's own change of that row when its embedded input
# moves one bf16 step; ce within CE_REL of the CPU's.  The same rule holds
# the train step's own float32 gradient (read from its first AdamW moment)
# to the CPU's and the microbatched step's to the whole batch's, and
# grad_norm within GRAD_ROW_SENS times the norm of the CPU's one-step
# change, and within GRAD_NORM_REL of the norm of the step's own gradient
# (two float32 sums of 1.4e8 squares in different orders).  AdamW on the card against the CPU's on the same inputs: m and v
# within ADAMW_REL of the leaf's largest magnitude, bf16 params within one
# step (tests/test_torch_train.py's bars against the reference).  (b)'s
# loss falls by TRAIN_DROP (tests/test_train.py:44's margin); (c) within
# the reference's rtol = atol = 1e-5 (tests/test_fault_tolerance.py:82-85)
# or bit for bit.
GRAD_ROW_SENS = 8.0
CE_REL = 2.0 ** -11
GRAD_NORM_REL = 2.0 ** -16
ADAMW_REL = 1e-6
TRAIN_DROP = 0.2
TRAIN_FT_TOL = 1e-5


def as_batch(b: dict, dev) -> dict:
    """A numpy batch as int64 tensors on ``dev``."""
    return {k: torch.from_numpy(v.astype(np.int64)).to(dev) for k, v in b.items()}


def stepped_embed(model) -> None:
    """``model``'s embedded input moved one bf16 step at every element
    (:func:`bf16_step_noise`); the gradient passes as through the plain
    embedding."""
    embed = model._embed

    def noisy(*a, **kw):
        x = embed(*a, **kw)
        return x + (bf16_step_noise(x.detach()) - x).detach()
    model._embed = noisy


def loss_and_grads(cfg, params: dict, batch: dict, dev, stepped: bool = False) -> tuple:
    """``LM.train_loss`` (``kernel_impl="xla"``, remat) of ``batch`` on
    ``dev`` and every parameter's gradient (CPU tensors); ``stepped``:
    with the embedded input one bf16 step off."""
    from repro_torch.models import LM
    model = LM(cfg, device=dev, seed=None)
    model.load_state_dict(params)
    for p in model.parameters():
        p.requires_grad_(True)
    if stepped:
        stepped_embed(model)
    total, parts = model.train_loss(batch["tokens"].to(dev), batch["labels"].to(dev))
    total.backward()
    return float(parts["ce"].detach()), {n: p.grad.cpu() for n, p in model.named_parameters()}


def grad_row_readings(want: dict, got: dict, base: dict, stepped: dict) -> dict:
    """Per leaf, the largest ratio over its rows of ``got``'s error from
    ``want`` to the change from ``base`` to ``stepped`` (the CPU gradient
    under a bf16 step at the input); 0 where the error is 0."""
    out = {}
    for name, w in want.items():
        rows = w.shape[0] if w.dim() > 1 else 1
        row = lambda t: t.float().reshape(rows, -1)  # noqa: E731
        err = (row(got[name]) - row(w)).norm(dim=1)
        sens = (row(stepped[name]) - row(base[name])).norm(dim=1)
        out[name] = float(torch.where(err == 0, 0.0, err / sens).max())
    return out


def step_grads(opt, state: dict, metrics: dict) -> dict:
    """A train step's float32 gradient (CPU tensors), read from its first
    AdamW moment: from zero moments ``m = (1 - b1) g s`` with the clip
    scale ``s = min(1, clip_norm / grad_norm)``."""
    s = min(1.0, opt.clip_norm / max(float(metrics["grad_norm"]), 1e-9))
    return {k: (m / ((1 - opt.betas[0]) * s)).cpu() for k, m in state["m"].items()}


def adamw_readings(card: tuple, cpu: tuple) -> dict:
    """``adamw_update``'s (params, state) on the card against the CPU's:
    m and v's largest error over the leaf's largest magnitude, and the
    params' largest error in units of one bf16 step of the CPU's value
    (for float32 params, and at least, ADAMW_REL of the leaf's largest
    magnitude)."""
    (pg, sg), (pc, sc) = card, cpu
    mv = max(float((sg[x][k].cpu() - sc[x][k]).abs().max() / sc[x][k].abs().max()
                   .clamp(min=1e-30)) for x in ("m", "v") for k in sc["m"])
    steps = 0.0
    for k, c in pc.items():
        c = c.float()
        unit = torch.full_like(c, ADAMW_REL * float(c.abs().max().clamp(min=1e-30)))
        if pc[k].dtype == torch.bfloat16:
            unit = torch.maximum(unit, torch.ldexp(torch.ones_like(c),
                                                   torch.frexp(c)[1] - 8) * (c != 0))
        steps = max(steps, float(((pg[k].cpu().float() - c).abs() / unit).max()))
    return {"mv_rel": mv, "param_steps": steps}


def train_phase(dev, smi: str, zero_counts, expect_counts) -> dict:
    """Phase 24: mamba2-780m trained on the card (ROADMAP A13a).

    (a) At full width cut to TRAIN_CUT layers: one ``train_loss`` and
    backward of a TRAIN_PARITY_BATCH x TRAIN_PARITY_SEQ batch on the card
    and on the CPU, same weights (no kernel launches: the plain versions);
    one ``train_step`` whole and one in 2 microbatches (float32 grads),
    their gradients, ``grad_norm`` and AdamW updates held to the CPU's.
    (b) At full depth through ``Trainer``: TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens, remat, bf16 grads, a checkpoint every
    4 steps into a temporary directory; each step's loss, the median step
    time over steps 2-8, tokens/s, the peak memory; one more step profiled
    (busy share, launches, the two spans of the step).  (c) At the cut: a failure injected at step 6 and
    recovered from the step-4 checkpoint, against an uninterrupted run,
    under deterministic algorithms.  (d) (b)'s trained weights served: one
    prefill of phase 14's first LM_BATCH prompts through B6 (counted) and
    through the plain versions, the logits within phase 14's rule."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, adamw_update, global_norm, init_opt_state
    from repro_torch.train import (Trainer, TrainerConfig, TrainOptions, init_params,
                                   make_train_step)
    rec: dict = {"card": smi, "arch": TRAIN_ARCH}
    full = get_config(TRAIN_ARCH)
    cut = dataclasses.replace(full, n_layers=TRAIN_CUT)

    # ---- (a) parity at full width, cut in depth --------------------------- #
    t0 = time.perf_counter()
    params = init_params(cut, device=dev, seed=0)
    src = SyntheticLM(DataConfig(vocab=cut.vocab, seq_len=TRAIN_PARITY_SEQ,
                                 global_batch=TRAIN_PARITY_BATCH, seed=0))
    batch = as_batch(src.batch(0), "cpu")
    zero_counts()
    ce_g, g_g = loss_and_grads(cut, params, batch, dev)
    torch.cuda.synchronize()
    expect_counts("phase 24(a) train_loss and backward on the card", {})
    cpu_params = {k: v.cpu() for k, v in params.items()}
    ce_c, g_c = loss_and_grads(cut, cpu_params, batch, "cpu")
    _, g_s = loss_and_grads(cut, cpu_params, batch, "cpu", stepped=True)
    if not all(bool(torch.isfinite(g.float()).all()) for g in g_g.values()):
        fail("phase 24(a): non-finite gradients on the card")
    if not abs(ce_g - ce_c) <= CE_REL * abs(ce_c):
        fail(f"phase 24(a): ce {ce_g} on the card vs {ce_c} on the CPU (> {CE_REL} rel)")
    readings = grad_row_readings(g_c, g_g, g_c, g_s)
    worst = max(readings, key=readings.get)
    if readings[worst] > GRAD_ROW_SENS:
        fail(f"phase 24(a): gradient {worst} reads {readings[worst]:.3g} x the CPU's "
             f"one-bf16-step change (> {GRAD_ROW_SENS})")
    # The train step itself: its float32 gradient, whole and in 2
    # microbatches, its grad_norm and its AdamW update (no warmup, so the
    # first update is lr 1e-3, several bf16 steps of most weights).
    opt_a = AdamWConfig(lr=1e-3, warmup_steps=0)
    b_dev = as_batch(src.batch(0), dev)
    zero_counts()
    p1, s1, m1 = make_train_step(cut, opt_a, TrainOptions(grad_dtype="f32"))(
        params, init_opt_state(params), b_dev)
    p2, s2, m2 = make_train_step(cut, opt_a, TrainOptions(microbatches=2, grad_dtype="f32"))(
        params, init_opt_state(params), b_dev)
    torch.cuda.synchronize()
    expect_counts("phase 24(a) train steps on the card", {})
    G1, G2 = step_grads(opt_a, s1, m1), step_grads(opt_a, s2, m2)
    step_rd = grad_row_readings(g_c, G1, g_c, g_s)
    mb_rd = grad_row_readings(G1, G2, g_c, g_s)
    gn_c = float(global_norm(g_c.values()))
    gn_bar = GRAD_ROW_SENS * float(global_norm(g_s[k].float() - g_c[k].float() for k in g_c))
    gn = {"card": float(m1["grad_norm"]), "card_microbatched": float(m2["grad_norm"]),
          "cpu": gn_c, "bar": gn_bar,
          "own_rel_err": max(abs(float(m["grad_norm"]) - float(global_norm(G.values())))
                             / float(global_norm(G.values())) for m, G in ((m1, G1), (m2, G2))),
          "own_bar": GRAD_NORM_REL}
    for what, rd in (("the step's gradient", step_rd), ("the microbatched gradient", mb_rd)):
        w = max(rd, key=rd.get)
        if rd[w] > GRAD_ROW_SENS:
            fail(f"phase 24(a): {what} at {w} reads {rd[w]:.3g} x the CPU's "
                 f"one-bf16-step change (> {GRAD_ROW_SENS})")
    if not (abs(gn["card"] - gn_c) <= gn_bar and abs(gn["card_microbatched"] - gn["card"])
            <= gn_bar and gn["own_rel_err"] <= GRAD_NORM_REL):
        fail(f"phase 24(a): grad_norm {gn}")
    # AdamW on the card against the CPU's: the step's first update (from
    # the step's own gradient) and a second update from s1's moments.
    cpu_params = {k: v.cpu() for k, v in params.items()}
    first = adamw_readings((p1, s1), adamw_update(opt_a, cpu_params, G1,
                                                  init_opt_state(cpu_params))[:2])
    second_g = adamw_update(opt_a, p1, {k: g.to(dev) for k, g in G2.items()}, s1)[:2]
    s1_cpu = {"m": {k: v.cpu() for k, v in s1["m"].items()},
              "v": {k: v.cpu() for k, v in s1["v"].items()}, "count": s1["count"].cpu()}
    second = adamw_readings(second_g, adamw_update(
        opt_a, {k: v.cpu() for k, v in p1.items()}, G2, s1_cpu)[:2])
    moved = float(np.mean([float((p1[k] != params[k]).float().mean()) for k in params]))
    if first["param_steps"] > 1 or second["param_steps"] > 1 or second["mv_rel"] > ADAMW_REL:
        fail(f"phase 24(a): AdamW on the card against the CPU: first {first}, "
             f"second {second}")
    rec["a"] = {"layers": TRAIN_CUT, "batch": [TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ],
                "ce_card": ce_g, "ce_cpu": ce_c, "ce_rel_err": abs(ce_g - ce_c) / abs(ce_c),
                "ce_bar": CE_REL, "worst_leaf": worst, "worst_row_reading": readings[worst],
                "step_worst_row_reading": max(step_rd.values()),
                "microbatch_worst_row_reading": max(mb_rd.values()),
                "microbatch_worst_leaf": max(mb_rd, key=mb_rd.get),
                "row_bar": GRAD_ROW_SENS, "grad_norm": gn,
                "loss": [float(m1["loss"]), float(m2["loss"])],
                "adamw_first": first, "adamw_second": second, "adamw_mv_bar": ADAMW_REL,
                "share_of_params_moved_by_step": moved, "s": time.perf_counter() - t0}
    log("phase 24(a) " + json.dumps(rec["a"]))
    del params, cpu_params, p1, p2, s1, s2, G1, G2, second_g, b_dev, g_g, g_c, g_s
    torch.cuda.empty_cache()

    # ---- (b) full depth through the Trainer ------------------------------- #
    opt_b = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    step = make_train_step(full, opt_b, TrainOptions(grad_dtype="bf16"))
    data = SyntheticLM(DataConfig(vocab=full.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))

    def init_full():
        p = init_params(full, device=dev, seed=0)
        return {"params": p, "opt": init_opt_state(p)}

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_every=4,
                                        checkpoint_dir=d, keep=1, log_every=1),
                          step, data, init_full, log=log)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        params, opt_state = trainer.run()
        torch.cuda.synchronize()
        expect_counts("phase 24(b) training at full depth", {})
        peak = torch.cuda.max_memory_allocated()
    run_s = time.perf_counter() - t0
    hist = trainer.metrics_history
    losses = [h["loss"] for h in hist]
    dts = [h["dt"] * 1e3 for h in hist]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        fail(f"phase 24(b): losses {losses}")
    if not np.mean(losses[-2:]) <= losses[0] - TRAIN_DROP:
        fail(f"phase 24(b): the loss fell from {losses[0]} to {losses[-2:]}, "
             f"not by {TRAIN_DROP}")
    step_ms = float(np.median(dts[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # One more step under the profiler: its busy share, launches and the
    # device time of its two spans, all from that one step.
    from torch.profiler import ProfilerActivity, profile
    b8 = as_batch(data.batch(TRAIN_STEPS), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(params, opt_state, b8)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t1) * 1e3
    # The step's two spans show on the device's timeline too (from their
    # first kernel's start to their last one's end); they are not kernels.
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("train_step.")]
    if not kernels:
        fail("phase 24(b): the profiler saw no device time")
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    spans = {e.key: e.device_time_total / 1e3 for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.key.startswith("train_step.")}
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rec["b"] = {"layers": full.n_layers, "params": sum(p.numel() for p in params.values()),
                "batch": [TRAIN_BATCH, TRAIN_SEQ], "tokens_per_step": tokens,
                "losses": losses, "step_ms": dts, "median_step_ms_2_to_8": step_ms,
                "tokens_per_s": tokens / step_ms * 1e3,
                "max_memory_allocated_gb": peak / 1e9, "run_s": run_s,
                "profiled_step_wall_ms": profiled_ms, "device_ms": device_ms,
                "busy_share": device_ms / profiled_ms,
                "launches": sum(e.count for e in kernels), "kernels": len(kernels),
                "span_device_ms": spans,
                "span_share": {k: v / profiled_ms for k, v in spans.items()},
                "top": [{"kernel": e.key[:80], "count": e.count,
                         "device_ms": e.self_device_time_total / 1e3} for e in kernels[:12]]}
    log("phase 24(b) " + json.dumps(rec["b"]))
    del opt_state, b8, prof
    torch.cuda.empty_cache()

    # ---- (c) failure and restore at the cut --------------------------------- #
    step_c = make_train_step(cut, opt_b, TrainOptions(grad_dtype="bf16"))
    data_c = SyntheticLM(DataConfig(vocab=cut.vocab, seq_len=TRAIN_FT_SEQ,
                                    global_batch=TRAIN_FT_BATCH, seed=0))

    def init_cut():
        p = init_params(cut, device=dev, seed=0)
        return {"params": p, "opt": init_opt_state(p)}

    fired: list = []

    def boom(s):
        if s == 6 and not fired:
            fired.append(s)
            raise RuntimeError("injected device failure")

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for hook in (boom, None):
            with tempfile.TemporaryDirectory() as d:
                t = Trainer(TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_every=4,
                                          checkpoint_dir=d, log_every=TRAIN_STEPS),
                            step_c, data_c, init_cut, failure_hook=hook, log=lambda s: None)
                runs.append((t.run()[0], t.restarts))
    finally:
        torch.use_deterministic_algorithms(False)
    (pa, ra), (pb, rb) = runs
    if (ra, rb) != (1, 0):
        fail(f"phase 24(c): restarts {ra} and {rb}, want 1 and 0")
    bits = all(torch.equal(pa[k], pb[k]) for k in pa)
    ft_diff = max(float((pa[k].float() - pb[k].float()).abs().max()) for k in pa)
    close = all(torch.allclose(pa[k].float(), pb[k].float(), rtol=TRAIN_FT_TOL,
                               atol=TRAIN_FT_TOL) for k in pa)
    if not (bits or close):
        fail(f"phase 24(c): the recovered run's params differ by {ft_diff}")
    rec["c"] = {"layers": TRAIN_CUT, "batch": [TRAIN_FT_BATCH, TRAIN_FT_SEQ],
                "failure_at_step": 6, "restarts": ra, "deterministic_algorithms": True,
                "bit_identical": bits, "max_abs_diff": ft_diff, "tol": TRAIN_FT_TOL,
                "s": time.perf_counter() - t0}
    log("phase 24(c) " + json.dumps(rec["c"]))
    del runs, pa, pb
    torch.cuda.empty_cache()

    # ---- (d) the trained weights serve through B6 ----------------------------- #
    model = LM(full, device=dev, seed=None)
    model.load_state_dict(params)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(LM_PROMPT_MIN, LM_PROMPT + 1, LM_REQUESTS)]
    prompts = [rng.integers(0, full.vocab, n) for n in lens][:LM_BATCH]
    toks = torch.from_numpy(left_pad(prompts, LM_PROMPT)).to(dev)
    V = full.vocab
    zero_counts()
    lg_k = model.prefill(toks)[0][:, :V].float()
    torch.cuda.synchronize()
    b6 = expect_counts("phase 24(d) the trained weights served", {"B6": full.n_layers})["B6"]
    lg_x = model.prefill(toks, kernel_impl="xla")[0][:, :V].float()
    stepped_embed(model)
    lg_s = model.prefill(toks, kernel_impl="xla")[0][:, :V].float()
    del model
    torch.cuda.empty_cache()
    sens = (lg_s - lg_x).abs().amax(-1)
    err = (lg_k - lg_x).abs().amax(-1)
    bar = torch.clamp(LOGIT_SENS * sens, min=LOGIT_TOL)
    mag = lg_x.abs().amax(-1)
    if not (bool(torch.isfinite(lg_k).all()) and bool(torch.isfinite(sens).all())):
        fail("phase 24(d): non-finite logits")
    if bool((err > bar).any()):
        fail(f"phase 24(d): B6's logits differ from the plain versions' by "
             f"{err.tolist()} > {bar.tolist()}")
    rec["d"] = {"prompts": lens[:LM_BATCH], "padded_to": LM_PROMPT, "b6_launches": b6,
                "logit_err": err.tolist(), "sensitivity": sens.tolist(),
                "bar": bar.tolist(), "max_abs_logit": mag.tolist(),
                "rows_with_power": int((bar < mag).sum()),
                "top1_equal": bool(torch.equal(lg_k.argmax(-1), lg_x.argmax(-1)))}
    log("phase 24(d) " + json.dumps(rec["d"]))
    return rec


# ---- 25. the multi-device runtime (devices=k, pipeline_forward) -------- #
SHARD_RUNS = 5             # timed runs after a warm-up, each k
SHARD_TIMEOUT = 600        # a group's deadline and its collectives' timeout (s)
SHARD_TURNS = 2            # (b): single-device and sharded generate, in turns


def leaf_digests(leaves: list) -> list:
    """sha256 of each leaf's dtype, shape and bytes: equal digests, equal
    bits."""
    import hashlib
    return [hashlib.sha256(f"{a.dtype}{a.shape}".encode() + np.ascontiguousarray(a)
                           .tobytes()).hexdigest() for a in leaves]


def tensor_digest(t: torch.Tensor) -> str:
    return leaf_digests([t.detach().cpu().contiguous().view(torch.uint8).numpy()])[0]


def dpd_runs(prog, snapshot, barrier=None, after=None) -> tuple:
    """A warm-up and SHARD_RUNS timed runs of ``prog`` from fresh states,
    each started together on every rank (``barrier``): (the warm-up's
    result, ``snapshot()`` of the kernel counts just after it, the walls in
    ms, ``after()`` after each timed run).  The caller zeroes the counts
    first."""
    walls, extra, first, launches = [], [], None, None
    for i in range(1 + SHARD_RUNS):
        st = prog.init_state()
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        res = prog.run(st, in_place=True)
        torch.cuda.synchronize()
        if i == 0:
            first, launches = res, snapshot()
        else:
            walls.append((time.perf_counter() - t0) * 1e3)
            if after is not None:
                extra.append(after())
    return first, launches, walls, extra


def shard_rank(rank: int, world: int, src: str) -> dict:
    """One rank of a phase-25 group (``spawn_group``): DPD at full width at
    ``devices=world``; at 2 ranks also ``device_assign``, guards and trace,
    and recurrentgemma-2b through the sharded ActorEngine; at 4 ranks
    mamba2-780m through ``pipeline_forward``.  Every kernel count is zeroed
    just before each path and read just after."""
    sys.path.insert(0, src)
    import torch.distributed as dist
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import ExecutionPlan
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd
    from repro_torch.kernels.dyn_fir import dpd_branch_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru import rglru_cuda
    from repro_torch.kernels.ssd import ssd_cuda
    wrappers = {"B1": dpd_branch_cuda, "B5": flash_attention_cuda, "B6": ssd_cuda,
                "B7": rglru_cuda}

    def zero() -> None:
        for w in wrappers.values():
            w.launches = 0

    def counts() -> dict:
        return {k: w.launches for k, w in wrappers.items()}

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"rank": rank, "device": str(dev)}
    sched = default_active_schedule(N_FIRINGS, seed=0)
    net, _ = make_dpd(N_FIRINGS, block_l=BLOCK_L, seed=0, active_schedule=sched, device=dev)
    prog = net.compile(mode="dynamic", devices=world)
    zero()
    # The runner's host seconds by part after each timed run (visit,
    # exchange, flag, merge; core/shard.py).
    res, launches, walls, splits = dpd_runs(prog, counts, dist.barrier,
                                            lambda: dict(prog._runner.last_split))
    out["dpd"] = {"launches": launches, "digests": leaf_digests(state_to_numpy(res.state)),
                  "counts": res.fire_counts, "rounds": res.sweeps, "walls_ms": walls,
                  "split_ms": {k: float(np.median([x[k] for x in splits])) * 1e3
                               for k in splits[0]},
                  "stats": prog.stats().to_json()}
    if world == 2:
        names = list(net.actors)
        cut = {n: (0 if i < len(names) // 2 else 1) for i, n in enumerate(names)}
        for label, plan in (("assign", ExecutionPlan(mode="dynamic", devices=2,
                                                     device_assign=cut)),
                            ("guards_trace", ExecutionPlan(mode="dynamic", devices=2,
                                                           guards=True, trace=True,
                                                           trace_capacity=1 << 16))):
            p = net.compile(plan)
            zero()
            r = p.run()
            torch.cuda.synchronize()
            rec = {"launches": counts(), "digests": leaf_digests(state_to_numpy(r.state)),
                   "counts": r.fire_counts, "rounds": r.sweeps,
                   "parts": p.stats().device_partition_actors}
            if r.trace is not None:
                rec.update(diag_ok=r.diagnostics.ok, fired=r.trace.firing_counts(),
                           dropped=r.trace.dropped)
            out[label] = rec
            if label == "assign":
                out[label]["cut"] = cut
    del net, prog, res
    torch.cuda.empty_cache()
    if world == 2:
        out["serve"] = shard_serve(rank, dev, zero, counts)
    if world == 4:
        out["pipeline"] = shard_pipeline(rank, dev, zero, counts)
    return out


def shard_serve(rank: int, dev, zero, counts) -> dict:
    """Phase 25(b) in one rank: phase 22's closed loop (LM_REQUESTS
    requests, budget LM_NEW) through the ActorEngine at devices=2, and on
    rank 0 through the single-device ActorEngine, in turns."""
    import torch.distributed as dist
    from repro_torch.core import ExecutionPlan
    from repro_torch.serve import ActorEngine, Request, ServeConfig
    model, init_s = lm_model("recurrentgemma-2b", dev)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(LM_PROMPT_MIN, LM_PROMPT + 1, LM_REQUESTS)]
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), LM_NEW) for n in lens]
    scfg = ServeConfig(batch_size=LM_BATCH, max_prompt=LM_PROMPT, max_new=LM_NEW)
    single = ActorEngine(cfg, model, scfg)
    sharded = ActorEngine(cfg, model, scfg, plan=ExecutionPlan(mode="dynamic", devices=2))
    rec: dict = {"init_s": init_s, "walls_s": {"single": [], "sharded": []}}

    def timed(eng) -> tuple:
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        toks = served_tokens(eng.generate(reqs))
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0, counts()

    for _ in range(SHARD_TURNS):
        dist.barrier()
        if rank == 0:
            toks, wall, launches = timed(single)
            rec["walls_s"]["single"].append(wall)
            rec["single"] = {"tokens": toks, "launches": launches,
                             "counts": single.last_fire_counts,
                             "sweeps": single.last_sweeps}
        dist.barrier()
        toks, wall, launches = timed(sharded)
        rec["walls_s"]["sharded"].append(wall)
        rec["sharded"] = {"tokens": toks, "launches": launches,
                          "counts": sharded.last_fire_counts, "rounds": sharded.last_sweeps,
                          "collective_bytes_per_sweep": sharded.last_collective_bytes_per_sweep,
                          "parts": sharded.last_program.stats().device_partition_actors}
    return rec


def shard_pipeline(rank: int, dev, zero, counts) -> dict:
    """Phase 25(c) in one rank: mamba2-780m's logits through
    ``pipeline_forward`` (stage ``rank`` of 4 on this rank) on phase
    23(c)'s traffic, in turns with ``pipeline_forward_reference`` in one
    process (rank 0, the others waiting), SHARD_TURNS each."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.graphs.lm_pipeline import pipeline_forward, pipeline_forward_reference
    mesh = init_device_mesh("cpu", (LM_STAGES,), mesh_dim_names=("stage",))
    model, init_s = lm_model("mamba2-780m", dev)
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_MICRO, LM_PROMPT)))
    walls, ref_walls, out = [], [], {}
    for i in range(SHARD_TURNS):
        torch.cuda.synchronize()
        dist.barrier()
        if rank == 0:
            zero()
            t0 = time.perf_counter()
            ref = pipeline_forward_reference(model, cfg, tokens, LM_STAGES)
            torch.cuda.synchronize()
            ref_walls.append(time.perf_counter() - t0)
            out.update(reference_launches=counts(), reference_digest=tensor_digest(ref))
            del ref
        torch.cuda.synchronize()
        dist.barrier()
        zero()
        t0 = time.perf_counter()
        logits = pipeline_forward(model, cfg, tokens, mesh, n_stages=LM_STAGES)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            out["launches"] = counts()
    return {**out, "init_s": init_s, "n_ssd": sum(k == "ssd" for k in model.kinds),
            "walls_s": walls, "reference_walls_s": ref_walls,
            "finite": bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
            "shape": list(logits.shape), "digest": tensor_digest(logits)}


def shard_phase(dev, smi: str, zero_counts, expect_counts) -> dict:
    """Phase 25: the multi-device runtime, each sub-phase in k ranks
    spawned on the one card (a gloo group through a ``file://``
    rendezvous, a deadline, every rank's failure the script's):

    (a) DPD at full width (phase 3's network) at devices 1 (this process),
        2 and 4: every rank's state bit-identical to the single-process
        run, fire counts equal, B1's launches summed over the ranks equal
        its 398; rounds, collective bytes, the wall (median of
        SHARD_RUNS after a warm-up) and each rank's B1 launches; at 2 ranks
        ``device_assign`` (half and half) and guards plus trace (clean,
        merged trace counts equal the fire counts);
    (b) recurrentgemma-2b through the ActorEngine at devices=2 on phase
        22's closed loop: tokens bit-identical to the single-device
        ActorEngine's on rank 0, walls in turns;
    (c) mamba2-780m through ``pipeline_forward``, 4 stages of 12 layers, 4
        microbatches of LM_PROMPT tokens: every rank's logits bit-identical
        to ``pipeline_forward_reference`` run in one process (rank 0, in
        turns), 48 B6 calls a rank."""
    import tempfile
    from repro_torch.convert import state_to_numpy
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd
    from repro_torch.launch.group import spawn_group
    t_phase = time.perf_counter()
    src = str(Path(__file__).resolve().parent / "src")
    sched = default_active_schedule(N_FIRINGS, seed=0)
    expected = int(sched.sum())
    net, _ = make_dpd(N_FIRINGS, block_l=BLOCK_L, seed=0, active_schedule=sched, device=dev)
    prog = net.compile(mode="dynamic")
    zero_counts()
    res1, _, walls1, _ = dpd_runs(prog, lambda: expect_counts("phase 25(a) DPD devices=1",
                                                              {"B1": expected}))
    one = {"digests": leaf_digests(state_to_numpy(res1.state)), "counts": res1.fire_counts,
           "rounds": res1.sweeps}
    del net, prog, res1
    torch.cuda.empty_cache()
    groups = {}
    with tempfile.TemporaryDirectory(prefix="phase25_") as tmp:
        for k in (2, 4):
            t0 = time.perf_counter()
            try:
                groups[k] = spawn_group("chip_smoke:shard_rank", k, tmp, args=(src,),
                                        timeout=SHARD_TIMEOUT)
            except RuntimeError as err:
                fail(f"phase 25: the group of {k} ranks failed: {err}")
            log(f"phase 25: group of {k} ranks done in {time.perf_counter() - t0:.1f} s")
    rec: dict = {"card": smi, "dpd": {1: {"rounds": one["rounds"], "walls_ms": walls1,
                                          "wall_ms": float(np.median(walls1)),
                                          "b1_launches": [expected]}}}
    for k, ranks in groups.items():
        d = [r["dpd"] for r in ranks]
        b1 = [r["launches"]["B1"] for r in d]
        for r, x in enumerate(d):
            if x["digests"] != one["digests"]:
                bad = [i for i, (a, b) in enumerate(zip(x["digests"], one["digests"]))
                       if a != b]
                fail(f"phase 25(a) devices={k} rank {r}: state leaves {bad} differ from "
                     "the single-process run")
            if x["counts"] != one["counts"]:
                fail(f"phase 25(a) devices={k} rank {r}: fire counts {x['counts']} vs "
                     f"{one['counts']}")
            if any(v for key, v in x["launches"].items() if key != "B1"):
                fail(f"phase 25(a) devices={k} rank {r}: launches {x['launches']}")
        if sum(b1) != expected:
            fail(f"phase 25(a) devices={k}: B1 launches {b1} sum to {sum(b1)}, not {expected}")
        st = d[0]["stats"]
        rec["dpd"][k] = {"rounds": d[0]["rounds"],
                         "collective_bytes_per_sweep": st["collective_bytes_per_sweep"],
                         "device_partition_actors": st["device_partition_actors"],
                         "walls_ms": [x["walls_ms"] for x in d],
                         "wall_ms": float(np.median(d[0]["walls_ms"])),
                         "split_ms": [x["split_ms"] for x in d],
                         "b1_launches": b1}
        log(f"phase 25(a) DPD devices={k} ({smi}): rounds {d[0]['rounds']}, "
            f"collective_bytes_per_sweep {st['collective_bytes_per_sweep']}, wall "
            f"{rec['dpd'][k]['wall_ms']:.2f} ms (median of {SHARD_RUNS}; devices=1 "
            f"{rec['dpd'][1]['wall_ms']:.2f} ms), B1 launches per rank {b1}; every rank "
            "bit-identical to the single-process run; host ms by part per rank (median) "
            + json.dumps(rec["dpd"][k]["split_ms"]))
    a = groups[2]
    for label in ("assign", "guards_trace"):
        for r, x in enumerate(a):
            x = x[label]
            if x["digests"] != one["digests"] or x["counts"] != one["counts"]:
                fail(f"phase 25(a) {label} rank {r}: differs from the single-process run")
            if label == "guards_trace" and not (x["diag_ok"] and x["dropped"] == 0
                                                and x["fired"] == one["counts"]):
                fail(f"phase 25(a) guards and trace rank {r}: ok {x['diag_ok']}, dropped "
                     f"{x['dropped']}, trace counts {x['fired']}")
            if label == "assign" and set(x["parts"][0]) != {
                    n for n, dv in x["cut"].items() if dv == 0}:
                fail(f"phase 25(a) device_assign rank {r}: partition {x['parts']}")
        rec[label] = {"rounds": a[0][label]["rounds"],
                      "b1_launches": [x[label]["launches"]["B1"] for x in a]}
    log(f"phase 25(a) device_assign and guards+trace at devices=2: bit-identical, "
        f"clean, trace counts equal the fire counts ({json.dumps(rec['assign'])}, "
        f"{json.dumps(rec['guards_trace'])})")

    s = [x["serve"] for x in a]
    single, sharded = s[0]["single"], [x["sharded"] for x in s]
    for r, x in enumerate(sharded):
        if x["tokens"] != single["tokens"]:
            bad = [i for i, (p, q) in enumerate(zip(x["tokens"], single["tokens"])) if p != q]
            fail(f"phase 25(b) rank {r}: tokens of requests {bad} differ from the "
                 "single-device ActorEngine's")
        c = x["counts"]
        if not c["decode"] == c["admission"] == c["merge"]:
            fail(f"phase 25(b) rank {r}: fire counts {c}")
    launches_b = [x["launches"] for x in sharded]
    for key in ("B5", "B7"):
        if sum(x[key] for x in launches_b) != single["launches"][key]:
            fail(f"phase 25(b): {key} launches {[x[key] for x in launches_b]} vs the "
                 f"single-device run's {single['launches'][key]}")
    rec["serve"] = {
        "arch": "recurrentgemma-2b", "requests": LM_REQUESTS, "max_new": LM_NEW,
        "init_s": [x["init_s"] for x in s],
        "collective_bytes_per_sweep": sharded[0]["collective_bytes_per_sweep"],
        "rounds": sharded[0]["rounds"], "single_sweeps": single["sweeps"],
        "device_partition_actors": sharded[0]["parts"],
        "walls_s": s[0]["walls_s"], "launches": launches_b,
        "single_launches": single["launches"]}
    log(f"phase 25(b) recurrentgemma-2b ActorEngine devices=2 ({smi}): tokens bit-identical "
        f"to the single-device run; collective_bytes_per_sweep "
        f"{rec['serve']['collective_bytes_per_sweep']}, rounds {rec['serve']['rounds']} "
        f"(single-device sweeps {single['sweeps']}); walls in turns single "
        f"{s[0]['walls_s']['single']} s, sharded {s[0]['walls_s']['sharded']} s; "
        f"launches per rank {launches_b}")

    p = [x["pipeline"] for x in groups[4]]
    for r, x in enumerate(p):
        if x["digest"] != p[0]["reference_digest"] or not x["finite"]:
            fail(f"phase 25(c) rank {r}: logits differ from pipeline_forward_reference's "
                 f"in one process (or are not finite: {x['finite']})")
    b6 = [x["launches"]["B6"] for x in p]
    n_ssd = p[0]["n_ssd"]
    per_rank = n_ssd // LM_STAGES * LM_MICRO
    if b6 != [per_rank] * LM_STAGES or p[0]["reference_launches"]["B6"] != n_ssd * LM_MICRO \
            or any(v for x in p for key, v in x["launches"].items() if key != "B6"):
        fail(f"phase 25(c): launches per rank {[x['launches'] for x in p]}, want B6 "
             f"{per_rank} each (reference {p[0]['reference_launches']})")
    rec["pipeline"] = {"arch": "mamba2-780m", "stages": LM_STAGES, "microbatches": LM_MICRO,
                       "tokens": LM_PROMPT, "b6_launches": b6,
                       "reference_b6_launches": p[0]["reference_launches"]["B6"],
                       "walls_s": [x["walls_s"] for x in p],
                       "reference_walls_s": p[0]["reference_walls_s"],
                       "init_s": [x["init_s"] for x in p], "shape": p[0]["shape"]}
    log(f"phase 25(c) mamba2-780m pipeline_forward, {LM_STAGES} ranks ({smi}): logits "
        f"bit-identical to pipeline_forward_reference in one process, on every rank; B6 "
        f"calls per rank {b6}; in turns, pipeline_forward {p[0]['walls_s']} s, the "
        f"reference alone on the card {p[0]['reference_walls_s']} s")
    rec["phase_s"] = time.perf_counter() - t_phase
    log("phase 25 shard " + json.dumps(rec))
    return rec


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def b2_turn(src: str) -> None:
    """``--b2 SRC``: B2's time per run (:func:`b2_timed`) from the
    ``repro_torch`` package under ``SRC``, on DPD's main path and on motion
    detection's where that tree has it, from the main build and, where that
    tree has health builds, from the ``MK_GUARDS`` build.  Run in turns from
    two trees (parent, change, change, parent; a parent unpacked with ``git
    archive`` into a gitignored directory) it compares B2 across commits on
    one card."""
    from repro_torch.core.megakernel import kernel as mk_kernel
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd
    from repro_torch.kernels import _build
    smi = card()
    guards = hasattr(mk_kernel, "build_defines")
    _build.build("megakernel")
    if guards:
        _build.build("megakernel", defines=mk_kernel.build_defines(guards=True))
    dev = torch.device("cuda", 0)
    nets = {"dpd": make_dpd(N_FIRINGS, block_l=BLOCK_L, seed=0, device=dev,
                            active_schedule=default_active_schedule(N_FIRINGS, seed=0))[0]}
    if (Path(src) / "repro_torch" / "graphs" / "motion_detection.py").exists():
        from repro_torch.graphs.motion_detection import bench_workload
        nets["md"] = bench_workload(MD_FRAMES, rate=MD_RATE, frame_hw=MD_HW, seed=0,
                                    device=dev)
    rec = {"src": src, "card": smi}
    for label, net in nets.items():
        rec[f"{label}_ms"] = b2_timed(net, dev)[0]
        if guards:
            rec[f"{label}_guards_ms"] = b2_timed(net, dev, guards=True)[0]
    print("b2 " + json.dumps(rec), flush=True)


def b2_split_turn(src: str) -> None:
    """``--b2-split SRC``: :func:`b2_split` on DPD's main path and on motion
    detection from the ``repro_torch`` package under ``SRC`` (a tree whose
    wrapper takes ``clock_split``); one ``b2_split {...}`` line."""
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd
    from repro_torch.graphs.motion_detection import bench_workload
    from repro_torch.kernels import _build
    from repro_torch.core.megakernel.kernel import CLOCK_SPLIT_DEFINE
    smi = card()
    _build.build("megakernel", defines=(CLOCK_SPLIT_DEFINE,))
    dev = torch.device("cuda", 0)
    net, _ = make_dpd(N_FIRINGS, block_l=BLOCK_L, seed=0, device=dev,
                      active_schedule=default_active_schedule(N_FIRINGS, seed=0))
    md = bench_workload(MD_FRAMES, rate=MD_RATE, frame_hw=MD_HW, seed=0, device=dev)
    print("b2_split " + json.dumps({"src": src, "card": smi, "dpd": b2_split(net, dev),
                                    "md": b2_split(md, dev)}), flush=True)


def b5_inputs(dev, gen) -> tuple:
    """B5's operands at recurrentgemma-2b's local attention in phase 12 (q
    (LM_BATCH, LM_PROMPT, 10, 256), k/v (LM_BATCH, LM_PROMPT, 1, 256) bf16)
    and its window."""
    from repro_torch.configs import get_config
    rc = get_config("recurrentgemma-2b")
    q, k, v = (torch.randn((LM_BATCH, LM_PROMPT, n, rc.hd), generator=gen,
                           device=dev).to(torch.bfloat16)
               for n in (rc.n_heads, rc.n_kv_heads, rc.n_kv_heads))
    return q, k, v, rc.swa_window


def b5_turn(src: str) -> None:
    """``--b5 SRC``: B5's time per call at phase 12's shape (CUDA graph
    replays, as phase 12 times it) from the ``repro_torch`` package under
    ``SRC``, with its reading against that tree's plain version (beyond one
    bf16 step, in row-RMS units, as phase 12 reads it).  Run in turns from two trees it compares B5 across
    commits on one card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    smi = card()
    _build.build("flash_attention")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v, win = b5_inputs(dev, gen)
    got = flash_attention(q, k, v, causal=True, window=win)
    want = flash_attention_ref(q, k, v, causal=True, window=win)
    excess = float(row_excess(got, want).max())
    del got, want
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True, window=win), inner=10)
    print("b5 " + json.dumps({"src": src, "card": smi, "ms": ms, "row_rms_excess": excess}),
          flush=True)


def b6_turn(src: str) -> None:
    """``--b6 SRC``: B6's time per call at mamba2-780m's prefill shape (bf16,
    CUDA graph replays, as phase 12 times it) from the ``repro_torch``
    package under ``SRC``, with its reading against that tree's plain
    version.  Run in turns from two trees it compares B6 across commits on
    one card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ssd, ssd_ref
    smi = card()
    _build.build("ssd")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    c = get_config("mamba2-780m").ssm.chunk
    x, dt, A, Bm, Cm = b6_inputs(dev, gen, torch.bfloat16)
    y, hT = ssd(x, dt, A, Bm, Cm, chunk=c)
    yr, hr = ssd_ref(x, dt, A, Bm, Cm, c)
    ry, rh = b6_reading(y, hT, yr, hr)
    del y, hT, yr, hr
    ms = graph_ms(lambda: ssd(x, dt, A, Bm, Cm, chunk=c), inner=10)
    print("b6 " + json.dumps({"src": src, "card": smi, "ms": ms, "y_over_bar": ry,
                              "hT_over_bar": rh}), flush=True)


def b7_turn(src: str) -> None:
    """``--b7 SRC``: B7's time per call at phase 12's shape (CUDA graph
    replays, as phase 12 times it) and at its first batch alone, from the
    ``repro_torch`` package under ``SRC``, held bit for bit against that
    tree's plain version; beside it, ``torch.add`` over the same bytes.
    Run in turns from two trees it compares B7 across commits on one
    card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import rglru
    smi = card()
    _build.build("rglru")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    la, gx = b7_inputs(dev, gen)
    err = b7_reading(la, gx)
    ms = graph_ms(lambda: rglru(la, gx), inner=10)
    # The same bytes streamed by one of PyTorch's elementwise kernels (two
    # planes read, one written): what this traffic reaches on the card.
    out = torch.empty_like(gx)
    stream_ms = graph_ms(lambda: torch.add(la, gx, out=out), inner=10)
    # One prompt's prefill: a quarter of the blocks and of the bytes.
    la1, gx1 = la[:1], gx[:1]
    err = max(err, b7_reading(la1, gx1))
    ms_b1 = graph_ms(lambda: rglru(la1, gx1), inner=10)
    print("b7 " + json.dumps({"src": src, "card": smi, "ms": ms, "max_abs_err": err,
                              "stream_ms": stream_ms, "ms_batch1": ms_b1}), flush=True)


def host_wall_ms(prog) -> float:
    """Median warm wall of 7 runs of ``prog`` after one warm-up run."""
    prog.run(prog.init_state(), in_place=True)
    return float(np.median(warm_wall_ms(prog, runs=7)))


def b1_turn(src: str) -> None:
    """``--b1 SRC``: phase 2 (:func:`b1_phase`: B1 bit for bit against the
    plain version, its graph-replay time, the wrapper's time per call, the
    ``copy_`` yardstick and the launch floor) from the ``repro_torch``
    package under ``SRC``, and the median warm wall of DPD's main path in
    dynamic mode (398 B1 launches a run).  Run in turns from two trees it
    compares B1 across commits on one card."""
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd
    from repro_torch.kernels import _build
    smi = card()
    _build.build("dyn_fir")
    dev = torch.device("cuda", 0)
    rec = b1_phase(dev, smi)
    net, _ = make_dpd(N_FIRINGS, block_l=BLOCK_L, seed=0, device=dev,
                      active_schedule=default_active_schedule(N_FIRINGS, seed=0))
    rec["dpd_dynamic_wall_ms"] = host_wall_ms(net.compile(mode="dynamic"))
    print("b1 " + json.dumps({"src": src, "card": smi, **rec}), flush=True)


def b3_turn(src: str) -> None:
    """``--b3 SRC``: B3 on phase 7's u8 frames (4, 240, 320) from the
    ``repro_torch`` package under ``SRC``, bit for bit against that tree's
    plain version: its graph-replay time, the wrapper's time per call, the
    ``copy_`` yardstick and the launch floor, and the median warm wall of
    motion detection in dynamic mode (240 B3 launches a run).  Run in turns
    from two trees it compares B3 across commits on one card."""
    from repro_torch.graphs.motion_detection import bench_workload
    from repro_torch.kernels import _build
    from repro_torch.kernels import gauss5x5 as b3
    # The Gauss actor's body: gauss5x5_u8, or gauss5x5 in a tree older than
    # the entry's rename, where it took u8 frames to u8.
    blur = getattr(b3, "gauss5x5_u8", b3.gauss5x5)
    smi = card()
    _build.build("gauss5x5")
    dev = torch.device("cuda", 0)
    shape = (MD_RATE,) + MD_HW
    x = torch.tensor(np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8),
                     device=dev)
    if not torch.equal(blur(x), b3.gauss5x5_u8_ref(x)):
        fail("B3 u8 differs from the plain version")
    copy_ms, floor_ms = yardsticks(shape, torch.uint8, dev)
    rec = {"src": src, "card": smi, "ms": graph_ms(lambda: blur(x), copies=10),
           "wrapper_ms": cuda_ms(lambda: blur(x)), "copy_ms": copy_ms,
           "floor_ms": floor_ms}
    net = bench_workload(MD_FRAMES, rate=MD_RATE, frame_hw=MD_HW, seed=0, device=dev)
    rec["md_dynamic_wall_ms"] = host_wall_ms(net.compile(mode="dynamic"))
    print("b3 " + json.dumps(rec), flush=True)


B4_PROBE_ROWS = (1, 2, 4, 8)   # rows a thread, each a build of motion_post.cu


def b4_turn(src: str) -> None:
    """``--b4 SRC``: B4 on phase 7's float frames (4, 240, 320) from the
    ``repro_torch`` package under ``SRC``, bit for bit against that tree's
    plain version: its graph-replay time and the wrapper's time per call,
    beside the ``torch.add`` yardstick over the same bytes and the launch
    floor.  Where that tree's B4 takes u8 frames (its source reads
    ``MOTION_POST_ROWS``), also on phase 7's u8 frames, and the R probe:
    the kernel built with ``-DMOTION_POST_ROWS=R`` for each R in
    ``B4_PROBE_ROWS``, launched through that library's C entry, checked bit
    for bit and timed.  Run in turns from two trees it compares B4 across
    commits on one card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.motion_post import kernel as b4
    from repro_torch.kernels.motion_post import motion_post, motion_post_ref
    smi = card()
    probe = "MOTION_POST_ROWS" in (_build.CSRC / "motion_post.cu").read_text()
    defines = [(f"-DMOTION_POST_ROWS={r}",) for r in B4_PROBE_ROWS] if probe else []
    builds = [threading.Thread(target=_build.build, args=("motion_post",),
                               kwargs={"defines": d}) for d in defines]
    for t in builds:
        t.start()
    _build.build("motion_post")
    for t in builds:
        t.join()
    dev = torch.device("cuda", 0)
    x_u8, x_f, prev_f, prev_u8 = md_kernel_frames(dev)
    if not torch.equal(motion_post(x_f, prev_f), motion_post_ref(x_f, prev_f)):
        fail("B4 differs from the plain version")
    one = torch.zeros(1, device=dev)
    rec = {"src": src, "card": smi,
           "ms": graph_ms(lambda: motion_post(x_f, prev_f), copies=10),
           "wrapper_ms": cuda_ms(lambda: motion_post(x_f, prev_f)),
           "add_ms": add_ms(x_f, prev_f),
           "floor_ms": graph_ms(lambda: one.zero_(), copies=10)}
    if probe:
        pairs = {"float": (x_f, prev_f), "u8": (x_u8, prev_u8)}
        rec["u8_ms"] = graph_ms(lambda: motion_post(x_u8, prev_u8), copies=10)
        rec["u8_wrapper_ms"] = cuda_ms(lambda: motion_post(x_u8, prev_u8))
        rec["u8_add_ms"] = add_ms(x_u8, prev_u8)
        rec["rows_ms"] = {}
        for rows, d in zip(B4_PROBE_ROWS, defines):
            lib = b4._library(d)

            def launch(c, p, lib=lib):
                out = torch.empty_like(c, dtype=torch.float32)
                err = lib.motion_post_run(
                    c.data_ptr(), p.data_ptr(), out.data_ptr(), c.shape[0], c.shape[1],
                    c.shape[2], c.dtype == torch.uint8, 40.0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    fail(f"B4 at rows {rows}: CUDA error {err}")
                return out
            for kind, (c, p) in pairs.items():
                if not torch.equal(launch(c, p), motion_post_ref(c.float(), p.float())):
                    fail(f"B4 {kind} at rows {rows} differs from the plain version")
            rec["rows_ms"][rows] = {
                kind: graph_ms(lambda c=c, p=p: launch(c, p), copies=10)
                for kind, (c, p) in pairs.items()}
    print("b4 " + json.dumps(rec), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this script "
                         "runs only on the card")
    turns = {"--b2": b2_turn, "--b2-split": b2_split_turn, "--b5": b5_turn,
             "--b6": b6_turn, "--b7": b7_turn, "--b1": b1_turn, "--b3": b3_turn,
             "--b4": b4_turn}
    if sys.argv[1:2] and sys.argv[1] in turns and len(sys.argv) == 3:
        sys.path.insert(0, sys.argv[2])
        turns[sys.argv[1]](sys.argv[2])
        return
    lm_only = sys.argv[1:] == ["--lm"]
    train_only = sys.argv[1:] == ["--train"]
    shard_only = sys.argv[1:] == ["--shard"]
    if len(sys.argv) > 1 and not (lm_only or train_only or shard_only):
        raise SystemExit(__doc__)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import RuntimeMode
    from repro_torch.core.megakernel import kernel as mk_kernel
    from repro_torch.core.megakernel import megakernel_cuda
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd, states_equal
    from repro_torch.kernels import _build
    from repro_torch.kernels.dyn_fir import N_TAPS, dpd_branch_cuda
    from repro_torch.kernels.gauss5x5 import gauss5x5_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.motion_post import motion_post_cuda
    from repro_torch.kernels.rglru import rglru_cuda
    from repro_torch.kernels.ssd import ssd_cuda

    wrappers = {"B1": dpd_branch_cuda, "B2": megakernel_cuda,
                "B3": gauss5x5_cuda, "B4": motion_post_cuda,
                "B5": flash_attention_cuda, "B6": ssd_cuda, "B7": rglru_cuda}

    def zero_counts() -> None:
        for w in wrappers.values():
            w.launches = 0
        flash_attention_cuda.route_launches = {"wgmma": 0, "ffma": 0}
        ssd_cuda.route_launches = {"tensor_cores": 0, "simt": 0}
        megakernel_cuda.build_launches = {}

    def expect_counts(path: str, want: dict) -> dict:
        """Every kernel's count since zero_counts(); kernels ``want`` does
        not name must not have launched."""
        got = {k: w.launches for k, w in wrappers.items()}
        want = {k: want.get(k, 0) for k in wrappers}
        if got != want:
            fail(f"{path}: kernel launches {got}, want {want}")
        return got

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ---------------------------------------------------- #
    smi = card()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    # ---- build the paths' kernels from the checkout's sources --------- #
    t0 = time.perf_counter()
    libs = ("dyn_fir", "megakernel", "gauss5x5", "motion_post", "flash_attention",
            "ssd", "rglru")
    if train_only:
        libs = ("ssd",)
    if shard_only:
        libs = ("dyn_fir", "flash_attention", "ssd", "rglru")
    # Phase 16's build of B2 with the clock split and phase 17's three
    # health builds, beside the seven.
    other_builds = [threading.Thread(target=_build.build, args=("megakernel",),
                                     kwargs={"defines": d})
                    for d in ((mk_kernel.CLOCK_SPLIT_DEFINE,),
                              mk_kernel.build_defines(guards=True),
                              mk_kernel.build_defines(trace=True),
                              mk_kernel.build_defines(guards=True, trace=True))]
    if not (lm_only or train_only or shard_only):
        for t in other_builds:
            t.start()
    nvcc_out = _build.build(*libs)
    if not (lm_only or train_only or shard_only):
        for t in other_builds:
            t.join()
        for d in ((mk_kernel.CLOCK_SPLIT_DEFINE,), mk_kernel.build_defines(guards=True),
                  mk_kernel.build_defines(trace=True),
                  mk_kernel.build_defines(guards=True, trace=True)):
            if not _build.library_path("megakernel", d).exists():
                fail(f"megakernel build {d} failed")
    log(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s")
    for lib, text in nvcc_out.items():
        for line in text.splitlines():
            log(f"  nvcc[{lib}]: {line}")

    if train_only:
        train = train_phase(dev, smi, zero_counts, expect_counts)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"phase_24": train}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
            flush=True)
        return
    if shard_only:
        shard = shard_phase(dev, smi, zero_counts, expect_counts)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"phase_25": shard}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
            flush=True)
        return
    if lm_only:
        lm = lm_serving(dev, smi, zero_counts, expect_counts)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": lm}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
            flush=True)
        return

    # ---- 2. kernel vs plain on the card -------------------------------- #
    L = BLOCK_L
    b1 = b1_phase(dev, smi)

    # ---- 3. the main path: full-width DPD, dynamic mode ----------------- #
    sched = default_active_schedule(N_FIRINGS, seed=0)

    net_gpu, _ = make_dpd(N_FIRINGS, block_l=L, seed=0, active_schedule=sched,
                          device=dev)
    if net_gpu.buffer_bytes() != 11_534_432:
        fail(f"Eq. 1 buffer bytes {net_gpu.buffer_bytes()} != 11534432")
    prog_main = net_gpu.compile(mode="dynamic")
    state0 = prog_main.init_state()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res_gpu = prog_main.run(state0, in_place=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expected = int(sched.sum())
    launches = expect_counts("DPD dynamic", {"B1": expected, "B2": 0, "B3": 0,
                                             "B4": 0})["B1"]
    log(f"DPD dynamic on the card: {wall * 1e3:.1f} ms, sweeps {res_gpu.sweeps}, "
        f"dyn_fir launches {launches} (expected sum of schedule {expected})")
    for f, spec in zip(res_gpu.state.fifos, net_gpu.fifos.values()):
        if not spec.is_control and not f.buf.is_cuda:
            fail(f"data ring {spec.name} is on {f.buf.device}")
    for a_name, a_state in zip(res_gpu.state.actor_names, res_gpu.state.actors):
        for leaf in (a_state if isinstance(a_state, tuple) else (a_state,)):
            if isinstance(leaf, torch.Tensor) and not leaf.is_cuda:
                fail(f"actor state of {a_name} is on {leaf.device}")

    net_cpu, _ = make_dpd(N_FIRINGS, block_l=L, seed=0, active_schedule=sched,
                          device="cpu")
    res_cpu = net_cpu.compile(mode="dynamic").run()
    if res_cpu.sweeps != res_gpu.sweeps or res_cpu.fire_counts != res_gpu.fire_counts:
        fail(f"structure differs from the CPU run: sweeps {res_gpu.sweeps} vs "
             f"{res_cpu.sweeps}, counts {res_gpu.fire_counts} vs {res_cpu.fire_counts}")
    gpu_leaves = state_to_numpy(res_gpu.state)
    cpu_leaves = state_to_numpy(res_cpu.state)
    worst_state = 0.0
    for i, (g, c) in enumerate(zip(gpu_leaves, cpu_leaves)):
        if g.shape != c.shape or g.dtype != c.dtype:
            fail(f"state leaf {i}: {g.shape} {g.dtype} vs {c.shape} {c.dtype}")
        if np.issubdtype(c.dtype, np.integer):
            if not np.array_equal(g, c):
                fail(f"state leaf {i} (integer) differs from the CPU run")
        else:
            if not np.all(np.isfinite(g)):
                fail(f"state leaf {i} has non-finite values")
            worst_state = max(worst_state, plane_rel_err(c, g))
    if worst_state > REL_TOL:
        fail(f"float state differs from the CPU run by {worst_state:.3g} * max|y|")
    sink = res_gpu.state.actor("sink")[0]
    if tuple(sink.shape) != (2, N_FIRINGS * L):
        fail(f"sink slab shape {tuple(sink.shape)}")
    log(f"DPD structure equals the CPU run (sweeps {res_gpu.sweeps}, counts, "
        f"cursors); floats within {worst_state:.3g} * max|y| per plane")

    # ---- 6. B2: the main path in one launch per run -------------------- #
    # Runs before 4 and 5, which time it.  Bar: every leaf bit-identical
    # (B2 runs B1's arithmetic and the adder's adds in the host path's
    # order), so the tolerance is 0.
    from repro_torch.core.megakernel import compile_megakernel
    for cores in (1, 2):
        prog_mk = net_gpu.compile(mode="megakernel", cores=cores)
        st = prog_mk.init_state()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res_mk = prog_mk.run(st, in_place=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mk_launches = expect_counts(f"DPD megakernel cores={cores}",
                                    {"B1": 0, "B2": 1, "B3": 0, "B4": 0})["B2"]
        if res_mk.sweeps != res_gpu.sweeps or res_mk.fire_counts != res_gpu.fire_counts:
            fail(f"megakernel cores={cores}: sweeps {res_mk.sweeps} vs "
                 f"{res_gpu.sweeps}, counts {res_mk.fire_counts} vs "
                 f"{res_gpu.fire_counts}")
        if not states_equal(res_mk.state, res_gpu.state):
            bad = [i for i, (a, b) in enumerate(zip(state_to_numpy(res_mk.state),
                                                    state_to_numpy(res_gpu.state)))
                   if not np.array_equal(a, b)]
            fail(f"megakernel cores={cores}: state leaves {bad} differ from "
                 "the host dynamic run on the card")
        plain_state = prog_mk.init_state()
        compile_megakernel(net_gpu, cores=cores).plain(plain_state)
        torch.cuda.synchronize()
        b2_err = 0.0
        for g, r in zip(state_to_numpy(res_mk.state), state_to_numpy(plain_state)):
            if g.dtype != r.dtype or g.shape != r.shape:
                fail(f"megakernel cores={cores}: leaf {g.dtype} {g.shape} vs "
                     f"{r.dtype} {r.shape}")
            b2_err = max(b2_err, float(np.abs(g.astype(np.float64)
                                              - r.astype(np.float64)).max())
                         if g.size else 0.0)
        if b2_err != 0.0 or not states_equal(res_mk.state, plain_state):
            fail(f"megakernel cores={cores}: differs from its plain version "
                 f"on the card, max_abs_err {b2_err}")
        if cores == 1:
            mk_sink = res_mk.state.actor("sink")[0].clone()
        log(f"DPD megakernel cores={cores} on the card: {wall * 1e3:.2f} ms cold, "
            f"sweeps {res_mk.sweeps}, B2 launches {mk_launches}, B1 launches 0; "
            "every leaf bit-identical to the dynamic run and to the plain version")

    # B2's own time: launches back to back (every DPD channel is forwarded,
    # so the kernel re-zeroes the rings itself).
    b2_ms, b2_meta = b2_timed(net_gpu, dev)
    if b2_meta[0] != res_gpu.sweeps:
        fail(f"timed B2 launches ran {b2_meta[0]} sweeps, not {res_gpu.sweeps}")
    b2_blocks = b2_meta[5]
    runner = compile_megakernel(net_gpu)
    plain_times = []
    for _ in range(3):
        st = net_gpu.init_state()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        runner.plain(st)
        end.record()
        torch.cuda.synchronize()
        plain_times.append(start.elapsed_time(end))
    b2_plain_ms = float(np.median(plain_times))
    # Bound: Poly's fp32 work on this run's schedule (order k+1 runs on
    # firings with more than k active branches), against the HBM time of
    # the source and sink slabs, taps, histories and the schedule.
    b2_flops = float(sum(L * (84 + k + 1) for n_act in sched for k in range(int(n_act))))
    b2_bytes = 4 * (2 * 2 * N_FIRINGS * L + 10 * 2 * N_TAPS
                    + 10 * 2 * 2 * (N_TAPS - 1) + N_FIRINGS)
    b2_bound_ms, b2_bound_by = bound_of(b2_bytes, b2_flops, FP32_FLOP_PER_S)
    log(f"megakernel timing ({smi}): B2 {b2_ms:.4f} ms per run (CUDA events, "
        f"{b2_blocks} blocks), plain version {b2_plain_ms:.2f} ms per run, "
        f"bound {b2_bound_ms:.5f} ms ({b2_bound_by}: {b2_flops:.4g} flop, {b2_bytes} B)")

    # ---- 4. Table 4 rows ------------------------------------------------ #
    samples = N_FIRINGS * L
    mixed = np.resize(np.array([2, 10, 5, 7, 3, 9, 2, 10], np.int32), N_FIRINGS)
    variants = [
        ("static_all10", dict(static_all_active=True)),
        ("min_active2", dict(active_schedule=np.full(N_FIRINGS, 2, np.int32))),
        ("mixed", dict(active_schedule=mixed)),
        ("all10", dict(active_schedule=np.full(N_FIRINGS, 10, np.int32))),
    ]
    # The paper's baseline framework (runtime_mode STATIC_DAL) refuses the
    # dynamic network in every accelerated mode and takes the static
    # all-10 one, which Table 4's static_all10 rows then run under it.
    for mode in ("static", "dynamic", "megakernel"):
        try:
            net_gpu.compile(mode=mode, runtime_mode=RuntimeMode.STATIC_DAL,
                            n_iterations=N_FIRINGS if mode == "static" else None)
        except ValueError as e:
            if "STATIC_DAL mode: dynamic-rate actors" not in str(e):
                raise
        else:
            fail(f"runtime_mode static_dal took DPD's dynamic network in {mode} mode")
    log("table4: runtime_mode static_dal refuses DPD's dynamic network in static, "
        "dynamic and megakernel mode and takes the static all-10 network")
    rows = []
    for label, kw in variants:
        net, _ = make_dpd(N_FIRINGS, block_l=L, seed=1, device=dev, **kw)
        dal = {"runtime_mode": RuntimeMode.STATIC_DAL} if label == "static_all10" else {}
        for mode in ("static", "dynamic", "megakernel"):
            prog = net.compile(mode=mode, n_iterations=N_FIRINGS if mode == "static" else None,
                               **dal)
            base = prog.init_state()
            times = []
            for _ in range(8):
                st = base.clone()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prog.run(st, in_place=True)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            dt = float(np.median(times[1:]))
            rows.append({"network": label, "mode": mode,
                         "Msamples_per_s": samples / dt / 1e6, "ms": dt * 1e3})
            log(f"table4 {label:12s} {mode:7s}: {samples / dt / 1e6:10.2f} "
                f"Msamples/s ({dt * 1e3:.2f} ms for {samples} samples; {smi})")
    log("table4 " + json.dumps({"card": smi, "rows": rows}))
    # The dynamic-rate gain (PERF.md section 2): min_active2 over the static
    # all-10 network in the same mode, and all10's time over min_active2's.
    ms_of = {(r["network"], r["mode"]): r["ms"] for r in rows}
    gain = {mode: {"min_active2_over_static_all10":
                   ms_of[("static_all10", mode)] / ms_of[("min_active2", mode)],
                   "all10_over_min_active2":
                   ms_of[("all10", mode)] / ms_of[("min_active2", mode)]}
            for mode in ("static", "dynamic", "megakernel")}
    log("table4_gain " + json.dumps({"card": smi, "gain": gain}))

    # ---- 5. where the time goes on the main path ------------------------ #
    # Busy share: device time of one profiled run over the median wall time
    # of warm unprofiled runs of the same network and schedule.
    warm_walls = warm_wall_ms(prog_main)
    warm_ms = float(np.median(warm_walls))
    device_ms, kernels, profiled_ms, _ = profile_program(prog_main, 1)
    fir = [(n, ms) for k, n, ms in kernels if "dyn_fir" in k]
    fir_ms = fir[0][1] / fir[0][0] if fir else None
    profile_rec = {
        "card": smi, "warm_wall_ms": warm_ms, "warm_walls_ms": warm_walls,
        "profiled_wall_ms": profiled_ms, "device_ms": device_ms,
        "busy_share": device_ms / warm_ms,
        "dyn_fir_device_ms_per_launch": fir_ms,
        "top": [{"kernel": k, "count": n, "device_ms": ms}
                for k, n, ms in kernels[:6]]}
    log("profile " + json.dumps(profile_rec))
    if fir:
        log(f"B1 in the dynamic run's profile ({smi}): {fir[0][0]} launches, "
            f"{fir_ms:.6f} ms of device time per launch")

    # The same in megakernel mode: one B2 launch per run.
    prog_mk = net_gpu.compile(mode="megakernel")
    mk_walls = warm_wall_ms(prog_mk)
    mk_warm_ms = float(np.median(mk_walls))
    mk_device_ms, mk_kernels, _, mk_launch_ms = profile_program(prog_mk, 3)
    b2_device_ms = mk_device_ms
    mk_rec = {
        "card": smi, "warm_wall_ms": mk_warm_ms, "warm_walls_ms": mk_walls,
        "device_ms": mk_device_ms, "b2_launch_ms": mk_launch_ms,
        "busy_share": mk_device_ms / mk_warm_ms, "runs_profiled": 3,
        "kernels": [{"kernel": k, "count": n, "device_ms": ms}
                    for k, n, ms in mk_kernels]}
    log("profile_megakernel " + json.dumps(mk_rec))

    # Host split: cumulative time of the scheduler's parts under cProfile,
    # which slows every Python call, so its shares matter, not its totals.
    import cProfile
    import pstats
    st = prog_main.init_state()
    torch.cuda.synchronize()
    cprof = cProfile.Profile()
    cprof.enable()
    prog_main.run(st, in_place=True)
    torch.cuda.synchronize()
    cprof.disable()
    cum: dict = {}
    for (fname, _, func), (_, _, _, ct, _) in pstats.Stats(cprof).stats.items():
        part = None
        if fname.endswith("core/executor.py") and func in (
                "run_dynamic", "_can_fire", "_max_fireable", "fire_actor"):
            part = func
        elif fname.endswith("core/fifo.py") and func in (
                "read", "read_masked", "write_masked"):
            part = "ring_io"
        elif fname.endswith("graphs/dpd.py") and func in (
                "fire", "fork_fire", "adder_fire", "src_fire", "sink_fire",
                "config_fire"):
            part = "bodies"
        elif fname.endswith("dyn_fir/kernel.py") and func == "dpd_branch_cuda":
            part = "dyn_fir_wrapper"
        if part is not None:
            cum[part] = cum.get(part, 0.0) + ct * 1e3
    total = cum.get("run_dynamic", 0.0)
    if not total:
        fail("cProfile saw no run_dynamic on the main path")
    host_rec = {"card": smi, "cprofile_run_dynamic_ms": total,
                "parts_ms": cum,
                "shares": {k: v / total for k, v in cum.items()},
                "note": ("fire_actor holds ring_io and bodies; bodies hold "
                         "dyn_fir_wrapper; _can_fire and _max_fireable are "
                         "the predicates")}
    log("host " + json.dumps(host_rec))

    md = motion_detection(dev, smi, zero_counts, expect_counts)

    # ---- 16. B2's clock split ------------------------------------------- #
    from repro_torch.graphs.motion_detection import bench_workload
    md_net = bench_workload(MD_FRAMES, rate=MD_RATE, frame_hw=MD_HW, seed=0, device=dev)
    for label, split_net, sweeps in (("dpd", net_gpu, res_gpu.sweeps),
                                     ("md", md_net, 121)):
        split = b2_split(split_net, dev)
        if split["sweeps"] != sweeps:
            fail(f"B2 clock split on {label}: {split['sweeps']} sweeps, not {sweeps}")
        log(f"b2_split_{label} " + json.dumps({"card": smi, **split}))

    # ---- 17. guards, trace and fault injection (A7) ---------------------- #
    a7 = a7_phase(dev, smi, zero_counts, expect_counts,
                  (net_gpu, res_gpu, {"B1": expected}),
                  (md["net"], md["result"], {"B3": MD_FRAMES // MD_RATE}),
                  {"dpd": (b2_bound_ms, b2_bound_by),
                   "md": (md["B2"]["bound_ms"], md["B2"]["bound_by"])})
    del md["net"], md["result"]
    torch.cuda.empty_cache()
    # ---- 23(a, b). DPD streamed, killed and resumed ---------------------- #
    durable = stream_phase(dev, smi, zero_counts, expect_counts, net_gpu, res_gpu,
                           mk_sink, expected)
    torch.cuda.empty_cache()
    moe = moe_phase(dev, smi, zero_counts, expect_counts)
    lm = lm_serving(dev, smi, zero_counts, expect_counts)
    # ---- 25. the multi-device runtime ------------------------------------ #
    torch.cuda.empty_cache()
    shard = shard_phase(dev, smi, zero_counts, expect_counts)
    shard_from = ("phase 25: k ranks of a gloo group on this one card "
                  "(ExecutionPlan(devices=k), pipeline_forward), per rank")
    for row in lm:
        if row["name"] in ("flash_attention", "rglru"):
            row["shard_launches"] = [x["B5" if row["name"] == "flash_attention" else "B7"]
                                     for x in shard["serve"]["launches"]]
            row["shard_launches_from"] = (shard_from + "; (b) recurrentgemma-2b through "
                                          "ActorEngine at devices=2, one generate")
        if row["name"] == "ssd":
            row["shard_launches"] = shard["pipeline"]["b6_launches"]
            row["shard_launches_from"] = (shard_from + "; (c) mamba2-780m through "
                                          "pipeline_forward, 4 stages")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "dyn_fir.dpd_branch",
        "route": "cuda",
        "source": "src/repro_torch/csrc/dyn_fir.cu",
        "replaces": "src/repro/kernels/dyn_fir/kernel.py:55",
        "function": "dpd_branch_pallas",
        "launches": launches,
        **b1,
        "device_ms": fir_ms,
        "library_ms": None,
        "stream_launches": durable["stream"]["b1_launches_dynamic"],
        "stream_launches_from": "phase 23: DPD streamed in dynamic mode, 4 chunks",
        "shard_launches": {str(k): shard["dpd"][k]["b1_launches"] for k in (2, 4)},
        "shard_launches_from": "phase 25(a): DPD at devices 2 and 4, one run, per rank",
    }, {
        "name": "megakernel.b2",
        "route": "cuda",
        "source": "src/repro_torch/csrc/megakernel.cu",
        "replaces": "src/repro/core/megakernel/kernel.py:780",
        "function": "compile_megakernel",
        "launches": mk_launches,
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "device_ms": b2_device_ms,
        "plain_ms": b2_plain_ms,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_bound_by,
        "library_ms": None,
        "network": "dpd",
        "motion_detection": md["B2"],
        "stream": {"launches_chunked": durable["stream"]["b2_launches"]["chunked"],
                   "launches_persistent": durable["stream"]["b2_launches"]["persistent"],
                   "launches_run_checkpointed":
                       durable["durable"]["run_checkpointed_b2_launches"],
                   "walls_ms": durable["stream"]["walls_ms"],
                   "from": "phase 23: DPD streamed (4 chunks) and run in segments"},
    }, {
        "name": "megakernel.b2.moe",
        "route": "cuda",
        "source": "src/repro_torch/csrc/megakernel.cu",
        "replaces": "src/repro/core/megakernel/kernel.py:780",
        "function": "compile_megakernel (the MoE actor network's router, expert, "
                    "combine and packer bodies)",
        "launches": moe["launches"],
        "max_abs_err": 0.0,
        "max_abs_err_at": "B2 against its plain version (ref.py) at make_moe's width "
                          "and at D 256 / E 8 (phase 18), bit for bit",
        "ms": moe["ms"],
        "plain_ms": float(np.median(moe["host_dynamic"]["warm_walls_ms"])),
        "plain": "the host dynamic mode's warm wall at the same width (torch.matmul "
                 "bodies); B2's plain version runs the products term by term, "
                 "minutes at this width (its times at the two small widths: "
                 "plain_bits)",
        "plain_bits": moe["plain_bits"],
        "bound_ms": moe["bound_ms"],
        "bound_by": moe["bound_by"],
        "library_ms": None,
        "network": "moe_as_actors at olmoe-1b-7b's widths",
        "y_err_over_max_vs_host": moe["y_err_over_max"],
        "tokens_under_margin": moe["tokens_under_margin"],
    }, {
        "name": "gauss5x5",
        "route": "cuda",
        "source": "src/repro_torch/csrc/gauss5x5.cu",
        "replaces": "src/repro/kernels/gauss5x5/kernel.py:55",
        "function": "gauss5x5_pallas",
        **md["B3"],
        "library_ms": None,
    }, {
        "name": "motion_post",
        "route": "cuda",
        "source": "src/repro_torch/csrc/motion_post.cu",
        "replaces": "src/repro/kernels/motion_post/kernel.py:44",
        "function": "motion_post_pallas",
        **md["B4"],
        "library_ms": None,
    }, *a7, *lm]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
