"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --b2 SRC    # B2's time alone, from another src tree

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
``sm_90a``, one ``nvcc`` per library, all four started together:
``dyn_fir`` B1, ``megakernel`` B2, ``gauss5x5`` B3, ``motion_post`` B4)
and, on the card:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds kernel B1 against its plain PyTorch version at the main path's
   shapes and times both (CUDA events; the kernel's own time from replays
   of a CUDA graph of its launches, so the host wrapper is out of it);
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
   megakernel mode;
5. profiles the main path in dynamic and in megakernel mode: device time by
   kernel (``torch.profiler``), the device's busy share against the median
   wall time of warm runs, and where the host's time goes in dynamic mode
   (``cProfile``);
7. holds kernels B3 (Gauss) and B4 (Thres + Med) against their plain
   versions at motion detection's shapes, (4, 240, 320): B3 bit-identical
   on u8 frames (one built to hold ``.5`` ties among them) and within
   ``rtol 1e-5, atol 1e-3`` on float frames, B4 exact; and times both;
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
    by kernel and the busy share against the median warm wall.

Every launch count is set to 0 just before each path is driven and read
just after; launches made to compare a kernel with its plain version or
to time it are outside those windows.  Every phase fails the run; nothing
is caught.  The line before the last
is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero with no result when no
CUDA device is visible.

``--b2 SRC`` times kernel B2 alone (as phases 6 and 9 do) from the
``repro_torch`` package under ``SRC`` and prints one ``b2 {...}`` line;
run in turns from two trees it compares B2 across commits on one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# The card's published rates (H100 SXM data sheet, dense): memory
# bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

BLOCK_L = 32768
N_FIRINGS = 64
REL_TOL = 1e-5          # |Δ| <= REL_TOL * max|y_ref|, per plane
KERNEL_TOL = 2e-3       # rtol = atol of tests/test_kernels.py
GAUSS_RTOL, GAUSS_ATOL = 1e-5, 1e-3   # B3 on float frames, tests/test_kernels.py:20

MD_FRAMES, MD_RATE, MD_HW = 960, 4, (240, 320)
GAUSS_FLOP_PER_PX = 20  # separable 5 + 5 multiply-adds per interior pixel


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

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*args)
        end.record()
        events.append((start, end))

    def run():
        for st in states:
            prog.run(st, in_place=True)

    timed.launches = launch.launches
    mk.megakernel_cuda = timed
    try:
        device_ms, kernels, wall = profile_run(run)
    finally:
        mk.megakernel_cuda = launch
        launch.launches = timed.launches
    b2_ms = [start.elapsed_time(end) for start, end in events]
    if prog.plan.mode == "megakernel":
        if len(b2_ms) != runs:
            fail(f"{len(b2_ms)} B2 launches in {runs} megakernel runs")
        device_ms = sum(b2_ms)
    return device_ms / runs, kernels, wall / runs, b2_ms


def b2_timed(net, dev) -> tuple:
    """B2's own time per run of ``net``: launches back to back on a staged
    argument block, reset before each launch, so the runner's staging is
    out of it (the rings keep the last run's bytes, which changes no work:
    forwarded rings are re-zeroed by the kernel and the same bodies run on
    the same windows).  Returns ``(ms, meta words after the last launch)``."""
    from repro_torch.core.megakernel import compile_megakernel, megakernel_cuda
    from repro_torch.core.megakernel.program import stage
    dp = compile_megakernel(net).device_program
    tensors, io = stage(dp, net.init_state(), dev, [t.to(dev) for _, t in dp.consts])
    args0 = torch.tensor([0 if t is None else t.data_ptr() for t in tensors] + io,
                         dtype=torch.int64, device=dev)
    args = args0.clone()
    table = dp.table.to(dev)

    def launch():
        args.copy_(args0)
        megakernel_cuda(table, args, dp.n_ptrs, 1_000_000, True)

    ms = cuda_ms(launch, reps=7, inner=5)
    return ms, args[dp.n_ptrs + dp.io_meta:].cpu().tolist()


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


def motion_detection(dev, smi: str, zero_counts, expect_counts) -> dict:
    """Phases 7-11; returns the kernels line's records of B3, B4 and B2's
    motion detection numbers."""
    from repro_torch.core.megakernel import compile_megakernel
    from repro_torch.graphs.factories import states_equal
    from repro_torch.graphs.motion_detection import bench_workload
    from repro_torch.kernels.gauss5x5 import (gauss5x5, gauss5x5_ref,
                                              gauss5x5_u8_ref)
    from repro_torch.kernels.motion_post import motion_post, motion_post_ref

    H, W = MD_HW
    shape = (MD_RATE, H, W)
    n_px = MD_RATE * H * W

    # ---- 7. B3 and B4 against their plain versions ---------------------- #
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, shape).astype(np.uint8)
    # Frame 0 is built to blur to exact .5 values: isolated 128s give
    # 128/256 = 0.5 at their corners, 64s give 64 * 6/256 = 1.5 beside them.
    frames[0] = 0
    frames[0, 4::9, 4::11] = 128
    frames[0, 8::9, 8::11] = 64
    x_u8 = torch.tensor(frames, device=dev)
    blurred = gauss5x5_ref(x_u8.to(torch.float32))
    ties = int(torch.count_nonzero(blurred - torch.floor(blurred) == 0.5))
    ties0 = int(torch.count_nonzero(blurred[0] - torch.floor(blurred[0]) == 0.5))
    if ties0 == 0:
        fail("B3: the tie frame blurs to no .5 value")
    got_u8, want_u8 = gauss5x5(x_u8), gauss5x5_u8_ref(x_u8)
    torch.cuda.synchronize()
    if got_u8.dtype != torch.uint8 or not torch.equal(got_u8, want_u8):
        bad = int(torch.count_nonzero(got_u8 != want_u8))
        fail(f"B3 u8: {bad} pixels differ from the plain version")
    x_f = torch.tensor(rng.uniform(0, 255, shape).astype(np.float32), device=dev)
    got_f, want_f = gauss5x5(x_f), gauss5x5_ref(x_f)
    torch.cuda.synchronize()
    g, r = got_f.cpu().numpy(), want_f.cpu().numpy()
    if not np.all(np.isfinite(g)):
        fail("B3 float: non-finite output")
    np.testing.assert_allclose(g, r, rtol=GAUSS_RTOL, atol=GAUSS_ATOL)
    b3_err = float(np.abs(g - r).max())
    prev_f = torch.clamp(x_f + torch.tensor(
        rng.normal(scale=45.0, size=shape).astype(np.float32), device=dev), 0, 255)
    got_m, want_m = motion_post(x_f, prev_f), motion_post_ref(x_f, prev_f)
    torch.cuda.synchronize()
    if not torch.equal(got_m, want_m):
        fail(f"B4: {int(torch.count_nonzero(got_m != want_m))} pixels differ "
             "from the plain version")
    b4_err = float((got_m - want_m).abs().max())
    log(f"B3 vs plain on {shape}: u8 bit-identical ({ties} .5 ties, {ties0} "
        f"in the built frame), float max_abs_err {b3_err:.3g}; B4 exact")

    b3_ms = graph_ms(lambda: gauss5x5(x_u8), copies=10)
    b3_wrapper_ms = cuda_ms(lambda: gauss5x5(x_u8))
    b3_plain_ms = cuda_ms(lambda: gauss5x5_u8_ref(x_u8))
    b3f_ms = graph_ms(lambda: gauss5x5(x_f), copies=10)
    b4_ms = graph_ms(lambda: motion_post(x_f, prev_f), copies=10)
    b4_wrapper_ms = cuda_ms(lambda: motion_post(x_f, prev_f))
    b4_plain_ms = cuda_ms(lambda: motion_post_ref(x_f, prev_f))
    _, b3_prof, _ = profile_run(lambda: [gauss5x5(x_u8) for _ in range(20)])
    _, b4_prof, _ = profile_run(lambda: [motion_post(x_f, prev_f) for _ in range(20)])
    b3_dev = [ms / n for k, n, ms in b3_prof if "gauss5x5" in k]
    b4_dev = [ms / n for k, n, ms in b4_prof if "motion_post" in k]
    if not b3_dev or not b4_dev:
        fail("the profiler saw no B3 or B4 launch")
    # Bounds: each input byte read once, each output written once; the
    # operations are what the functions need: the blur's separable 5 + 5
    # multiply-adds (20 flop) per interior pixel, as the Gauss actor's
    # cost_flops counts them (B3 runs 25 taps in the plain version's order
    # for bit-identity; the bound does not charge that choice), and B4's
    # subtract, abs and compare plus 8 min/max per pixel (fp32).
    interior = MD_RATE * (H - 4) * (W - 4)
    b3_bytes, b3_flops = 2 * n_px, GAUSS_FLOP_PER_PX * interior
    b4_bytes, b4_flops = 3 * 4 * n_px, 11 * n_px
    b3f_bytes = 2 * 4 * n_px

    def bound(nbytes: float, flops: float) -> tuple:
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = flops / FP32_FLOP_PER_S * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    b3_bound, b3_by = bound(b3_bytes, b3_flops)
    b3f_bound, _ = bound(b3f_bytes, b3_flops)
    b4_bound, b4_by = bound(b4_bytes, b4_flops)
    log(f"B3 timing ({smi}): u8 {b3_ms:.5f} ms/launch (CUDA graph replay; "
        f"profiler {b3_dev[0]:.5f}), wrapper {b3_wrapper_ms:.5f} ms/call back "
        f"to back, plain {b3_plain_ms:.5f} ms/call, bound {b3_bound:.6f} ms "
        f"({b3_by}: {b3_bytes} B, {b3_flops} flop); float {b3f_ms:.5f} "
        f"ms/launch, bound {b3f_bound:.6f} ms")
    log(f"B4 timing ({smi}): {b4_ms:.5f} ms/launch (CUDA graph replay; "
        f"profiler {b4_dev[0]:.5f}), wrapper {b4_wrapper_ms:.5f} ms/call, "
        f"plain {b4_plain_ms:.5f} ms/call, bound {b4_bound:.6f} ms ({b4_by}: "
        f"{b4_bytes} B, {b4_flops} flop)")

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
    b2_bound, b2_by = bound(b2_bytes, b2_flops)
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
               "plain_ms": b3_plain_ms, "bound_ms": b3_bound, "bound_by": b3_by,
               "float_ms": b3f_ms, "float_bound_ms": b3f_bound, "ties": ties},
        "B4": {"launches": 0, "max_abs_err": b4_err, "ms": b4_ms,
               "wrapper_ms": b4_wrapper_ms, "device_ms": b4_dev[0],
               "plain_ms": b4_plain_ms, "bound_ms": b4_bound, "bound_by": b4_by},
        "B2": {"launches": md_b2_launches, "max_abs_err": md_b2_err, "ms": b2_ms,
               "device_ms": b2_dev, "plain_ms": b2_plain_ms,
               "bound_ms": b2_bound, "bound_by": b2_by},
    }


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def b2_turn(src: str) -> None:
    """``--b2 SRC``: B2's time per run (:func:`b2_timed`) from the
    ``repro_torch`` package under ``SRC``, on DPD's main path and on motion
    detection's where that tree has it.  Run in turns from two trees
    (parent, change, change, parent; a parent unpacked with ``git archive``
    into a gitignored directory) it compares B2 across commits on one card."""
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd
    from repro_torch.kernels import _build
    smi = card()
    _build.build("megakernel")
    dev = torch.device("cuda", 0)
    net, _ = make_dpd(N_FIRINGS, block_l=BLOCK_L, seed=0, device=dev,
                      active_schedule=default_active_schedule(N_FIRINGS, seed=0))
    rec = {"src": src, "card": smi, "dpd_ms": b2_timed(net, dev)[0]}
    if (Path(src) / "repro_torch" / "graphs" / "motion_detection.py").exists():
        from repro_torch.graphs.motion_detection import bench_workload
        md = bench_workload(MD_FRAMES, rate=MD_RATE, frame_hw=MD_HW, seed=0, device=dev)
        rec["md_ms"] = b2_timed(md, dev)[0]
    print("b2 " + json.dumps(rec), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this script "
                         "runs only on the card")
    if sys.argv[1:2] == ["--b2"] and len(sys.argv) == 3:
        sys.path.insert(0, sys.argv[2])
        b2_turn(sys.argv[2])
        return
    if len(sys.argv) > 1:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.convert import state_to_numpy
    from repro_torch.core.megakernel import megakernel_cuda
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd, states_equal
    from repro_torch.kernels import _build
    from repro_torch.kernels.dyn_fir import (N_TAPS, dpd_branch_cuda,
                                             poly_branch, poly_ref)
    from repro_torch.kernels.gauss5x5 import gauss5x5_cuda
    from repro_torch.kernels.motion_post import motion_post_cuda

    wrappers = {"B1": dpd_branch_cuda, "B2": megakernel_cuda,
                "B3": gauss5x5_cuda, "B4": motion_post_cuda}

    def zero_counts() -> None:
        for w in wrappers.values():
            w.launches = 0

    def expect_counts(path: str, want: dict) -> dict:
        got = {k: w.launches for k, w in wrappers.items()}
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
    nvcc_out = _build.build("dyn_fir", "megakernel", "gauss5x5", "motion_post")
    log(f"built dyn_fir, megakernel, gauss5x5 and motion_post in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib, text in nvcc_out.items():
        for line in text.splitlines():
            log(f"  nvcc[{lib}]: {line}")

    # ---- 2. kernel vs plain on the card -------------------------------- #
    rng = np.random.default_rng(0)
    L = BLOCK_L
    x = torch.tensor(rng.normal(size=(2, L + N_TAPS - 1)).astype(np.float32), device=dev)
    taps = torch.tensor(rng.normal(scale=0.3, size=(2, N_TAPS)).astype(np.float32), device=dev)
    hist, win = x[:, :N_TAPS - 1], x[:, N_TAPS - 1:]
    worst_rel = worst_abs = 0.0
    for order in range(1, N_TAPS + 1):
        y, next_hist = poly_branch(hist, win, taps, order)
        p_y, p_next = poly_ref(hist, win, taps, order)
        torch.cuda.synchronize()
        if not torch.equal(next_hist, p_next):
            fail(f"dyn_fir order {order}: next history differs from the plain version")
        g, r = y.cpu().numpy(), p_y.cpu().numpy()
        if not np.all(np.isfinite(g)):
            fail(f"dyn_fir order {order}: non-finite kernel output")
        np.testing.assert_allclose(g, r, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        rel = plane_rel_err(r, g)
        if rel > REL_TOL:
            fail(f"dyn_fir order {order}: rel err {rel:.3g} > {REL_TOL}")
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, float(np.abs(g - r).max()))
    log(f"dyn_fir kernel vs plain, L={L}, orders 1..10: max_abs_err "
        f"{worst_abs:.3g}, max rel {worst_rel:.3g}")

    # Time one call per order 1..10, averaged: the main path mixes orders.
    def kernel_all_orders():
        for order in range(1, N_TAPS + 1):
            poly_branch(hist, win, taps, order)

    def plain_all_orders():
        for order in range(1, N_TAPS + 1):
            poly_ref(hist, win, taps, order)

    # The kernel's own time: the ten launches captured once in a CUDA graph
    # and replayed, so the Python wrapper's host time is out of the number.
    k_ms = graph_ms(kernel_all_orders) / N_TAPS
    wrapper_ms = cuda_ms(kernel_all_orders) / N_TAPS
    p_ms = cuda_ms(plain_all_orders) / N_TAPS
    # Bound: each input byte read once (stream, taps), each output written
    # once (samples, next history).
    bytes_moved = 4 * (2 * (L + N_TAPS - 1) + 2 * N_TAPS + 2 * L + 2 * (N_TAPS - 1))
    mean_order = (N_TAPS + 1) / 2
    flops = L * (5 + (mean_order - 1) + 8 * N_TAPS)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"dyn_fir timing ({smi}): kernel {k_ms:.5f} ms/launch (CUDA graph "
        f"replay), wrapper {wrapper_ms:.5f} ms/call back to back, plain "
        f"{p_ms:.5f} ms/call, bound {bound_ms:.6f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: {bytes_moved} B, "
        f"{flops:.0f} flop)")

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
    b2_t_ops = b2_flops / FP32_FLOP_PER_S * 1e3
    b2_t_bytes = b2_bytes / HBM_BYTES_PER_S * 1e3
    b2_bound_ms = max(b2_t_ops, b2_t_bytes)
    log(f"megakernel timing ({smi}): B2 {b2_ms:.4f} ms per run (CUDA events, "
        f"{b2_blocks} blocks), plain version {b2_plain_ms:.2f} ms per run, "
        f"bound {b2_bound_ms:.5f} ms ({'bytes' if b2_t_bytes >= b2_t_ops else 'operations'}: "
        f"{b2_flops:.4g} flop, {b2_bytes} B)")

    # ---- 4. Table 4 rows ------------------------------------------------ #
    samples = N_FIRINGS * L
    mixed = np.resize(np.array([2, 10, 5, 7, 3, 9, 2, 10], np.int32), N_FIRINGS)
    variants = [
        ("static_all10", dict(static_all_active=True)),
        ("min_active2", dict(active_schedule=np.full(N_FIRINGS, 2, np.int32))),
        ("mixed", dict(active_schedule=mixed)),
        ("all10", dict(active_schedule=np.full(N_FIRINGS, 10, np.int32))),
    ]
    rows = []
    for label, kw in variants:
        net, _ = make_dpd(N_FIRINGS, block_l=L, seed=1, device=dev, **kw)
        for mode in ("static", "dynamic", "megakernel"):
            prog = net.compile(mode=mode, n_iterations=N_FIRINGS if mode == "static" else None)
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

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "dyn_fir.dpd_branch",
        "route": "cuda",
        "source": "src/repro_torch/csrc/dyn_fir.cu",
        "replaces": "src/repro/kernels/dyn_fir/kernel.py:55",
        "function": "dpd_branch_pallas",
        "launches": launches,
        "max_abs_err": worst_abs,
        "max_err_rel": worst_rel,
        "ms": k_ms,
        "wrapper_ms": wrapper_ms,
        "device_ms": fir_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
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
        "bound_by": "bytes" if b2_t_bytes >= b2_t_ops else "operations",
        "library_ms": None,
        "network": "dpd",
        "motion_detection": md["B2"],
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
