"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
``sm_90a``, one ``nvcc`` per library, started together) and, on the card:

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
   (``cProfile``).

Every phase fails the run; nothing is caught.  The line before the last
is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero with no result when no
CUDA device is visible.
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this script "
                         "runs only on the card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.convert import state_to_numpy
    from repro_torch.core.megakernel import megakernel_cuda
    from repro_torch.core.megakernel.program import stage
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd, states_equal
    from repro_torch.kernels import _build
    from repro_torch.kernels.dyn_fir import (N_TAPS, dpd_branch_cuda,
                                             poly_branch, poly_ref)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ---------------------------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    # ---- build the paths' kernels from the checkout's sources --------- #
    t0 = time.perf_counter()
    nvcc_out = _build.build("dyn_fir", "megakernel")
    log(f"built dyn_fir and megakernel in {time.perf_counter() - t0:.1f} s")
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
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel_all_orders()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernel_all_orders()
    k_ms = cuda_ms(graph.replay) / N_TAPS
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
    dpd_branch_cuda.launches = 0
    t0 = time.perf_counter()
    res_gpu = prog_main.run(state0, in_place=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dpd_branch_cuda.launches
    expected = int(sched.sum())
    log(f"DPD dynamic on the card: {wall * 1e3:.1f} ms, sweeps {res_gpu.sweeps}, "
        f"dyn_fir launches {launches} (expected sum of schedule {expected})")
    if launches != expected:
        fail(f"dyn_fir launches {launches} != {expected}")
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
        megakernel_cuda.launches = 0
        dpd_branch_cuda.launches = 0
        t0 = time.perf_counter()
        res_mk = prog_mk.run(st, in_place=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mk_launches = megakernel_cuda.launches
        if mk_launches != 1 or dpd_branch_cuda.launches != 0:
            fail(f"megakernel cores={cores}: {mk_launches} B2 launches and "
                 f"{dpd_branch_cuda.launches} B1 launches in one run (want 1, 0)")
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

    # B2's own time: launches back to back on a staged argument block, reset
    # before each launch (every DPD channel is forwarded, so the kernel
    # re-zeroes the rings itself); the runner's staging is out of it.
    runner = compile_megakernel(net_gpu)
    dp = runner.device_program
    st = net_gpu.init_state()
    tensors, io = stage(dp, st, dev, [t.to(dev) for _, t in dp.consts])
    args0 = torch.tensor([0 if t is None else t.data_ptr() for t in tensors] + io,
                         dtype=torch.int64, device=dev)
    args = args0.clone()
    table_dev = dp.table.to(dev)

    def b2_launch():
        args.copy_(args0)
        megakernel_cuda(table_dev, args, dp.n_ptrs, 1_000_000, True)

    b2_ms = cuda_ms(b2_launch, reps=5, inner=5)
    b2_io = args[dp.n_ptrs:].cpu().tolist()
    if b2_io[dp.io_meta] != res_gpu.sweeps:
        fail(f"timed B2 launches ran {b2_io[dp.io_meta]} sweeps, not {res_gpu.sweeps}")
    b2_blocks = b2_io[dp.io_meta + 5]
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
    warm_walls = []
    for _ in range(5):
        st = prog_main.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog_main.run(st, in_place=True)
        torch.cuda.synchronize()
        warm_walls.append(time.perf_counter() - t0)
    warm_ms = float(np.median(warm_walls)) * 1e3

    from torch.profiler import ProfilerActivity, profile
    st = prog_main.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prog_main.run(st, in_place=True)
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        fail("the profiler saw no device time on the main path")
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    fir = [e for e in kernels if "dyn_fir" in e.key]
    fir_ms = (fir[0].self_device_time_total / fir[0].count / 1e3) if fir else None
    profile_rec = {
        "card": smi, "warm_wall_ms": warm_ms,
        "warm_walls_ms": [w * 1e3 for w in warm_walls],
        "profiled_wall_ms": profiled_ms, "device_ms": device_ms,
        "busy_share": device_ms / warm_ms,
        "dyn_fir_device_ms_per_launch": fir_ms,
        "top": [{"kernel": e.key[:80], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3} for e in top]}
    log("profile " + json.dumps(profile_rec))

    # The same in megakernel mode: one B2 launch per run.
    prog_mk = net_gpu.compile(mode="megakernel")
    mk_walls = []
    for _ in range(5):
        st = prog_mk.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog_mk.run(st, in_place=True)
        torch.cuda.synchronize()
        mk_walls.append(time.perf_counter() - t0)
    mk_warm_ms = float(np.median(mk_walls)) * 1e3
    st = prog_mk.init_state()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prog_mk.run(st, in_place=True)
        torch.cuda.synchronize()
    mk_kernels = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    b2_events = [e for e in mk_kernels if "megakernel" in e.key]
    if not b2_events:
        fail("the profiler saw no B2 launch in megakernel mode")
    mk_device_ms = sum(e.self_device_time_total for e in mk_kernels) / 1e3
    b2_device_ms = b2_events[0].self_device_time_total / b2_events[0].count / 1e3
    mk_rec = {
        "card": smi, "warm_wall_ms": mk_warm_ms,
        "warm_walls_ms": [w * 1e3 for w in mk_walls],
        "device_ms": mk_device_ms, "b2_device_ms": b2_device_ms,
        "busy_share": mk_device_ms / mk_warm_ms,
        "kernels": [{"kernel": e.key[:80], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in sorted(mk_kernels, key=lambda e: -e.self_device_time_total)]}
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
