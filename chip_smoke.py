"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
``sm_90a``) and, on the card:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds every kernel against its plain PyTorch version at the main
   path's shapes and times both (CUDA events; the kernel's own time from
   replays of a CUDA graph of its launches, so the host wrapper is out of
   it);
3. drives the main path — the DPD network at full width (block 32 768,
   10 branches, 64 firings, dynamic mode) — with every launch count set to
   0 just before and read just after, and holds its structure (exactly)
   and its floats (``1e-5 * max|y|`` per plane) against the same run on the
   CPU;
4. measures the paper's Table 4 rows (Msamples/s) in static and dynamic
   mode;
5. profiles the main path: device time by kernel (``torch.profiler``),
   the device's busy share against the median wall time of warm runs, and
   where the host's time goes (``cProfile``).

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
    from repro_torch.graphs.dpd import default_active_schedule
    from repro_torch.graphs.factories import make_dpd
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

    # ---- build the path's kernel from the checkout's sources ---------- #
    t0 = time.perf_counter()
    nvcc_out = _build.build("dyn_fir")
    log(f"built dyn_fir in {time.perf_counter() - t0:.1f} s")
    for line in nvcc_out.splitlines():
        log(f"  nvcc[dyn_fir]: {line}")

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
        for mode in ("static", "dynamic"):
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
