"""The megakernel backend: kernel B2 and the runner around it.

Replaces ``src/repro/core/megakernel/kernel.py::compile_megakernel``.  On
the card one run of the compiled program is ONE launch of the persistent
kernel ``csrc/megakernel.cu``: every firing of every actor happens inside
it, Poly's arithmetic included.  For a state on the CPU the runner runs the
kernel's plain PyTorch version (:mod:`.ref`) on the same device program.

A network with step actors (``DeviceOp("step")``: the serving network's
decode, the LM stage network's stages) is one launch per enabled step
firing, plus one.  The reference traces such an actor's ``fire`` into its
kernel (``_hoist_fn``); here the kernel ends at the firing with its
scheduler saved in the io words, the runner calls the actor's own
``fire`` on the firing's windows and writes its enabled outputs into the
rings, and launches the kernel again, which resumes where it stopped.  The
plain version runs the same loop.

:func:`megakernel_cuda` is the ctypes wrapper: it checks its operands,
launches on PyTorch's current stream without synchronising, raises on a
refused launch, and adds one to ``megakernel_cuda.launches`` per launch.
The library is built and loaded at the first launch, never at import.  The
kernel's blocks report their progress through one scratch word per SM,
which the wrapper allocates once per device and stream.

The health layer's builds are compile-time variants of the same source,
each a library of its own: ``-DMK_GUARDS`` evaluates the channel guards
(fault words and high-water marks after the meta words) and ``-DMK_TRACE``
writes one event per firing attempt into a trace ring on the card.  The
main build, with both off, is the kernel without them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.megakernel.lower import (GridPartition, MegakernelLayout,
                                               lower_network, partition_layout)
import numpy as np

from repro_torch.core.executor import DynamicResult
from repro_torch.core.megakernel.program import (BODY_CTRL_KINDS, H_MOE, H_SCRATCH,
                                                 KIND_CODES, M_CLK_KIND,
                                                 M_CLK_LOOP, M_CLK_SCHED,
                                                 M_CLK_STALL, MAX_STEP_PORTS,
                                                 Y_OFF, Y_PENDING,
                                                 DeviceProgram,
                                                 build_device_program, health_of,
                                                 stage, unstage)
from repro_torch.core.megakernel.ref import run_program, step_windows
from repro_torch.core.network import Network, NetworkState
from repro_torch.core.trace import COL_OCC, TraceState
from repro_torch.kernels import _build


#: The compile-time defines of B2's other builds: the clock split, the
#: channel guards and the firing trace.
CLOCK_SPLIT_DEFINE = "-DMK_CLOCK_SPLIT"
GUARDS_DEFINE = "-DMK_GUARDS"
TRACE_DEFINE = "-DMK_TRACE"


def build_defines(clock_split: bool = False, guards: bool = False,
                  trace: bool = False) -> Tuple[str, ...]:
    """The ``-D`` flags of one build of ``megakernel.cu``."""
    return tuple(d for on, d in ((clock_split, CLOCK_SPLIT_DEFINE),
                                 (guards, GUARDS_DEFINE), (trace, TRACE_DEFINE))
                 if on)


def build_name(defines: Tuple[str, ...]) -> str:
    """A build's key in ``megakernel_cuda.build_launches``: ``"main"``, or
    its defines joined, as ``"guards+trace"``."""
    return "+".join(d[len("-DMK_"):].lower() for d in defines) or "main"


@functools.lru_cache(maxsize=None)
def _library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built library with its C signatures declared (once per build);
    a trace build's entry takes the ring and its capacity as well."""
    lib = _build.load("megakernel", defines)
    fn = lib.megakernel_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    if TRACE_DEFINE in defines:
        fn.argtypes += [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    lib.megakernel_error_string.argtypes = [ctypes.c_int]
    lib.megakernel_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _progress_words(device: torch.device, stream: int) -> torch.Tensor:
    """The blocks' progress words (one per SM) for launches on ``stream`` of
    ``device``, allocated once and left uninitialised: the kernel zeroes
    them before its start-up grid barrier, so a run launches nothing but
    B2.  The launches of one stream run one after another, and no two
    launches that could overlap share them."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return torch.empty(sms, dtype=torch.int64, device=device)


def megakernel_cuda(table: torch.Tensor, args: torch.Tensor, n_ptrs: int,
                    max_sweeps: int, multi_firing: bool,
                    clock_split: bool = False, io_len: Optional[int] = None,
                    guards: bool = False,
                    trace: Optional[torch.Tensor] = None,
                    n_actors: Optional[int] = None,
                    scratch_words: int = 0, moe: bool = False) -> None:
    """One launch of B2.

    ``n_actors`` (default ``n_ptrs``) and ``scratch_words`` (the table's
    ``H_SCRATCH``) size the shared memory the kernel takes per block;
    ``moe`` (the table's ``H_MOE``) launches the kernel's instance with the
    MoE kinds.
    ``table``: the packed device program, int32 on the card; ``args``: the
    run's int64 block on the same card, ``n_ptrs`` device addresses (rings,
    then actor tensors) followed by the io words, which the kernel
    rewrites.  Every address must stay valid until the launch completes.
    ``io_len`` is the io words through the meta words (default: the rest
    of ``args``); a guarded or traced launch needs the health and trace
    words after them (``DeviceProgram.io_health_len``).
    ``clock_split`` launches the build that also writes block 0's clock
    split into the meta words from ``M_CLK_STALL`` on
    (:func:`decode_clock_split`); ``guards`` the ``MK_GUARDS`` build, and
    ``trace``, a ``(capacity, 3 + n_fifos)`` int32 ring on the card, the
    ``MK_TRACE`` build, which writes the ring and the event count.
    """
    for t, what, dtype in ((table, "table", torch.int32),
                           (args, "args", torch.int64)):
        if not t.is_cuda or t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"megakernel_cuda: {what} must be a contiguous 1-D "
                             f"{dtype} CUDA tensor, got {t.dtype} on {t.device}")
    if table.device != args.device:
        raise ValueError(f"megakernel_cuda: operands span {table.device} and "
                         f"{args.device}")
    if not 0 <= n_ptrs < args.numel():
        raise ValueError(f"megakernel_cuda: n_ptrs {n_ptrs} out of range")
    if not 0 <= max_sweeps < 2 ** 31:
        raise ValueError(f"megakernel_cuda: max_sweeps {max_sweeps} must fit int32")
    if io_len is None:
        io_len = args.numel() - n_ptrs
    if not 0 < io_len <= args.numel() - n_ptrs:
        raise ValueError(f"megakernel_cuda: io_len {io_len} out of range")
    extra = []
    if trace is not None:
        if (not trace.is_cuda or trace.dtype != torch.int32 or trace.dim() != 2
                or trace.shape[1] <= COL_OCC or not trace.is_contiguous()
                or trace.device != args.device):
            raise ValueError("megakernel_cuda: trace must be a contiguous "
                             "(capacity, 3 + n_fifos) int32 tensor on "
                             f"{args.device}")
        extra = [trace.data_ptr(), trace.shape[0]]
    if n_actors is None:
        n_actors = n_ptrs
    if n_actors < 1 or scratch_words < 0:
        raise ValueError(f"megakernel_cuda: n_actors {n_actors} and "
                         f"scratch_words {scratch_words} out of range")
    defines = build_defines(clock_split, guards, trace is not None)
    lib = _library(defines)
    with torch.cuda.device(args.device):
        stream = torch.cuda.current_stream(args.device).cuda_stream
        progress = _progress_words(args.device, stream)
        err = lib.megakernel_run(table.data_ptr(), table.numel(), args.data_ptr(),
                                 n_ptrs, io_len, max_sweeps,
                                 int(bool(multi_firing)), progress.data_ptr(),
                                 progress.numel(), stream, n_actors,
                                 scratch_words, int(bool(moe)), *extra)
    if err != 0:
        raise RuntimeError(
            f"megakernel launch failed: CUDA error {err} "
            f"({lib.megakernel_error_string(err).decode()})")
    megakernel_cuda.launches += 1
    key = build_name(defines)
    megakernel_cuda.build_launches[key] = megakernel_cuda.build_launches.get(key, 0) + 1


#: Launches of the kernel since the count was last set to 0, in all and by
#: build (:func:`build_name`).
megakernel_cuda.launches = 0
megakernel_cuda.build_launches = {}


def decode_clock_split(meta) -> Dict[str, Any]:
    """Block 0's clock split from a run's meta words (the ``MK_CLOCK_SPLIT``
    build): SM cycles its body threads spent waiting for the scheduler
    (``stall_sched``), waiting on other blocks (``stall_wait``: dependency
    waits, ``waits`` of them), and in the whole command loop (``loop``);
    the rest of the loop is bodies, whose cycles and count by kind are in
    ``bodies``.  The scheduler warp's cycles deciding (``sched_busy``) and
    waiting for a free command slot (``sched_full``) are its own."""
    stall, loop = int(meta[M_CLK_STALL]), int(meta[M_CLK_LOOP])
    sched = int(meta[M_CLK_SCHED])
    kinds = [k for k in list(KIND_CODES)[:KIND_CODES["med"] + 1] if k != "config"]
    words = [int(w) for w in meta[M_CLK_KIND:M_CLK_KIND + len(kinds)]]
    return {"stall_sched": stall & 0xFFFFFFFF, "stall_wait": stall >> 32,
            "loop": loop & ((1 << 40) - 1), "waits": loop >> 40,
            "sched_busy": sched & 0xFFFFFFFF, "sched_full": sched >> 32,
            "bodies": {k: {"cycles": w & ((1 << 40) - 1), "count": w >> 40}
                       for k, w in zip(kinds, words)}}


def run_step(network: Network, prog: DeviceProgram, table: List[int],
             state: NetworkState, tensors: List[Optional[torch.Tensor]],
             io: List[int]) -> None:
    """The pending step firing of ``io``'s yield words, as the dynamic
    executor fires it: the actor's ``fire`` on its windows (views of the
    rings) and rates, its new state stored, each enabled output written at
    the offset the firing took, a delay channel's phase-2 write copied back
    to slot 0 (Fig. 2).  The firing's cursors already moved in the kernel."""
    a, in_en, out_en, wins, outw = step_windows(table, tensors, io)
    name = prog.actor_names[a]
    spec = network.actors[name]
    rates = {**dict(zip(spec.in_ports, in_en)), **dict(zip(spec.out_ports, out_en))}
    idx = network.actor_index[name]
    new_st, outs = spec.fire(state.actors[idx], dict(zip(spec.in_ports, wins)), rates)
    missing = set(spec.out_ports) - set(outs)
    if missing:
        raise ValueError(f"actor {name}: fire() missing outputs {sorted(missing)}")
    state.actors[idx] = new_st
    offs = io[prog.io_yield + Y_OFF + MAX_STEP_PORTS:]
    for (p, fspec, fi), e, w, off in zip(network.out_port_specs[name], out_en, outw, offs):
        if not e:
            continue
        w.copy_(outs[p].reshape(w.shape))
        if fspec.delay and (off - fspec.delay) // fspec.rate == 2:
            tensors[fi][0].copy_(tensors[fi][3 * fspec.rate])


def _state_device(prog: DeviceProgram, state: NetworkState,
                  default: torch.device) -> torch.device:
    """Where the state's data rings live (the run's device)."""
    for i, f in enumerate(state.fifos):
        if i not in prog.ctrl_base:
            return f.buf.device
    return default


def compile_megakernel(network: Network, max_sweeps: int = 1_000_000,
                       multi_firing: bool = True,
                       layout: Optional[MegakernelLayout] = None,
                       partition: Optional[GridPartition] = None,
                       cores: int = 1, guards: bool = False,
                       trace_capacity: Optional[int] = None) -> Callable:
    """Compile ``network`` into the device program of B2.

    Returns ``runner(state) -> (state, fire_counts, sweeps, stalled)`` (a
    :class:`~repro_torch.core.executor.DynamicResult`), which updates
    ``state`` in place.  A state on the card is one kernel launch, staged
    in and out through one small block each way with one synchronisation
    at the end; a state on the CPU runs :mod:`.ref`.  ``guards`` runs the
    ``MK_GUARDS`` build (``.health`` on the result), ``trace_capacity``
    the ``MK_TRACE`` build with a ring of that many events (``.trace``).

    ``layout`` and ``partition`` default to :func:`lower_network` and the
    default ``cores``-way :func:`partition_layout`.  Entry rules of the
    reference: a forwarded channel (``partition.forwarded_fifos``) must
    enter drained, and starts the run from zeros.  ``cores > 1`` runs the
    partition's visit order in the one replicated scheduler, so states,
    cursors and counts equal ``cores=1`` and sweeps follow the reference.
    """
    if layout is None:
        layout = lower_network(network)
    if partition is None:
        partition = partition_layout(network, layout, cores)
    prog = build_device_program(network, layout, partition)
    if guards:
        body_written = [n for n, sp in network.fifos.items()
                        if sp.is_control and sp.domain is not None
                        and network.actors[network.edge_of(n).src_actor]
                        .device_op.kind in BODY_CTRL_KINDS]
        if body_written:
            raise NotImplementedError(
                f"megakernel guards: control channels {body_written} are "
                "written by bodies and declare a domain; the kernel checks "
                "the domain of scheduler-written control tokens only")
    health_words = guards or bool(trace_capacity)
    host_table = prog.table.tolist()
    on_device: Dict[torch.device, Tuple[torch.Tensor, List[torch.Tensor]]] = {}

    def device_operands(device: torch.device) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The table and the DeviceOps' tensors on ``device``, made once."""
        if device not in on_device:
            on_device[device] = (prog.table.to(device),
                                 [t.to(device) for _, t in prog.consts]
                                 + [torch.zeros(n, dtype=torch.float32, device=device)
                                    for _, n in prog.scratch])
        return on_device[device]

    def run(state: NetworkState, kernel: bool) -> DynamicResult:
        for fi in partition.forwarded_fifos:
            occ = state.fifos[fi].occ
            if occ:
                raise ValueError(
                    f"megakernel transient forwarding: fifo "
                    f"{layout.fifo_names[fi]!r} enters with occupancy "
                    f"{int(occ)}; forwarded channels must be drained "
                    "(start from Network.init_state, or compile with "
                    "ExecutionPlan(specialize=False) to keep every "
                    "ring in scratch)")
        device = _state_device(prog, state, network.device)
        table, consts = device_operands(device)
        tensors, io = stage(prog, state, device, consts, health_words)
        ring = None
        if kernel:
            ptrs = [0 if t is None else t.data_ptr() for t in tensors]
            host = torch.tensor(ptrs + io, dtype=torch.int64, pin_memory=True)
            args = host.to(device, non_blocking=True)
            if trace_capacity:
                ring = torch.zeros((trace_capacity, COL_OCC + prog.n_fifos),
                                   dtype=torch.int32, device=device)

            def segment() -> List[int]:
                """One launch of B2 (a fresh run, or a resume when the io
                words in ``args`` hold a pending step); its io words."""
                megakernel_cuda(table, args, prog.n_ptrs, max_sweeps, multi_firing,
                                io_len=prog.io_len, guards=guards, trace=ring,
                                n_actors=prog.n_actors,
                                scratch_words=int(prog.table[H_SCRATCH]),
                                moe=bool(prog.table[H_MOE]))
                return args[prog.n_ptrs:].cpu().tolist()
        else:
            if trace_capacity:
                ring = np.zeros((trace_capacity, COL_OCC + prog.n_fifos), np.int32)

            def segment() -> List[int]:
                run_program(host_table, tensors, io, max_sweeps,
                            multi_firing, guards=guards, trace_ring=ring)
                return io
        io = segment()
        while io[prog.io_yield + Y_PENDING]:
            run_step(network, prog, host_table, state, tensors, io)
            io = segment()
        counts, sweeps, stalled = unstage(prog, state, io)
        return DynamicResult(
            state, counts, sweeps, stalled,
            health_of(prog, io) if guards else None,
            TraceState(ring, int(io[prog.io_events])) if ring is not None else None)

    def runner(state: NetworkState) -> DynamicResult:
        return run(state, _state_device(prog, state, network.device).type == "cuda")

    def plain(state: NetworkState) -> DynamicResult:
        """The plain version on the state's device, whatever it is: the
        kernel's oracle on the card."""
        return run(state, False)

    runner.plain = plain
    runner.device_program = prog
    runner.grid_partition = partition
    runner.hoisted_const_bytes = sum(t.numel() * t.element_size()
                                     for _, t in prog.consts)
    return runner
