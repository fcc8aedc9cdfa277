"""The device program of the persistent scheduler kernel (B2).

The reference's megakernel traces every actor's Python functions into the
kernel (``_hoist_consts`` and ``_build_kernel``'s preamble in
``src/repro/core/megakernel/kernel.py``).  The port's kernel is one CUDA
function for every network, so :func:`build_device_program` turns a
``Network``, its :class:`MegakernelLayout` and its :class:`GridPartition`
into data that the kernel reads: one packed int32 table, the same for every
run of the compiled program.

* **Visit order**: the rows of ``partition.core_rows`` in partition order,
  as the reference traces them (``kernel.py:674``).
* **Per channel**: rate, Eq. 1 capacity, token size in bytes, write
  phases, blocking bound, whether it is a control channel, whether it is
  forwarded, its delay (a Fig. 2 triple buffer writes one slot further on
  and copies slot ``3r`` back to slot 0 after a phase-2 write), its
  element type and its declared domain (the guarded build checks every
  window of a data channel that declares one).  Rings are addressed as bytes, so one kernel moves float32
  (DPD) and uint8 (motion detection) tokens alike.
* **Per actor**: its :class:`~repro_torch.core.actor.DeviceOp` kind, its
  control, input and output channels, its ready limit, and for a dynamic
  actor its **declared enables** (``ActorSpec.enables``): per port the
  pair ``(word, threshold)`` for ``int(tok[word] > threshold)``, or
  ``(-1, v)`` for the constant ``v``, so the kernel computes the
  reference's rates for any control token and needs no scheduler code of
  its own per graph; the shape parameters of its body (Poly's ``L``, a
  frame's ``H`` and ``W``, Thres's threshold, the MoE layer's ``N``,
  ``D``, ``E``, ``C``, ``k`` and ``F``); and for a source or sink its
  **slab descriptor**: ``planes`` planes, each holding every window's
  ``window_bytes / planes`` bytes of that plane in a row (DPD's
  ``(2, k L)`` slab has 2 planes, motion detection's video 1).
* **Control tokens** are int32 vectors of any length (MoE's packed
  ``(2E,)`` token), kept in the io words.  Config actors write theirs as
  the scheduler decides; the MoE router and packer and the serving
  network's admission write theirs from their bodies, and the scheduler
  waits for that body before it peeks the token.  ``H_DOM`` marks a
  program with a data channel that declares a domain (the guarded build's
  DOMAIN tests run only then).  ``H_MOE`` marks a program with MoE,
  serving or step kinds, which the kernel runs in an instance of its own
  (the wide path, these waits, the serving bodies and the yield; the
  other instance has none of that code).
* **Scratch**: MoE bodies run in phases, each a command of its own, and
  hand results from one phase to the next through a float32 tensor per
  actor (the router's logits, an expert's hidden rows), made once per
  device; the router's routing lives in ``H_SCRATCH`` words of shared
  memory per block.

Per run the kernel also takes an int64 argument block (see
:class:`DeviceProgram`): the device addresses of the rings and actor
tensors, then the int32 values of the cursor block, the actor states' int
scalars, the control rings, the fire counts and the run's result words.

* **The serving network** (``graphs/serving.py``): admission, gate, merge
  and retire are device bodies.  Admission writes its control tokens from
  its body, as the MoE router does; its ints ``retired`` and ``t`` are its
  scalar slot's two words, its ``taken`` flags R words after the control
  rings, replicated in every block like the rest of the io words.
* **Step actors** (``DeviceOp("step")``: the serving network's decode, the
  LM stage network's stages) have no device body.  At an enabled firing
  the kernel does the firing's bookkeeping, saves its scheduler in the
  io's yield words with the firing's actor, enables and window offsets,
  and ends; the runner (``kernel.py``) runs the actor's ``fire`` on those
  windows and launches the kernel again, which goes on from the saved
  scheduler.  A rate-0 firing stays the kernel's own.
* **Element types**: float32, uint8 and int32 tokens everywhere; bf16 and
  f16 tokens on channels that only copy bodies (source, sink, fork, gate)
  and step actors touch (the guarded build tests them on their 16-bit
  patterns, and their domain bounds are rounded to their type).

Networks the kernel cannot run raise here.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.actor import eval_enable
from repro_torch.core.fifo import FifoSpec
from repro_torch.core.health import HealthState, int_domain
from repro_torch.core.megakernel.lower import GridPartition, MegakernelLayout
from repro_torch.core.network import Network
from repro_torch.kernels.dyn_fir.ref import N_TAPS

KIND_CODES = {"source": 0, "config": 1, "fork": 2, "poly": 3, "adder": 4,
              "sink": 5, "gauss": 6, "thres": 7, "med": 8, "router": 9,
              "expert": 10, "combine": 11, "packer": 12, "admission": 13,
              "gate": 14, "merge": 15, "retire": 16, "step": 17}

#: The kinds that take more than 32 ports a side (the scheduler's wide path).
WIDE_KINDS = ("router", "expert", "combine", "packer")
#: The serving network's device bodies (graphs/serving.py).
SERVING_KINDS = ("admission", "gate", "merge", "retire")
#: Kinds whose body writes control tokens (the scheduler waits for it).
BODY_CTRL_KINDS = ("router", "packer", "admission")
#: Kinds the kernel runs in its extended instance (``H_MOE``).
EXT_KINDS = WIDE_KINDS + SERVING_KINDS + ("step",)
#: Kinds that only copy bytes (or run no body): they may move bf16 and f16
#: tokens.
COPY_KINDS = ("source", "sink", "fork", "gate", "step")
#: Kernel commands one firing of each kind becomes; the phases of one
#: firing run in order, each after the last in every block.
PHASES = {"router": 2, "expert": 2}

#: Element types of a channel row.
ELEM_CODES = {torch.float32: 0, torch.uint8: 1, torch.int32: 2, torch.bfloat16: 3,
              torch.float16: 4}
#: The 16-bit float types, which only copy bodies and step actors touch.
HALF_DTYPES = (torch.bfloat16, torch.float16)

# ---- packed table layout (mirrored by csrc/megakernel.cu) --------------- #
HEADER = 16
H_N_FIFOS, H_N_ACTORS, H_N_VISIT, H_FIFO_OFF, H_ACTOR_OFF, H_VISIT_OFF, \
    H_N_APTRS, H_N_SCALARS, H_N_CTRL, H_LEN, H_SCRATCH, H_MOE, H_DOM = range(13)

FIFO_FIELDS = 13
(F_RATE, F_CAP, F_TOKB, F_NPH, F_BOUND, F_CTRL, F_FWD, F_CBASE, F_DELAY,
 F_ELEM, F_DLO, F_DHI, F_DOM) = range(13)

ACTOR_FIELDS = 20
(A_KIND, A_CTRL, A_IN, A_NIN, A_OUT, A_NOUT, A_READY, A_SCALAR, A_ORDER,
 A_ENABLES, A_N2, A_N3, A_PTR0, A_PTR1, A_AUX, A_NAUX, A_N0, A_N1, A_PLANES,
 A_FPARAM) = range(20)

#: Words at the end of the io block: sweeps, stall flag, error code, the
#: actor and token of the error, the grid size the kernel ran with, then
#: B2's clock split: the body threads' two words, the scheduler warp's, and
#: one per body kind from ``M_CLK_KIND`` (written only by the build with
#: ``-DMK_CLOCK_SPLIT``; ``kernel.decode_clock_split`` reads them).
META_WORDS = 17
(M_SWEEPS, M_STALLED, M_ERROR, M_ERR_ACTOR, M_ERR_VALUE, M_BLOCKS,
 M_CLK_STALL, M_CLK_LOOP, M_CLK_SCHED, M_CLK_KIND) = range(10)

#: Error code of the run: a source or sink index past its slab.
ERR_SLAB = 2

#: Yield words, after the fire counts: whether a step firing is pending
#: (the kernel ended at it and resumes from these words when launched
#: again), the scheduler's sweeps, visit position, firings left in the
#: visit, whether the sweep fired, commands emitted, then the step
#: firing's actor, enables (bit p: port p) and the first slot of each
#: input's and each output's window (``MAX_STEP_PORTS`` each).
MAX_STEP_PORTS = 8
(Y_PENDING, Y_SWEEPS, Y_VPOS, Y_LEFT, Y_FIRED, Y_SEQ, Y_ACTOR, Y_IN_EN,
 Y_OUT_EN, Y_OFF) = range(10)
YIELD_WORDS = Y_OFF + 2 * MAX_STEP_PORTS

#: Words after the meta words of a guarded or traced run: per channel its
#: fault word, then per channel its high-water mark, then the trace's event
#: count (``DeviceProgram.io_fault`` and on).  Only the ``MK_GUARDS`` and
#: ``MK_TRACE`` builds of B2 write them.

_UNSUPPORTED = ("the megakernel backend runs actors through the device "
                "functions they declare (ActorSpec.device_op): give each "
                "actor one, DeviceOp('step') for an actor whose own fire "
                "the runner calls between launches (a decode step, an LM "
                "stage)")

#: Words of routing state the router keeps in shared memory per block, at
#: most (``H_SCRATCH``).
MAX_SCRATCH_WORDS = 1 << 15


@dataclasses.dataclass(frozen=True)
class ActorSlots:
    """Where one actor's state meets the kernel: its int scalar slot, its
    tensor pointer slots, for a source or sink its slab's element type and
    window (planes, bytes per plane), and for admission where its taken
    flags sit among the replicated io words."""

    kind: str
    scalar: int = -1            # slot in the io scalar area, -1 for none
    ptrs: Tuple[int, ...] = ()  # slots in the pointer table (after rings)
    dtype: Any = None
    planes: int = 0
    plane_bytes: int = 0
    words: int = -1             # admission's taken flags: first word after io_ctrl


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceProgram:
    """A network packed for the kernel.

    ``table`` is the int32 program (CPU).  ``consts`` are the DeviceOps'
    closure tensors, each with its pointer slot; ``scratch`` the float32
    scratch tensors of MoE bodies, as ``(slot, elements)``; ``enables``
    each dynamic actor's declared forms.  The per-run block is
    ``[ring addresses (n_fifos) | actor tensor addresses (n_aptrs) | io]``
    with ``io = [cursors (3 n_fifos) | scalars (2 per slot: value, bound) |
    control rings and admission's taken flags (n_ctrl) | fire counts
    (n_actors) | yield (YIELD_WORDS) | meta (META_WORDS)]``.
    """

    table: torch.Tensor
    fifo_names: Tuple[str, ...]
    fifo_dtypes: Tuple[Any, ...]
    actor_names: Tuple[str, ...]
    slots: Tuple[ActorSlots, ...]
    consts: Tuple[Tuple[int, torch.Tensor], ...]
    ctrl_base: Dict[int, int]
    forwarded: frozenset
    n_aptrs: int
    n_scalars: int
    n_ctrl: int
    enables: Dict[str, Dict[str, Any]]
    scratch: Tuple[Tuple[int, int], ...] = ()

    @property
    def n_fifos(self) -> int:
        return len(self.fifo_names)

    @property
    def n_actors(self) -> int:
        return len(self.actor_names)

    # -- io block offsets (relative to the io block) ------------------- #
    @property
    def io_scalars(self) -> int:
        return 3 * self.n_fifos

    @property
    def io_ctrl(self) -> int:
        return self.io_scalars + 2 * self.n_scalars

    @property
    def io_counts(self) -> int:
        return self.io_ctrl + self.n_ctrl

    @property
    def io_yield(self) -> int:
        return self.io_counts + self.n_actors

    @property
    def io_meta(self) -> int:
        return self.io_yield + YIELD_WORDS

    @property
    def io_len(self) -> int:
        return self.io_meta + META_WORDS

    @property
    def io_fault(self) -> int:
        return self.io_len

    @property
    def io_high_water(self) -> int:
        return self.io_fault + self.n_fifos

    @property
    def io_events(self) -> int:
        return self.io_high_water + self.n_fifos

    @property
    def io_health_len(self) -> int:
        """The io block with the health and trace words."""
        return self.io_events + 1

    @property
    def n_ptrs(self) -> int:
        return self.n_fifos + self.n_aptrs

    def rates(self, actor: str, token: Sequence[int]) -> Dict[str, int]:
        """The 0/1 enables of ``actor`` for control token ``token`` (a list
        of ints), from its declared forms, as the kernel computes them."""
        return {p: eval_enable(f, token) for p, f in self.enables[actor].items()}


def fifo_row(spec: FifoSpec, forwarded: bool = False,
             ctrl_base: int = -1) -> List[int]:
    """A channel's row of the table: its ``FifoSpec`` in the kernel's
    terms."""
    row = [0] * FIFO_FIELDS
    row[F_RATE] = spec.rate
    row[F_CAP] = spec.capacity_tokens
    row[F_TOKB] = spec.token_size_bytes
    row[F_NPH] = spec.n_write_phases
    row[F_BOUND] = spec.writable_occupancy_bound
    row[F_CTRL] = int(spec.is_control)
    row[F_FWD] = int(forwarded)
    row[F_CBASE] = ctrl_base
    row[F_DELAY] = spec.delay
    row[F_ELEM] = ELEM_CODES[spec.dtype]
    if spec.is_control:
        # The declared domain as the guards compare control tokens with it.
        row[F_DLO], row[F_DHI] = int_domain(spec)
    elif spec.domain is not None:
        # A data channel's domain, each bound cast to the token type first
        # as the reference casts it: a float channel's bounds rounded to its
        # type (bf16 and f16 too) and packed as float32 bits, ints (clamped
        # to int32) for u8 and int32 ones.
        row[F_DOM] = 1
        if spec.dtype.is_floating_point:
            row[F_DLO], row[F_DHI] = torch.tensor(spec.domain, dtype=torch.float32).to(
                spec.dtype).float().view(torch.int32).tolist()
        else:
            row[F_DLO], row[F_DHI] = (min(max(x, -2 ** 31), 2 ** 31 - 1)
                                      for x in int_domain(spec))
    return row


def _check_channels(network: Network) -> None:
    """Element types the kernel moves: float32, uint8 or int32 data tokens,
    bf16 and f16 ones between copy bodies and step actors only, int32
    control tokens."""
    for name, spec in network.fifos.items():
        if spec.is_control:
            if spec.dtype != torch.int32:
                raise NotImplementedError(
                    f"megakernel: control channel {name!r} must carry int32 "
                    f"tokens, got {spec.dtype}")
        elif spec.dtype not in ELEM_CODES:
            raise NotImplementedError(
                f"megakernel: data channel {name!r} carries {spec.dtype}; the "
                "device functions take float32, uint8 and int32 tokens, and "
                "bf16 and f16 tokens between copy bodies and step actors")
        elif spec.dtype in HALF_DTYPES:
            edge = network.edge_of(name)
            kinds = {network.actors[a].device_op.kind
                     for a in (edge.src_actor, edge.dst_actor)}
            if not kinds <= set(COPY_KINDS):
                raise NotImplementedError(
                    f"megakernel: data channel {name!r} carries {spec.dtype} "
                    f"between {sorted(kinds)} actors; only copy bodies "
                    f"{COPY_KINDS} touch bf16 and f16 tokens")


#: Regular ports per side an actor may have (the kernel's enable masks):
#: a lane each in the scheduler warp, and up to 8 each on its wide path.
MAX_PORTS = 32
MAX_WIDE_PORTS = 256

_PORTS = {  # kind -> (inputs, outputs): exact counts, or None for >= 1
    "source": (0, 1), "config": (0, None), "fork": (1, None),
    "poly": (1, 1), "adder": (None, 1), "sink": (1, 0),
    "gauss": (1, None), "thres": (2, 1), "med": (1, 1),
    "router": (1, None), "expert": (1, 1), "combine": (None, 1),
    "packer": (None, 1), "admission": (1, None), "gate": (None, None),
    "merge": (2, 1), "retire": (1, 0), "step": (None, None)}


def _check_ports(network: Network, name: str, kind: str) -> None:
    a = network.actors[name]
    want_in, want_out = _PORTS[kind]
    most = {**{k: MAX_WIDE_PORTS for k in WIDE_KINDS},
            "step": MAX_STEP_PORTS}.get(kind, MAX_PORTS)
    least = 0 if kind == "step" else 1
    for want, have, what in ((want_in, len(a.in_ports), "inputs"),
                             (want_out, len(a.out_ports), "outputs")):
        if ((want is None and not least <= have <= most)
                or (want is not None and have != want)):
            raise ValueError(
                f"megakernel: {kind} actor {name!r} has {have} {what}, its "
                f"device function takes "
                f"{f'{least}..{most}' if want is None else want}")
    if kind == "step" and any(sp.is_control for _, sp, _ in network.in_port_specs[name]):
        raise ValueError(f"megakernel: step actor {name!r} reads a control "
                         "channel on a regular port; its windows are data")
    if kind == "gate" and len(a.in_ports) != len(a.out_ports):
        raise ValueError(f"megakernel: gate actor {name!r} copies input k to "
                         "output k; give it as many outputs as inputs")
    if kind in BODY_CTRL_KINDS:
        return          # _check_moe / _check_serving check which ports are control
    for p, spec, _ in network.out_port_specs[name]:
        if spec.is_control != (kind == "config"):
            raise ValueError(
                f"megakernel: {kind} actor {name!r} port {p!r}: only config "
                "actors, the MoE router and packer and the serving network's "
                "admission write control channels, and config actors write "
                "nothing else")
        if spec.is_control and spec.token_size_bytes != 4:
            raise ValueError(f"megakernel: config actor {name!r} port {p!r} "
                             "writes one-word control tokens only")


def _check_moe(network: Network, name: str, kind: str,
               op_params: Dict[str, Any]) -> Tuple[int, ...]:
    """The MoE kinds' channels against their parameters; returns ``(N, D,
    E, C, k, F)`` (0 where the kind has none)."""
    p = {k: int(op_params[k]) for k in ("N", "k", "C", "E", "D", "F")
         if k in op_params}
    N, k, C, E, D, F = (p.get(x, 0) for x in ("N", "k", "C", "E", "D", "F"))
    ins = [s for _, s, _ in network.in_port_specs[name]]
    outs = [s for _, s, _ in network.out_port_specs[name]]
    ctl = network.control_specs[name]
    f32, i32 = torch.float32, torch.int32

    def want(spec: FifoSpec, shape, dtype, control=False) -> bool:
        return (spec.rate == 1 and tuple(spec.token_shape) == tuple(shape)
                and spec.dtype == dtype and spec.is_control == control
                and not spec.delay)
    if kind == "router":
        ok = (len(ins) == 1 and want(ins[0], (N, D), f32) and len(outs) == 3 * E + 2
              and all(want(s, (C, D), f32) for s in outs[:E])
              and all(want(s, (1,), i32, True) for s in outs[E:2 * E])
              and want(outs[2 * E], (N, k), i32) and want(outs[2 * E + 1], (N, k), f32)
              and all(want(s, (1,), i32) for s in outs[2 * E + 2:]))
    elif kind == "expert":
        ok = (want(ins[0], (C, D), f32) and want(outs[0], (C, D), f32)
              and ctl is not None and ctl[0].token_size_bytes == 4)
    elif kind == "combine":
        ok = (len(ins) == E + 2 and all(want(s, (C, D), f32) for s in ins[:E])
              and want(ins[E], (N, k), i32) and want(ins[E + 1], (N, k), f32)
              and want(outs[0], (N, D), f32)
              and ctl is not None and ctl[0].token_size_bytes >= 4 * E)
    else:
        ok = (len(ins) == E and all(want(s, (1,), i32) for s in ins)
              and want(outs[0], (2 * E,), i32, True))
    if not ok:
        raise ValueError(
            f"megakernel: {kind} actor {name!r} has channels that do not fit "
            f"its parameters {p}: the reference's MoE layout "
            "(graphs/moe_as_actors.py) with rate-1, delay-free channels")
    return N, D, E, C, k, F


def _check_tokens(network: Network, name: str, kind: str) -> Tuple[int, int]:
    """The data channels a body reads and writes must carry what its device
    function computes on; returns the body's shape parameters ``(n0, n1)``:
    Poly's ``(L, 0)``, a frame's ``(H, W)``, else ``(0, 0)``."""
    specs = ([s for _, s, _ in network.in_port_specs[name]]
             + [s for _, s, _ in network.out_port_specs[name] if not s.is_control])
    if (not specs or kind in ("source", "sink", "step") or kind in WIDE_KINDS
            or kind in ("admission", "merge", "retire")):
        return 0, 0
    first = specs[0]
    want = {"poly": "rate-1 (2, L) float32", "adder": "float32",
            "gauss": "(H, W) uint8", "thres": "(H, W) uint8",
            "med": "(H, W) uint8", "fork": None, "gate": None}[kind]
    shape = tuple(first.token_shape)
    ok = all((s.rate, tuple(s.token_shape), s.dtype)
             == (first.rate, shape, first.dtype) for s in specs)
    if kind == "poly":
        ok = ok and first.rate == 1 and len(shape) == 2 and shape[0] == 2
    elif kind == "adder":
        ok = ok and first.dtype == torch.float32
    elif kind in ("gauss", "thres", "med"):
        ok = ok and first.dtype == torch.uint8 and len(shape) == 2
    if not ok:
        raise ValueError(
            f"megakernel: {kind} actor {name!r} reads and writes channels of "
            f"one rate, token shape and type"
            + (f", {want}" if want else "") + "; got "
            + ", ".join(f"{s.name}: rate {s.rate} {s.dtype} "
                        f"{tuple(s.token_shape)}" for s in specs))
    if kind == "poly":
        return shape[1], 0
    if kind in ("gauss", "med"):
        return shape
    return 0, 0


#: The slot table's header columns (graphs/serving.py's HEADER).
SLOT_HEADER = 12


def _check_serving(network: Network, name: str, kind: str,
                   op_params: Dict[str, Any]) -> Dict[int, int]:
    """The serving kinds' channels against their parameters (the slot table
    (B, HEADER + P + N) int32 of ``graphs/serving.py``); returns the actor
    row's fields: ``A_N0`` P, ``A_N1`` N, ``A_N2`` B, ``A_N3`` R, and
    ``A_ORDER`` admission's queue depth or merge's EOS id."""
    p = {k: int(op_params[k]) for k in ("B", "P", "N", "R", "qd", "eos")
         if k in op_params}
    ins = [s for _, s, _ in network.in_port_specs[name]]
    outs = [s for _, s, _ in network.out_port_specs[name]]
    i32 = torch.int32

    def table(spec: FifoSpec) -> Tuple[int, int]:
        shape = tuple(spec.token_shape)
        ok = (spec.rate == 1 and spec.dtype == i32 and not spec.is_control
              and len(shape) == 2 and shape[1] > SLOT_HEADER)
        return shape if ok else (0, 0)
    B, W = table(ins[0])
    ok = B > 0 and all(table(s) == (B, W) for s in ins[:1] + outs[:3]
                       if not s.is_control)
    P, N = p.get("P", 0), p.get("N", 0)
    ok = ok and P >= 0 and N >= 1 and W == SLOT_HEADER + P + N
    fields = {A_N0: P, A_N1: N, A_N2: B}
    if kind == "admission":
        R, qd = p.get("R", 0), p.get("qd", -1)
        ok = (ok and p.get("B") == B and R >= 1 and qd >= 0 and len(outs) >= 4
              and not any(s.is_control for s in outs[:3])
              and all(s.is_control and s.rate == 1 and tuple(s.token_shape) == (3,)
                      for s in outs[3:]))
        for key, shape in (("prompts", (R, P)), ("budgets", (R,)),
                           ("arrivals", (R,)), ("deadlines", (R,))):
            t = op_params.get(key)
            ok = ok and (isinstance(t, torch.Tensor) and t.dtype == i32
                         and tuple(t.shape) == shape)
        fields.update({A_N3: R, A_ORDER: qd})
    elif kind == "merge":
        ok = (ok and ins[1].rate == 1 and ins[1].dtype == i32
              and tuple(ins[1].token_shape) == (B,) and "eos" in p)
        fields[A_ORDER] = p.get("eos", 0)
    else:
        R = p.get("R", 0)
        ok = ok and R >= 1
        fields[A_N3] = R
    if not ok:
        raise ValueError(
            f"megakernel: {kind} actor {name!r} has channels or parameters "
            f"{p} that do not fit graphs/serving.py's layout: rate-1 (B, "
            f"{SLOT_HEADER} + P + N) int32 slot tables, decoded tokens (B,) "
            "int32, admission's control tokens of 3 int32 words")
    return fields


def _float_bits(x: float) -> int:
    """The float32 bit pattern of ``x`` as a signed int32 table word."""
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def build_device_program(network: Network, layout: MegakernelLayout,
                         partition: GridPartition) -> DeviceProgram:
    """Pack ``network`` for the kernel; raises for what it cannot run."""
    missing = [n for n, a in network.actors.items() if a.device_op is None]
    if missing:
        raise NotImplementedError(
            f"megakernel: actors {missing} declare no DeviceOp; "
            + _UNSUPPORTED)
    undeclared = [n for n, a in network.actors.items()
                  if a.is_dynamic and a.enables is None]
    if undeclared:
        raise NotImplementedError(
            f"megakernel: dynamic actors {undeclared} declare no enable forms "
            "(ActorSpec.enables); the kernel computes rates from them")
    _check_channels(network)
    fifo_names = layout.fifo_names
    n_fifos = len(fifo_names)
    actor_names = tuple(network.actors)
    n_actors = len(actor_names)
    visit = tuple(i for rows in partition.core_rows for i in rows)
    forwarded = frozenset(partition.forwarded_fifos)

    ctrl_base: Dict[int, int] = {}   # control ring -> its io words
    n_ctrl = 0
    for i, spec in enumerate(layout.fifo_specs):
        if spec.is_control:
            ctrl_base[i] = n_ctrl
            n_ctrl += spec.capacity_tokens * spec.token_size_bytes // 4

    fifo_rows: List[int] = []
    for i, spec in enumerate(layout.fifo_specs):
        fifo_rows += fifo_row(spec, forwarded=i in forwarded,
                              ctrl_base=ctrl_base.get(i, -1))

    # Variable-length lists (ports, rate tables, adder terms) follow the
    # fixed tables; actor rows point at them by absolute offset.
    fifo_off = HEADER
    actor_off = fifo_off + FIFO_FIELDS * n_fifos
    visit_off = actor_off + ACTOR_FIELDS * n_actors
    tail: List[int] = []
    tail_off = visit_off + len(visit)

    def put(values: Sequence[int]) -> int:
        off = tail_off + len(tail)
        tail.extend(int(v) for v in values)
        return off

    actor_rows: List[int] = []
    slots: List[ActorSlots] = []
    consts: List[Tuple[int, torch.Tensor]] = []
    scratch: List[Tuple[int, int]] = []
    enables: Dict[str, Dict[str, Any]] = {}
    n_aptrs = n_scalars = 0
    scratch_words = moe = 0
    for row in layout.firing_table:
        a = network.actors[row.name]
        op = a.device_op
        kind = op.kind
        _check_ports(network, row.name, kind)
        r = [0] * ACTOR_FIELDS
        r[A_KIND] = KIND_CODES[kind]
        r[A_CTRL] = -1 if row.control is None else row.control
        r[A_IN] = put([pb.fifo for pb in row.inputs])
        r[A_NIN] = len(row.inputs)
        r[A_OUT] = put([pb.fifo for pb in row.outputs])
        r[A_NOUT] = len(row.outputs)
        r[A_READY] = -1
        r[A_SCALAR] = r[A_PTR0] = r[A_PTR1] = r[A_ENABLES] = r[A_AUX] = -1
        r[A_N0], r[A_N1] = _check_tokens(network, row.name, kind)
        if kind in ("source", "config") and a.ready is not None:
            r[A_READY] = int(op.params["n_firings"])
        ptrs: Tuple[int, ...] = ()
        scalar = -1
        window: Dict[str, Any] = {}
        if kind in ("source", "config", "sink", "admission"):
            scalar = n_scalars
            n_scalars += 1
        if kind in ("source", "sink"):
            spec = layout.fifo_specs[(row.outputs if kind == "source"
                                      else row.inputs)[0].fifo]
            planes = int(op.params.get("planes", 1))
            win_bytes = spec.rate * spec.token_size_bytes
            if planes < 1 or win_bytes % planes:
                raise ValueError(
                    f"megakernel: {kind} {row.name!r} declares planes="
                    f"{planes}, which does not divide its {win_bytes}-byte "
                    f"window on {spec.name!r}")
            r[A_PLANES] = planes
            r[A_N0] = win_bytes // planes
            window = dict(dtype=spec.dtype, planes=planes,
                          plane_bytes=win_bytes // planes)
            ptrs = (n_aptrs,)
        elif kind == "poly":
            order = int(op.params["order"])
            if not 1 <= order <= N_TAPS:
                raise ValueError(f"megakernel: poly {row.name!r} order "
                                 f"{order} is outside 1..{N_TAPS}")
            r[A_ORDER] = order
            ptrs = (n_aptrs, n_aptrs + 1)
        elif kind == "config":
            sched = op.params["schedule"]
            if sched.dtype != torch.int32 or sched.dim() != 1 or not sched.numel():
                raise ValueError(f"megakernel: config {row.name!r} schedule "
                                 "must be a non-empty 1-D int32 tensor")
            ptrs = (n_aptrs,)
            consts.append((n_aptrs, sched.contiguous()))
            r[A_AUX] = sched.numel()
        elif kind == "adder":
            terms = list(op.params["terms"])
            if sorted(terms) != sorted(a.in_ports):
                raise ValueError(f"megakernel: adder {row.name!r} terms "
                                 f"{terms} are not a permutation of its "
                                 f"inputs {list(a.in_ports)}")
            r[A_AUX] = put([list(a.in_ports).index(p) for p in terms])
            r[A_NAUX] = len(terms)
        elif kind == "thres":
            r[A_FPARAM] = _float_bits(op.params["threshold"])
        elif kind in WIDE_KINDS:
            N, D, E, C, k, F = _check_moe(network, row.name, kind, op.params)
            r[A_N0], r[A_N1], r[A_N2], r[A_N3] = N, D, E, C
            r[A_ORDER], r[A_AUX] = k, F
            if kind == "expert":
                r[A_N0] = C
            weights = {"router": [("router", (D, E))],
                       "expert": [("we_gate", (D, F)), ("we_up", (D, F)),
                                  ("we_down", (F, D))]}.get(kind, [])
            for j, (key, shape) in enumerate(weights):
                w = op.params[key]
                if w.dtype != torch.bfloat16 or tuple(w.shape) != shape:
                    raise ValueError(f"megakernel: {kind} {row.name!r} weight "
                                     f"{key!r} must be bf16 {shape}, got "
                                     f"{w.dtype} {tuple(w.shape)}")
                consts.append((n_aptrs + j, w.contiguous()))
            n_scr = {"router": N * E, "expert": C * F}.get(kind)
            if n_scr is not None:
                scratch.append((n_aptrs + len(weights), n_scr))
                ptrs = tuple(range(n_aptrs, n_aptrs + len(weights) + 1))
            if kind == "router":
                scratch_words = max(scratch_words, router_scratch_words(N, E, C, k))
            moe = 1
        elif kind in ("admission", "merge", "retire"):
            for field, value in _check_serving(network, row.name, kind,
                                               op.params).items():
                r[field] = value
            if kind == "admission":
                # Ready while fewer than R requests retired; the taken flags
                # follow the control rings; the body ranks slots in shared
                # memory (the j-th admitted and the j-th shed request).
                r[A_READY] = r[A_N3]
                r[A_AUX] = window["words"] = n_ctrl
                n_ctrl += r[A_N3]
                ptrs = tuple(range(n_aptrs, n_aptrs + 4))
                for j, key in enumerate(("prompts", "budgets", "arrivals",
                                         "deadlines")):
                    consts.append((n_aptrs + j, op.params[key].contiguous()))
                scratch_words = max(scratch_words, 2 * r[A_N2])
            elif kind == "retire":
                ptrs = tuple(range(n_aptrs, n_aptrs + 5))   # its state tensors
        if kind in EXT_KINDS:
            moe = 1
        n_aptrs += len(ptrs)
        r[A_SCALAR] = scalar
        if ptrs:
            r[A_PTR0] = ptrs[0]
        if len(ptrs) > 1:
            r[A_PTR1] = ptrs[1]
        if a.is_dynamic:
            ports = (*a.in_ports, *a.out_ports)
            forms = dict(a.enables)
            words = layout.fifo_specs[row.control].token_size_bytes // 4
            for p, f in forms.items():
                if isinstance(f, tuple) and not 0 <= f[0] < words:
                    raise ValueError(
                        f"megakernel: actor {row.name!r} port {p!r} enables on "
                        f"word {f[0]} of a {words}-word control token")
            enables[row.name] = forms
            r[A_ENABLES] = put([x for p in ports for x in
                                (forms[p] if isinstance(forms[p], tuple)
                                 else (-1, forms[p]))])
        slots.append(ActorSlots(kind=kind, scalar=scalar, ptrs=ptrs, **window))
        actor_rows += r

    total = tail_off + len(tail)
    header = [0] * HEADER
    header[H_N_FIFOS] = n_fifos
    header[H_N_ACTORS] = n_actors
    header[H_N_VISIT] = len(visit)
    header[H_FIFO_OFF] = fifo_off
    header[H_ACTOR_OFF] = actor_off
    header[H_VISIT_OFF] = visit_off
    header[H_N_APTRS] = n_aptrs
    header[H_N_SCALARS] = n_scalars
    header[H_N_CTRL] = n_ctrl
    header[H_LEN] = total
    if scratch_words > MAX_SCRATCH_WORDS:
        raise ValueError(
            f"megakernel: the router's routing takes {scratch_words} words of "
            f"shared memory a block, more than {MAX_SCRATCH_WORDS}; cut the "
            "tokens a firing or the experts")
    header[H_SCRATCH] = scratch_words
    header[H_MOE] = moe
    header[H_DOM] = int(any(fifo_rows[FIFO_FIELDS * i + F_DOM] for i in range(n_fifos)))
    packed = header + fifo_rows + actor_rows + list(visit) + tail
    assert len(packed) == total
    return DeviceProgram(
        table=torch.tensor(packed, dtype=torch.int32),
        fifo_names=fifo_names,
        fifo_dtypes=tuple(s.dtype for s in layout.fifo_specs),
        actor_names=actor_names,
        slots=tuple(slots), consts=tuple(consts), ctrl_base=ctrl_base,
        forwarded=forwarded, n_aptrs=n_aptrs, n_scalars=n_scalars,
        n_ctrl=n_ctrl, enables=enables, scratch=tuple(scratch))


def router_scratch_words(N: int, E: int, C: int, k: int) -> int:
    """Shared-memory words of the router's routing: each assignment's
    expert, weight and slot (``N k`` each), the token each expert slot
    takes (``E C``), and the counts (``E``)."""
    return 3 * N * k + E * C + E


# --------------------------------------------------------------------------- #
# Staging: NetworkState <-> (tensors, io words), shared by kernel and ref.
# --------------------------------------------------------------------------- #
def _slab(t: Any, name: str, sl: ActorSlots, device: torch.device) -> int:
    """Check a source's or sink's slab; returns its window count."""
    window = sl.planes * sl.plane_bytes
    if (not isinstance(t, torch.Tensor) or t.dtype != sl.dtype
            or not t.is_contiguous() or t.device != device
            or t.numel() * t.element_size() % window
            or (sl.planes > 1 and t.shape[0] != sl.planes)):
        raise ValueError(
            f"megakernel: actor {name!r} state must hold a contiguous "
            f"{sl.dtype} slab on {device} of {sl.planes} plane(s) of "
            f"{sl.plane_bytes}-byte windows")
    return t.numel() * t.element_size() // window


def stage(prog: DeviceProgram, state: Any, device: torch.device,
          consts: Sequence[torch.Tensor], health_words: bool = False
          ) -> Tuple[List[Optional[torch.Tensor]], List[int]]:
    """The tensors the kernel addresses (ring per channel, None for control
    rings, then each actor pointer slot: ``consts`` holds the DeviceOps'
    tensors, then the scratch tensors) and the io words of ``state``,
    with the zeroed health and trace words after the meta words when
    ``health_words``.  Cursors are staged as they are, consistent or not:
    the guards must see an injected fault.

    Forwarded control rings enter as zeros (the dead-slot rule); forwarded
    data rings are zeroed by the kernel itself.
    """
    tensors: List[Optional[torch.Tensor]] = []
    io = [0] * (prog.io_health_len if health_words else prog.io_len)
    for i, f in enumerate(state.fifos):
        io[3 * i:3 * i + 3] = [int(f.rd), int(f.wr), int(f.occ)]
        if i in prog.ctrl_base:
            tensors.append(None)
            if i not in prog.forwarded:
                base = prog.io_ctrl + prog.ctrl_base[i]
                vals = f.buf.reshape(-1).tolist()
                io[base:base + len(vals)] = vals
            continue
        buf = f.buf
        want = prog.fifo_dtypes[i]
        if buf.device != device or not buf.is_contiguous() or buf.dtype != want:
            raise ValueError(f"megakernel: ring {prog.fifo_names[i]!r} must be "
                             f"a contiguous {want} tensor on {device}")
        tensors.append(buf)
    aptr: List[Optional[torch.Tensor]] = [None] * prog.n_aptrs
    slots = [s for s, _ in prog.consts] + [s for s, _ in prog.scratch]
    for slot, t in zip(slots, consts):
        aptr[slot] = t
    for name, sl, st in zip(prog.actor_names, prog.slots, state.actors):
        if sl.kind in ("source", "sink"):
            slab, idx = st
            io[prog.io_scalars + 2 * sl.scalar + 1] = _slab(slab, name, sl, device)
            io[prog.io_scalars + 2 * sl.scalar] = int(idx)
            aptr[sl.ptrs[0]] = slab
        elif sl.kind == "config":
            io[prog.io_scalars + 2 * sl.scalar] = int(st)
        elif sl.kind == "admission":
            taken, t, retired = st
            io[prog.io_scalars + 2 * sl.scalar] = int(retired)
            io[prog.io_scalars + 2 * sl.scalar + 1] = int(t)
            words = [int(x) for x in taken.tolist()]
            io[prog.io_ctrl + sl.words:prog.io_ctrl + sl.words + len(words)] = words
        elif sl.kind == "retire":
            for t, slot in zip(st, sl.ptrs):
                if (t.dtype != torch.int32 or not t.is_contiguous()
                        or t.device != device):
                    raise ValueError(f"megakernel: retire {name!r} state must be "
                                     f"contiguous int32 tensors on {device}")
                aptr[slot] = t
        elif sl.kind == "poly":
            hist, taps = st
            for t, n, slot in ((hist, N_TAPS - 1, sl.ptrs[0]),
                               (taps, N_TAPS, sl.ptrs[1])):
                if (t.dtype != torch.float32 or tuple(t.shape) != (2, n)
                        or not t.is_contiguous() or t.device != device):
                    raise ValueError(f"megakernel: poly {name!r} state must "
                                     f"be contiguous float32 (2, 9) and "
                                     f"(2, 10) tensors on {device}")
                aptr[slot] = t
    return tensors + aptr, io


def unstage(prog: DeviceProgram, state: Any, io: Sequence[int]
            ) -> Tuple[Dict[str, int], int, bool]:
    """Write the run's io words back into ``state`` (cursors, scalars,
    control rings in host memory); returns ``(fire_counts, sweeps,
    stalled)``.  Raises on an error the run reported."""
    meta = prog.io_meta
    if int(io[meta + M_ERROR]):
        actor = prog.actor_names[int(io[meta + M_ERR_ACTOR])]
        value = int(io[meta + M_ERR_VALUE])
        raise ValueError(f"megakernel: actor {actor!r} fired with index "
                         f"{value}, past the end of its slab")
    ctrl = torch.tensor(list(io[prog.io_ctrl:prog.io_counts]), dtype=torch.int32)
    for i, f in enumerate(state.fifos):
        f.rd, f.wr, f.occ = (int(x) for x in io[3 * i:3 * i + 3])
        if i in prog.ctrl_base:
            base, n = prog.ctrl_base[i], f.buf.numel()
            f.buf.copy_(ctrl[base:base + n].reshape(f.buf.shape))
    for j, sl in enumerate(prog.slots):
        if sl.scalar < 0:
            continue
        idx = int(io[prog.io_scalars + 2 * sl.scalar])
        st = state.actors[j]
        if sl.kind == "admission":
            base = prog.io_ctrl + sl.words
            taken = torch.tensor(list(io[base:base + st[0].numel()]), dtype=torch.int32,
                                 device=st[0].device)
            state.actors[j] = (taken, int(io[prog.io_scalars + 2 * sl.scalar + 1]), idx)
        else:
            state.actors[j] = idx if sl.kind == "config" else (st[0], idx)
    counts = {n: int(io[prog.io_counts + j])
              for j, n in enumerate(prog.actor_names)}
    return counts, int(io[meta + M_SWEEPS]), bool(io[meta + M_STALLED])


def health_of(prog: DeviceProgram, io: Sequence[int]) -> HealthState:
    """The fault words and high-water marks a guarded run left in ``io``."""
    n = prog.n_fifos
    return HealthState(n, fault=[int(x) for x in io[prog.io_fault:prog.io_fault + n]],
                       high_water=[int(x) for x in
                                   io[prog.io_high_water:prog.io_high_water + n]])
