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
* **Per channel**: rate, Eq. 1 capacity, token size, write phases, blocking
  bound, whether it is a control channel and whether it is forwarded.
* **Per actor**: its :class:`~repro_torch.core.actor.DeviceOp` kind, its
  control, input and output channels, its ready limit, and for a dynamic
  actor a **rate table**: ``control`` evaluated over every token of its
  control channel's declared ``domain`` (the evaluation NetworkBuilder's
  matched-rates proof uses), so the kernel looks rates up by token and needs
  no scheduler code of its own per graph.

Per run the kernel also takes an int64 argument block (see
:class:`DeviceProgram`): the device addresses of the rings and actor
tensors, then the int32 values of the cursor block, the actor states' int
scalars, the control rings, the fire counts and the run's result words.

Networks the kernel cannot run raise here, naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.builder import domain_values
from repro_torch.core.megakernel.lower import GridPartition, MegakernelLayout
from repro_torch.core.network import Network
from repro_torch.kernels.dyn_fir.ref import N_TAPS

KIND_CODES = {"source": 0, "config": 1, "fork": 2, "poly": 3, "adder": 4,
              "sink": 5}

# ---- packed table layout (mirrored by csrc/megakernel.cu) --------------- #
HEADER = 16
H_N_FIFOS, H_N_ACTORS, H_N_VISIT, H_FIFO_OFF, H_ACTOR_OFF, H_VISIT_OFF, \
    H_N_APTRS, H_N_SCALARS, H_N_CTRL, H_L, H_LEN = range(11)

FIFO_FIELDS = 8
F_RATE, F_CAP, F_TOKN, F_NPH, F_BOUND, F_CTRL, F_FWD, F_CBASE = range(8)

ACTOR_FIELDS = 16
(A_KIND, A_CTRL, A_IN, A_NIN, A_OUT, A_NOUT, A_READY, A_SCALAR, A_ORDER,
 A_RATES, A_DLO, A_DHI, A_PTR0, A_PTR1, A_AUX, A_NAUX) = range(16)

#: Words at the end of the io block: sweeps, stall flag, error code, the
#: actor and token of the error, the grid size the kernel ran with.
META_WORDS = 8
M_SWEEPS, M_STALLED, M_ERROR, M_ERR_ACTOR, M_ERR_VALUE, M_BLOCKS = range(6)

#: Error codes of the run: a control token outside its channel's declared
#: domain; a source or sink index past its slab.
ERR_DOMAIN, ERR_SLAB = 1, 2

_UNSUPPORTED = ("the megakernel backend runs actors through the device "
                "functions they declare (ActorSpec.device_op); motion "
                "detection's actors get theirs with ROADMAP A6, MoE's with "
                "ROADMAP A8")


@dataclasses.dataclass(frozen=True)
class ActorSlots:
    """Where one actor's state meets the kernel: its int scalar slot, its
    tensor pointer slots, and the state's layout."""

    kind: str
    scalar: int = -1            # slot in the io scalar area, -1 for none
    ptrs: Tuple[int, ...] = ()  # slots in the pointer table (after rings)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceProgram:
    """A network packed for the kernel.

    ``table`` is the int32 program (CPU).  ``consts`` are the DeviceOps'
    closure tensors, each with its pointer slot.  The per-run block is
    ``[ring addresses (n_fifos) | actor tensor addresses (n_aptrs) | io]``
    with ``io = [cursors (3 n_fifos) | scalars (2 per slot: value, bound) |
    control rings (n_ctrl) | fire counts (n_actors) | meta (META_WORDS)]``.
    """

    table: torch.Tensor
    fifo_names: Tuple[str, ...]
    actor_names: Tuple[str, ...]
    slots: Tuple[ActorSlots, ...]
    consts: Tuple[Tuple[int, torch.Tensor], ...]
    ctrl_base: Dict[int, int]
    forwarded: frozenset
    n_aptrs: int
    n_scalars: int
    n_ctrl: int
    L: int
    rate_tables: Dict[str, Dict[int, Dict[str, int]]]
    domains: Dict[str, Tuple[int, int]]

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
    def io_meta(self) -> int:
        return self.io_counts + self.n_actors

    @property
    def io_len(self) -> int:
        return self.io_meta + META_WORDS

    @property
    def n_ptrs(self) -> int:
        return self.n_fifos + self.n_aptrs

    def rates(self, actor: str, token: int) -> Dict[str, int]:
        """The 0/1 enables of ``actor`` for control token ``token``, looked
        up in its rate table; a token outside the declared domain raises."""
        table = self.rate_tables[actor]
        if token not in table:
            lo, hi = self.domains[actor]
            raise ValueError(domain_error(actor, token, lo, hi))
        return dict(table[token])


def domain_error(actor: str, token: int, lo: int, hi: int) -> str:
    return (f"megakernel: actor {actor!r} peeked control token {token}, "
            f"outside its control channel's declared domain [{lo}, {hi}]; "
            "the device program tabulates rates over the domain only — "
            "declare a domain that covers every token")


def _check_channels(network: Network) -> int:
    """Channel shapes the device functions take; returns the window
    length ``L`` of the ``(2, L)`` float32 data tokens."""
    L = None
    for name, spec in network.fifos.items():
        if spec.delay:
            raise NotImplementedError(
                f"megakernel: channel {name!r} carries a delay token; the "
                "Fig. 2 copy-back in the kernel comes with ROADMAP A6 "
                "(motion detection)")
        if spec.is_control:
            if spec.dtype != torch.int32 or tuple(spec.token_shape) != (1,):
                raise NotImplementedError(
                    f"megakernel: control channel {name!r} must carry (1,) "
                    f"int32 tokens, got {spec.dtype} {spec.token_shape}")
            continue
        shape = tuple(spec.token_shape)
        if (spec.dtype != torch.float32 or spec.rate != 1 or len(shape) != 2
                or shape[0] != 2 or (L is not None and shape[1] != L)):
            raise NotImplementedError(
                f"megakernel: data channel {name!r} must carry rate-1 "
                f"(2, L) float32 tokens with one L for the whole network, "
                f"got rate {spec.rate} {spec.dtype} {shape}")
        L = shape[1]
    return L if L is not None else 0


#: Regular ports per side an actor may have (the kernel's enable masks).
MAX_PORTS = 32

_PORTS = {  # kind -> (inputs, outputs): exact counts, or None for >= 1
    "source": (0, 1), "config": (0, None), "fork": (1, None),
    "poly": (1, 1), "adder": (None, 1), "sink": (1, 0)}


def _check_ports(network: Network, name: str, kind: str) -> None:
    a = network.actors[name]
    want_in, want_out = _PORTS[kind]
    for want, have, what in ((want_in, len(a.in_ports), "inputs"),
                             (want_out, len(a.out_ports), "outputs")):
        if ((want is None and not 1 <= have <= MAX_PORTS)
                or (want is not None and have != want)):
            raise ValueError(
                f"megakernel: {kind} actor {name!r} has {have} {what}, its "
                f"device function takes "
                f"{f'1..{MAX_PORTS}' if want is None else want}")
    for p, spec, _ in network.out_port_specs[name]:
        if spec.is_control != (kind == "config"):
            raise ValueError(
                f"megakernel: {kind} actor {name!r} port {p!r}: only config "
                "actors write control channels, and they write nothing else")


def build_device_program(network: Network, layout: MegakernelLayout,
                         partition: GridPartition) -> DeviceProgram:
    """Pack ``network`` for the kernel; raises for what it cannot run."""
    missing = [n for n, a in network.actors.items() if a.device_op is None]
    if missing:
        raise NotImplementedError(
            f"megakernel: actors {missing} declare no DeviceOp; "
            + _UNSUPPORTED)
    L = _check_channels(network)
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
            n_ctrl += spec.capacity_tokens

    fifo_rows: List[int] = []
    for i, spec in enumerate(layout.fifo_specs):
        tokn = 1
        for d in spec.token_shape:
            tokn *= int(d)
        fifo_rows += [spec.rate, spec.capacity_tokens, tokn,
                      spec.n_write_phases, spec.writable_occupancy_bound,
                      int(spec.is_control), int(i in forwarded),
                      ctrl_base.get(i, -1)]

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
    rate_tables: Dict[str, Dict[int, Dict[str, int]]] = {}
    domains: Dict[str, Tuple[int, int]] = {}
    n_aptrs = n_scalars = 0
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
        r[A_SCALAR] = r[A_PTR0] = r[A_PTR1] = r[A_RATES] = r[A_AUX] = -1
        if kind in ("source", "config") and a.ready is not None:
            r[A_READY] = int(op.params["n_firings"])
        ptrs: Tuple[int, ...] = ()
        scalar = -1
        if kind in ("source", "config", "sink"):
            scalar = n_scalars
            n_scalars += 1
        if kind in ("source", "sink"):
            if int(op.params["L"]) != L:
                raise ValueError(f"megakernel: {kind} {row.name!r} declares "
                                 f"L={op.params['L']}, its channels carry {L}")
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
        n_aptrs += len(ptrs)
        r[A_SCALAR] = scalar
        if ptrs:
            r[A_PTR0] = ptrs[0]
        if len(ptrs) > 1:
            r[A_PTR1] = ptrs[1]
        if a.is_dynamic:
            cspec = layout.fifo_specs[row.control]
            values = domain_values(cspec)
            if not values:
                raise ValueError(
                    f"megakernel: dynamic actor {row.name!r} reads control "
                    f"channel {cspec.name!r}, which declares no finite "
                    "integer domain; declare domain=(lo, hi) so the device "
                    "program can tabulate its rates")
            ports = (*a.in_ports, *a.out_ports)
            table = {v: {p: int(bool(e)) for p, e in a.rates_for([v]).items()
                         if p in ports} for v in values}
            rate_tables[row.name] = table
            domains[row.name] = (values[0], values[-1])
            r[A_DLO], r[A_DHI] = values[0], values[-1]
            r[A_RATES] = put([table[v][p] for v in values for p in ports])
        slots.append(ActorSlots(kind=kind, scalar=scalar, ptrs=ptrs))
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
    header[H_L] = L
    header[H_LEN] = total
    packed = header + fifo_rows + actor_rows + list(visit) + tail
    assert len(packed) == total
    return DeviceProgram(
        table=torch.tensor(packed, dtype=torch.int32),
        fifo_names=fifo_names, actor_names=actor_names,
        slots=tuple(slots), consts=tuple(consts), ctrl_base=ctrl_base,
        forwarded=forwarded, n_aptrs=n_aptrs, n_scalars=n_scalars,
        n_ctrl=n_ctrl, L=L, rate_tables=rate_tables, domains=domains)


# --------------------------------------------------------------------------- #
# Staging: NetworkState <-> (tensors, io words), shared by kernel and ref.
# --------------------------------------------------------------------------- #
def _slab(t: Any, name: str, L: int, device: torch.device) -> torch.Tensor:
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.dim() != 2 or t.shape[0] != 2 or not t.is_contiguous()
            or t.device != device or (L and t.shape[1] % L)):
        raise ValueError(f"megakernel: actor {name!r} state must hold a "
                         f"contiguous float32 (2, k*{L}) slab on {device}")
    return t


def stage(prog: DeviceProgram, state: Any, device: torch.device,
          consts: Sequence[torch.Tensor]
          ) -> Tuple[List[Optional[torch.Tensor]], List[int]]:
    """The tensors the kernel addresses (ring per channel, None for control
    rings, then each actor pointer slot) and the io words of ``state``.

    Forwarded control rings enter as zeros (the dead-slot rule); forwarded
    data rings are zeroed by the kernel itself.
    """
    tensors: List[Optional[torch.Tensor]] = []
    io = [0] * prog.io_len
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
        if buf.device != device or not buf.is_contiguous() or buf.dtype != torch.float32:
            raise ValueError(f"megakernel: ring {prog.fifo_names[i]!r} must be "
                             f"a contiguous float32 tensor on {device}")
        tensors.append(buf)
    aptr: List[Optional[torch.Tensor]] = [None] * prog.n_aptrs
    for slot, t in zip((s for s, _ in prog.consts), consts):
        aptr[slot] = t
    for name, sl, st in zip(prog.actor_names, prog.slots, state.actors):
        if sl.kind in ("source", "sink"):
            slab, idx = st
            aptr[sl.ptrs[0]] = _slab(slab, name, prog.L, device)
            io[prog.io_scalars + 2 * sl.scalar] = int(idx)
            io[prog.io_scalars + 2 * sl.scalar + 1] = slab.shape[1] // max(prog.L, 1)
        elif sl.kind == "config":
            io[prog.io_scalars + 2 * sl.scalar] = int(st)
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
    err = int(io[meta + M_ERROR])
    if err:
        actor = prog.actor_names[int(io[meta + M_ERR_ACTOR])]
        value = int(io[meta + M_ERR_VALUE])
        if err == ERR_DOMAIN:
            lo, hi = prog.domains[actor]
            raise ValueError(domain_error(actor, value, lo, hi))
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
        state.actors[j] = idx if sl.kind == "config" else (st[0], idx)
    counts = {n: int(io[prog.io_counts + j])
              for j, n in enumerate(prog.actor_names)}
    return counts, int(io[meta + M_SWEEPS]), bool(io[meta + M_STALLED])
