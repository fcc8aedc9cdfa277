"""The plain PyTorch version of kernel B2 (``csrc/megakernel.cu``).

:func:`run_program` runs a :class:`~.program.DeviceProgram` the way the
kernel does: it reads the same packed table and the same io words, and
never calls the network's Python bodies.  It has the kernel's two parts,
which the kernel overlaps and this version runs one after the other:

* :func:`schedule`, the kernel's scheduler warp.  The loop is the host
  dynamic executor's (``executor.run_dynamic``): sweeps in the program's
  visit order until one fires nothing, or ``max_sweeps``; per visit up to
  ``_max_fireable`` firings (cap 8), each guarded by ``_can_fire`` with
  the rates from the actor's declared enables on the control token, which
  is peeked first; cursors, scalars, control rings and fire counts in the
  io words.  It reads no data ring.  Config actors' control tokens are its
  own state; a control token that a body writes (the MoE router's counts,
  the packer's packed token) is pending until that body has run: the
  kernel's scheduler waits for its own block's body threads there, and
  this version runs the commands through that one (``flush``) before it
  peeks.  It returns one :class:`Command` per firing with a body, numbered
  from 1 in firing order (a firing of ``phases`` kernel commands takes
  that many numbers), with the ring segments its body reads and writes and
  ``wait_for``, the largest number of an earlier command it conflicts with
  (:func:`hazard_waits`).
* :func:`execute`, the kernel's body threads: the commands' bodies on the
  rings at the reference's offsets
  (``src/repro/core/megakernel/kernel.py:151-214``), a delay channel's
  writes one slot further on and, after an enabled phase-2 write, slot
  ``3r`` copied back to slot 0 (Fig. 2); window copies byte for byte
  (through the source's and sink's slab descriptors), ``poly_ref`` for
  Poly, the adder as ``add_`` from zeros in its terms' order, and motion
  detection's ``gauss5x5_u8_ref``, ``thres_ref`` and ``med_ref`` with the
  u8 rounding, and the MoE bodies in the kernel's arithmetic order: every
  product term by term in float32, ``acc + x * w`` with each operation
  rounded, in the order of the summed index (:func:`moe_router`,
  :func:`moe_expert`, :func:`moe_combine`, :func:`moe_packer`), and the
  serving network's admission, gate, merge and retire, all int32, in the
  kernel's order of ranks (:func:`serving_admission`, :func:`serving_merge`,
  :func:`serving_retire`).

A step actor (``DeviceOp("step")``) has no body: :func:`schedule` stops at
its enabled firings with the scheduler saved in the io's yield words, the
caller fires the actor (``kernel.run_step``) and calls :func:`run_program`
again, which resumes there (:func:`step_windows` gives the firing's
windows).

The kernel's blocks each run their share of every command in order, and
start command k only once every block has finished command ``wait_for``
of k, so any order of whole commands that keeps those edges
(:func:`permitted_order`) gives the sequential result; the tests replay
such orders.

With ``guards`` the scheduler also ORs each channel op's cursor fault bits
(``core/health.py``, from the pre-op io words; the control tokens' DOMAIN)
into the fault words after the meta words and keeps each channel's
high-water mark, and :func:`execute` ORs NONFINITE for every enabled float
window a body reads or writes, and DOMAIN for every such window of a data
channel with a declared domain (:func:`_check_domain`), as kernel B2's
``MK_GUARDS`` build does.
With a ``trace_ring`` the scheduler records one event per firing attempt,
as the ``MK_TRACE`` build does (``core/trace.py``).

Every tensor it is given is updated in place and ``io`` is rewritten, as
the kernel rewrites its argument block.  The megakernel backend runs it for
CPU states; ``chip_smoke.py`` runs it on the card as the kernel's oracle.
"""
from __future__ import annotations

import dataclasses
import random
import struct
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.health import (CURSOR_INVALID, DOMAIN, NONFINITE,
                                     OVERFLOW, UNDERFLOW)
from repro_torch.core.megakernel.program import (
    A_AUX, A_CTRL, A_ENABLES, A_FPARAM, A_IN, A_KIND, A_N0, A_N1, A_N2, A_N3,
    A_NAUX, A_NIN, A_NOUT, A_ORDER, A_OUT, A_PLANES, A_PTR0, A_PTR1, A_READY,
    A_SCALAR, ACTOR_FIELDS, ELEM_CODES, ERR_SLAB, F_BOUND, F_CBASE, F_CTRL,
    F_DELAY, F_DHI, F_DLO, F_DOM, F_ELEM, F_FWD, F_NPH, F_RATE, F_TOKB, FIFO_FIELDS,
    H_ACTOR_OFF, H_FIFO_OFF, H_N_ACTORS, H_N_CTRL, H_N_FIFOS, H_N_SCALARS,
    H_N_VISIT, H_VISIT_OFF, KIND_CODES, M_ERR_ACTOR, M_ERR_VALUE, M_ERROR,
    M_STALLED, M_SWEEPS, MAX_STEP_PORTS, META_WORDS, PHASES, SLOT_HEADER,
    Y_ACTOR, Y_FIRED, Y_IN_EN, Y_LEFT, Y_OFF, Y_OUT_EN, Y_PENDING, Y_SEQ,
    Y_SWEEPS, Y_VPOS, YIELD_WORDS)
from repro_torch.kernels.dyn_fir.ref import poly_ref
from repro_torch.kernels.gauss5x5.ref import gauss5x5_u8_ref, to_u8
from repro_torch.kernels.motion_post.ref import med_ref, thres_ref
from repro_torch.models.moe import scatter_rows

#: The reference's per-visit firing cap (``executor.py:31``).
MAX_FIRINGS_PER_VISIT = 8

SOURCE, CONFIG, FORK, POLY, ADDER, SINK, GAUSS, THRES, MED, ROUTER, \
    EXPERT, COMBINE, PACKER, ADMISSION, GATE, MERGE, RETIRE, STEP = (
        KIND_CODES[k] for k in (
            "source", "config", "fork", "poly", "adder", "sink", "gauss", "thres",
            "med", "router", "expert", "combine", "packer", "admission", "gate",
            "merge", "retire", "step"))
#: Kinds whose firings keep state a later firing reads: a command of one
#: runs after the actor's previous command (``Command.after``).
STATEFUL = (POLY, ADMISSION, RETIRE)
#: Kernel commands a firing of each kind becomes.
KIND_PHASES = {KIND_CODES[k]: n for k, n in PHASES.items()}

#: The hazard classes of :func:`hazard_waits`: a read waits for the last
#: write of its segments (raw); a write waits for every read of the old
#: contents (war) and for the last write (waw); the Fig. 2 copy-back's write
#: of a delay channel's slot 0 is a write like any other (delay).
HAZARDS: FrozenSet[str] = frozenset({"raw", "war", "waw", "delay"})


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


# ---- ring arithmetic on a channel row (``FifoSpec`` in table form) ------ #
def read_offset(row: Sequence[int], rd: int) -> int:
    """First slot of read phase ``rd``: 0, r (, 2r) cyclically."""
    return (rd % row[F_NPH]) * row[F_RATE]


def write_offset(row: Sequence[int], wr: int) -> int:
    """First slot of write phase ``wr``; a delay channel writes one slot
    further on, since slot 0 holds the (copied-back) delay token."""
    return (wr % row[F_NPH]) * row[F_RATE] + row[F_DELAY]


def copy_back(ring: torch.Tensor, row: Sequence[int], wr: int) -> None:
    """After an enabled write at phase ``wr``: a delay channel's phase-2
    write copies slot ``3r`` back to slot 0 (paper Fig. 2)."""
    if row[F_DELAY] and wr % row[F_NPH] == 2:
        ring[0].copy_(ring[3 * row[F_RATE]])


# ---- ring segments: the unit of the kernel's dependency tracking -------- #
# A delay-free channel's segment p is its phase-p window (slots pr..pr+r-1),
# which its reads and writes share.  A delay channel's windows are cut by
# the one-slot shift: segment 2p is slot pr, segment 2p+1 slots pr+1 ..
# pr+r-1 (none when r = 1), segment 6 slot 3r.  Read phase p covers segments
# 2p and 2p+1, write phase q segments 2q+1 and 2q+2, the copy-back segment 0.
COPY_BACK_SEGMENT = 0


def read_segments(row: Sequence[int], phase: int) -> Tuple[int, ...]:
    """The segments read phase ``phase`` of a channel reads."""
    if not row[F_DELAY]:
        return (phase,)
    return (2 * phase, 2 * phase + 1) if row[F_RATE] > 1 else (2 * phase,)


def write_segments(row: Sequence[int], phase: int) -> Tuple[int, ...]:
    """The segments write phase ``phase`` of a channel writes."""
    if not row[F_DELAY]:
        return (phase,)
    return (2 * phase + 1, 2 * phase + 2) if row[F_RATE] > 1 else (2 * phase + 2,)


@dataclasses.dataclass
class Command:
    """One firing with a body, as the kernel's scheduler warp emits it.

    ``in_off`` / ``out_off`` are the first ring slot of each port's window;
    ``copy_back`` marks an output whose enabled phase-2 write also goes to
    slot 0; ``idx`` / ``n_idx`` are a source's or sink's window index and its
    slab's window count.  ``reads`` and ``writes`` are ``(channel,
    segment)`` pairs, ``copy_back_writes`` the slot-0 segments; ``after`` is
    the previous command of the same Poly actor (0 for none), which the
    kernel orders by running Poly's history in block 0 alone.  A firing of
    ``phases`` kernel commands takes numbers ``seq .. seq + phases - 1``;
    ``serial`` is the last number of the actor's previous firing when the
    two share a scratch tensor (the MoE router's and experts'), which every
    block must have finished first.  ``ctrl_out`` is, per output, the io
    word of the control token the body writes (-1 for none)."""

    seq: int
    actor: int
    in_en: List[int]
    out_en: List[int]
    in_off: List[int]
    out_off: List[int]
    copy_back: List[bool]
    idx: int = 0
    n_idx: int = 0
    reads: Tuple[Tuple[int, int], ...] = ()
    writes: Tuple[Tuple[int, int], ...] = ()
    copy_back_writes: Tuple[Tuple[int, int], ...] = ()
    after: int = 0
    wait_for: int = 0
    phases: int = 1
    serial: int = 0
    ctrl_out: Tuple[int, ...] = ()

    @property
    def last(self) -> int:
        """The number of the firing's last kernel command."""
        return self.seq + self.phases - 1


class _Table:
    """The packed program's rows, unpacked once."""

    def __init__(self, table: Sequence[int]) -> None:
        t = [int(v) for v in table]
        self.t = t
        self.n_fifos, self.n_actors = t[H_N_FIFOS], t[H_N_ACTORS]
        self.fifo = [t[t[H_FIFO_OFF] + FIFO_FIELDS * i:][:FIFO_FIELDS]
                     for i in range(self.n_fifos)]
        self.actor = [t[t[H_ACTOR_OFF] + ACTOR_FIELDS * a:][:ACTOR_FIELDS]
                      for a in range(self.n_actors)]
        self.visit = t[t[H_VISIT_OFF]:t[H_VISIT_OFF] + t[H_N_VISIT]]
        self.io_scal = 3 * self.n_fifos
        self.io_ctrl = self.io_scal + 2 * t[H_N_SCALARS]
        self.io_counts = self.io_ctrl + t[H_N_CTRL]
        self.io_yield = self.io_counts + self.n_actors
        self.io_meta = self.io_yield + YIELD_WORDS
        self.io_fault = self.io_meta + META_WORDS
        self.io_hw = self.io_fault + self.n_fifos
        self.io_events = self.io_hw + self.n_fifos

    def words(self, f: int) -> int:
        """Words of one token of channel ``f`` (control tokens)."""
        return self.fifo[f][F_TOKB] // 4

    def ctrl_word(self, f: int, phase: int) -> int:
        """The io word of the first element of control channel ``f``'s token
        at ``phase`` (rate 1: phase p is slot p)."""
        return self.io_ctrl + self.fifo[f][F_CBASE] + phase * self.words(f)

    def ports(self, a: int) -> Tuple[List[int], List[int]]:
        r, t = self.actor[a], self.t
        return (t[r[A_IN]:r[A_IN] + r[A_NIN]], t[r[A_OUT]:r[A_OUT] + r[A_NOUT]])


def hazard_waits(commands: Sequence[Command],
                 hazards: FrozenSet[str] = HAZARDS) -> None:
    """Set each command's ``wait_for`` under the kernel's rule: the largest
    number of an earlier command that wrote a segment it reads (raw), read
    or wrote a segment it writes (war, waw), the copy-back's slot-0 writes
    counted only with ``delay``, and ``serial``.  Waits are taken before
    this command's own segments are recorded, so a command never waits for
    itself; a firing's segments count from its last phase, and each later
    phase waits for the one before it."""
    last_w: Dict[Tuple[int, int], int] = {}
    last_r: Dict[Tuple[int, int], int] = {}
    for c in commands:
        writes = c.writes + (c.copy_back_writes if "delay" in hazards else ())
        w = c.serial
        if "raw" in hazards:
            w = max([w] + [last_w.get(s, 0) for s in c.reads])
        if "war" in hazards:
            w = max([w] + [last_r.get(s, 0) for s in writes])
        if "waw" in hazards:
            w = max([w] + [last_w.get(s, 0) for s in writes])
        c.wait_for = w
        for s in c.reads:
            last_r[s] = c.last
        for s in writes:
            last_w[s] = c.last


def permitted_order(commands: Sequence[Command],
                    rng: Optional[random.Random] = None,
                    done_before: int = 0) -> List[Command]:
    """An order of whole commands the kernel permits: command k only after
    every command up to its ``wait_for`` and after its ``after``; among the
    commands ready, a random one (``rng``), or the latest without one.
    ``done_before``: every command numbered up to it has run already (the
    commands a scheduler's wait on a body ran, or an earlier launch's)."""
    n = commands[-1].last if commands else 0
    done = [True] * (done_before + 1) + [False] * max(0, n - done_before)
    prefix = done_before             # every command <= prefix is done
    todo = list(commands)
    order: List[Command] = []
    while todo:
        ready = [c for c in todo if c.wait_for <= prefix and done[c.after]]
        c = rng.choice(ready) if rng is not None else ready[-1]
        todo.remove(c)
        order.append(c)
        for k in range(c.seq, c.last + 1):
            done[k] = True
        while prefix < n and done[prefix + 1]:
            prefix += 1
    return order


class _Stop(Exception):
    """An error word was set; the run ends there, as the kernel's does."""


def schedule(table: Sequence[int], tensors: List[Optional[torch.Tensor]],
             io: List[int], max_sweeps: int, multi_firing: bool,
             guards: bool = False,
             trace_ring: Optional[np.ndarray] = None,
             flush: Optional[Callable[[List["Command"], int], None]] = None
             ) -> List[Command]:
    """Run the sweep loop on ``io`` in place (the kernel's scheduler warp);
    returns the commands of the firings with a body, ``wait_for`` set.

    ``guards`` keeps the cursor guards' fault words and the high-water
    marks in the io words after the meta words; ``trace_ring`` (a
    ``(capacity, 3 + n_fifos)`` int32 array) takes one event per attempt,
    the count in the io word after the high-water marks.  ``flush(commands,
    seq)`` must run the commands through number ``seq`` (those not run
    yet) before a control token or a ready scalar a body writes is peeked;
    a program whose bodies write none never calls it.

    The loop is the kernel's state machine (``schedule_next``): the sweep
    count, the visit position, the firings left in the visit and whether
    the sweep fired.  At an enabled firing of a step actor it stops after
    the firing's bookkeeping and its trace event, with that state, the
    firing's actor, enables and window offsets in the yield words
    (``Y_PENDING`` set); called again on such io words it goes on from
    there."""
    P = _Table(table)
    t, fifo, actor = P.t, P.fifo, P.actor
    aptr = tensors[P.n_fifos:]
    schedules = {a: aptr[actor[a][A_PTR0]].tolist()
                 for a in range(P.n_actors) if actor[a][A_KIND] == CONFIG}
    Y = P.io_yield
    commands: List[Command] = []
    last_cmd: Dict[int, int] = {}       # stateful actor -> its last command
    last_fire: Dict[int, int] = {}      # MoE actor -> its last command
    pending: Dict[Tuple[int, int], int] = {}   # (control channel, phase) -> writer
    if io[Y + Y_PENDING]:
        sweeps, vpos, left, fired_any = (io[Y + w] for w in (Y_SWEEPS, Y_VPOS, Y_LEFT,
                                                             Y_FIRED))
        seq_next = io[Y + Y_SEQ] + 1
        io[Y + Y_PENDING] = 0
    else:
        sweeps, vpos, left, fired_any = 0, -1, -1, 1
        seq_next = 1

    def wait_body(writer: int) -> None:
        """Run the commands through ``writer`` (0: none), whose body wrote
        what the scheduler reads next."""
        if not writer:
            return
        if flush is None:
            raise RuntimeError("ref.schedule: a body writes the control "
                               "token or scalar read here; pass flush=")
        flush(commands, writer)

    def token(c: int) -> List[int]:
        """The control token at channel c's read phase; waits for (runs)
        the body that writes it."""
        ph = read_offset(fifo[c], io[3 * c])
        wait_body(pending.pop((c, ph), 0))
        at = P.ctrl_word(c, ph)
        return io[at:at + P.words(c)]

    def occ(f: int) -> int:
        return io[3 * f + 2]

    def cursor_bits(f: int) -> Tuple[int, int]:
        """CURSOR_INVALID of channel f's io words, and its true occupancy."""
        rd, wr, o = io[3 * f:3 * f + 3]
        true = fifo[f][F_DELAY] + (wr - rd) * fifo[f][F_RATE]
        return (CURSOR_INVALID if o != true else 0), true

    def domain_bit(f: int, tok: Sequence[int]) -> int:
        lo, hi = fifo[f][F_DLO], fifo[f][F_DHI]
        return 0 if all(lo <= x <= hi for x in tok) else DOMAIN

    def guard_read(f: int, e: int) -> None:
        bits, true = cursor_bits(f)
        if e and true < fifo[f][F_RATE]:
            bits |= UNDERFLOW
        if e and fifo[f][F_CTRL]:
            bits |= domain_bit(f, token(f))
        io[P.io_fault + f] |= bits

    def guard_write(f: int, e: int, value: Optional[int]) -> None:
        bits, true = cursor_bits(f)
        if e and true + fifo[f][F_RATE] > fifo[f][F_BOUND]:
            bits |= OVERFLOW
        if e and value is not None:
            bits |= domain_bit(f, (value,))
        io[P.io_fault + f] |= bits
        io[P.io_hw + f] = max(io[P.io_hw + f], true + (fifo[f][F_RATE] if e else 0))

    def record(a: int, sweep: int, fired: int, times: int = 1) -> None:
        occs = [occ(f) for f in range(P.n_fifos)]
        for _ in range(times):
            n = io[P.io_events]
            trace_ring[n % trace_ring.shape[0]] = [a, sweep, fired] + occs
            io[P.io_events] = n + 1

    def rates(a: int) -> List[int]:
        """0/1 per port (inputs, then outputs) from the declared enables:
        (word, threshold) is tok[word] > threshold, (-1, v) the constant v;
        peeks the control token."""
        r = actor[a]
        n = r[A_NIN] + r[A_NOUT]
        if r[A_CTRL] < 0:
            return [1] * n
        tok = token(r[A_CTRL])
        forms = t[r[A_ENABLES]:r[A_ENABLES] + 2 * n]
        return [int(tok[w] > x) if w >= 0 else x
                for w, x in zip(forms[0::2], forms[1::2])]

    def can_fire(a: int) -> bool:
        r = actor[a]
        if r[A_READY] >= 0:
            if r[A_KIND] == ADMISSION:      # its body writes the ready scalar
                wait_body(last_cmd.get(a, 0))
            if io[P.io_scal + 2 * r[A_SCALAR]] >= r[A_READY]:
                return False
        if r[A_CTRL] >= 0 and occ(r[A_CTRL]) < 1:
            return False
        en = rates(a)
        ins, outs = P.ports(a)
        for e, f in zip(en, ins):
            if e and occ(f) < fifo[f][F_RATE]:
                return False
        for e, f in zip(en[len(ins):], outs):
            if e and occ(f) + fifo[f][F_RATE] > fifo[f][F_BOUND]:
                return False
        return True

    def max_fireable(a: int) -> int:
        r = actor[a]
        if r[A_CTRL] >= 0:
            return min(MAX_FIRINGS_PER_VISIT, occ(r[A_CTRL]))
        k = MAX_FIRINGS_PER_VISIT
        ins, outs = P.ports(a)
        for f in ins:
            k = min(k, occ(f) // fifo[f][F_RATE])
        for f in outs:
            k = min(k, (fifo[f][F_BOUND] - occ(f)) // fifo[f][F_RATE])
        return k

    def fire(a: int) -> bool:
        """One firing's bookkeeping and its command; True when it is an
        enabled firing of a step actor, whose yield words it wrote."""
        nonlocal seq_next
        r = actor[a]
        kind = r[A_KIND]
        en = rates(a)
        if r[A_CTRL] >= 0:                       # consume the control token
            c = r[A_CTRL]
            if guards:
                guard_read(c, 1)
            io[3 * c] += 1
            io[3 * c + 2] -= 1
        ins, outs = P.ports(a)
        in_ph = [io[3 * f] % fifo[f][F_NPH] for f in ins]
        for e, f in zip(en, ins):
            if guards:
                guard_read(f, e)
            if e:
                io[3 * f] += 1
                io[3 * f + 2] -= fifo[f][F_RATE]
        body = r[A_CTRL] < 0 or not en or any(en)
        idx = n_idx = value = 0
        if body and kind in (SOURCE, CONFIG, SINK):
            s = P.io_scal + 2 * r[A_SCALAR]
            idx, n_idx = io[s], io[s + 1]
            if kind != CONFIG and not 0 <= idx < n_idx:
                io[P.io_meta + M_ERROR] = ERR_SLAB
                io[P.io_meta + M_ERR_ACTOR] = a
                io[P.io_meta + M_ERR_VALUE] = idx
                raise _Stop
            io[s] = idx + 1
            if kind == CONFIG:
                value = schedules[a][min(max(idx, 0), r[A_AUX] - 1)]
        out_en = en[len(ins):]
        out_ph = [io[3 * f + 1] % fifo[f][F_NPH] for f in outs]
        cb = [bool(e and fifo[f][F_DELAY] and ph == 2)
              for e, f, ph in zip(out_en, outs, out_ph)]
        seq = seq_next
        phases = KIND_PHASES.get(kind, 1)
        ctrl_out = []
        for e, f, ph in zip(out_en, outs, out_ph):
            if guards:
                guard_write(f, e, value if fifo[f][F_CTRL] and body
                            and kind == CONFIG else None)
            ctrl_out.append(-1)
            if e:
                if fifo[f][F_CTRL] and body and kind == CONFIG:
                    io[P.ctrl_word(f, ph)] = value
                elif fifo[f][F_CTRL] and body:
                    ctrl_out[-1] = P.ctrl_word(f, ph)
                    pending[(f, ph)] = seq + phases - 1
                io[3 * f + 1] += 1
                io[3 * f + 2] += fifo[f][F_RATE]
        io[P.io_counts + a] += 1
        if not body or kind == CONFIG:
            return False
        in_off = [ph * fifo[f][F_RATE] for f, ph in zip(ins, in_ph)]
        out_off = [write_offset(fifo[f], ph) for f, ph in zip(outs, out_ph)]
        if kind == STEP:
            io[Y + Y_ACTOR] = a
            io[Y + Y_IN_EN] = sum(e << i for i, e in enumerate(en[:len(ins)]))
            io[Y + Y_OUT_EN] = sum(e << i for i, e in enumerate(out_en))
            io[Y + Y_OFF:Y + Y_OFF + len(ins)] = in_off
            io[Y + Y_OFF + MAX_STEP_PORTS:Y + Y_OFF + MAX_STEP_PORTS + len(outs)] = out_off
            return True
        # What the body touches: every input window (an adder only its
        # enabled terms), every enabled data output window, and slot 0 of a
        # delay channel on its phase-2 write.
        reads = tuple((f, s) for i, (f, ph) in enumerate(zip(ins, in_ph))
                      if not fifo[f][F_CTRL] and (kind != ADDER or en[i])
                      for s in read_segments(fifo[f], ph))
        writes = tuple((f, s) for e, f, ph in zip(out_en, outs, out_ph)
                       if e and not fifo[f][F_CTRL]
                       for s in write_segments(fifo[f], ph))
        seq_next += phases
        commands.append(Command(
            seq=seq, actor=a, in_en=list(en[:len(ins)]), out_en=list(out_en),
            in_off=in_off, out_off=out_off,
            copy_back=cb, idx=idx, n_idx=n_idx, reads=reads, writes=writes,
            copy_back_writes=tuple((f, COPY_BACK_SEGMENT)
                                   for f, on in zip(outs, cb) if on),
            after=last_cmd.get(a, 0) if kind in STATEFUL else 0,
            phases=phases, serial=last_fire.get(a, 0), ctrl_out=tuple(ctrl_out)))
        if kind in STATEFUL:
            last_cmd[a] = seq
        if phases > 1:
            last_fire[a] = seq + phases - 1
        return False

    stopped = False
    try:
        while True:
            if vpos < 0:        # between sweeps
                if not fired_any or sweeps >= max_sweeps:
                    break
                fired_any, vpos, left = 0, 0, -1
            if vpos == len(P.visit):
                sweeps += 1
                vpos = -1
                continue
            a = P.visit[vpos]
            if left < 0:
                left = max_fireable(a) if multi_firing else 1
            if left <= 0 or not can_fire(a):
                if left > 0 and trace_ring is not None:
                    record(a, sweeps, 0, left)
                vpos, left = vpos + 1, -1
                continue
            left -= 1
            fired_any = 1
            step = fire(a)
            if trace_ring is not None:
                record(a, sweeps, 1)
            if step:
                io[Y + Y_PENDING] = 1
                io[Y + Y_SWEEPS], io[Y + Y_VPOS], io[Y + Y_LEFT] = sweeps, vpos, left
                io[Y + Y_FIRED], io[Y + Y_SEQ] = fired_any, seq_next - 1
                stopped = True
                break
    except _Stop:
        stopped = True
    io[P.io_meta + M_SWEEPS] = sweeps
    io[P.io_meta + M_STALLED] = int(not stopped and fired_any and sweeps >= max_sweeps)
    hazard_waits(commands)
    return commands


#: The element codes of float channels.
FLOAT_ELEMS = tuple(ELEM_CODES[t] for t in (torch.float32, torch.bfloat16, torch.float16))


def _check_finite(P: _Table, fault: torch.Tensor, f: int,
                  window: torch.Tensor) -> None:
    """OR NONFINITE into ``fault[f]`` when a float data window (float32,
    bf16 or f16) holds a NaN or an Inf (on the window's device, without a
    host sync)."""
    if P.fifo[f][F_CTRL] or P.fifo[f][F_ELEM] not in FLOAT_ELEMS:
        return
    bad = (~torch.isfinite(window)).any().to(torch.int32) * NONFINITE
    fault[f:f + 1].bitwise_or_(bad)


def _check_domain(P: _Table, fault: torch.Tensor, f: int,
                  window: torch.Tensor) -> None:
    """OR DOMAIN into ``fault[f]`` when a window of a data channel with a
    declared domain holds an element outside ``[lo, hi]``: the row's bounds,
    float32 bits for a float channel, against which the kernel compares
    each token widened to float32 (a bf16 or f16 channel's bounds are
    rounded to its type, so this is the comparison in that type), ints
    otherwise.  ``lo <= x <= hi`` fails for a NaN too, as the reference's
    ``_domain_bit`` compares."""
    row = P.fifo[f]
    if row[F_CTRL] or not row[F_DOM]:
        return
    if row[F_ELEM] in FLOAT_ELEMS:
        lo, hi = (struct.unpack("<f", struct.pack("<i", row[x]))[0] for x in (F_DLO, F_DHI))
        window = window.to(torch.float32)
    else:
        lo, hi = row[F_DLO], row[F_DHI]
        window = window.to(torch.int64)
    bad = (~((window >= lo) & (window <= hi))).any().to(torch.int32) * DOMAIN
    fault[f:f + 1].bitwise_or_(bad)


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (R, K) @ w (K, M)`` as the kernel sums it: float32, from 0, in
    the order of k, each product and each sum rounded on its own."""
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
    w = w.to(torch.float32)
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * w[k:k + 1, :]
    return acc


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from 0, in order, each add rounded."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def moe_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The router's first phase: ``x (N, D) @ w (D, E)`` (bf16 weights)."""
    return _dot(x, w)


def moe_route(logits: torch.Tensor, k: int, C: int):
    """The router's second phase on ``logits (N, E)``: softmax (the max,
    ``exp``, the sum in expert order), top-k (ties to the lower expert),
    the k weights over their sum (at least 1e-9), ranks in token-major
    order, capacity ``C``.  Returns ``(slot (N, k) int32, w (N, k), counts
    (E,) int32)``, dropped assignments at slot ``E C`` with weight 0."""
    N, E = logits.shape
    m = logits.max(dim=1, keepdim=True).values
    ex = torch.exp(logits - m)
    probs = ex / _seq_sum(ex)[:, None]
    order = torch.sort(probs, dim=1, descending=True, stable=True).indices[:, :k]
    gate_w = torch.gather(probs, 1, order)
    gate_w = gate_w / torch.clamp(_seq_sum(gate_w), min=1e-9)[:, None]
    flat = order.reshape(-1).to(torch.int64)
    onehot = torch.nn.functional.one_hot(flat, E).to(torch.int32)
    rank = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(1).reshape(N, k)
    keep = rank < C
    slot = torch.where(keep, order * C + rank, torch.full_like(rank, E * C))
    counts = (onehot.reshape(N, k, E) * keep[..., None]).sum((0, 1))
    w = gate_w * keep.to(torch.float32)
    return slot.to(torch.int32), w, counts.to(torch.int32)


def moe_dispatch(x: torch.Tensor, slot: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The (E C, D) slabs: row ``slot`` of each kept assignment is its token
    plus 0.0 (the reference's scatter-add into zeros), other rows 0."""
    k = slot.shape[1]
    return scatter_rows(slot.reshape(-1).to(torch.int64), x.repeat_interleave(k, dim=0),
                        E * C + 1)[:-1]


def moe_expert_hidden(slab: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """An expert's first phase: ``silu(slab @ wg) * (slab @ wu)``, silu as
    ``x * (1 / (1 + exp(-x)))``."""
    g = _dot(slab, wg)
    u = _dot(slab, wu)
    return g * (1.0 / (1.0 + torch.exp(-g))) * u


def moe_combine(ys: Sequence[Optional[torch.Tensor]], slot: torch.Tensor,
                w: torch.Tensor, C: int) -> torch.Tensor:
    """``y[n] = sum_k row(slot[n, k]) * w[n, k]`` from 0 in k order; a
    dropped assignment or a disabled expert (None) gives a zero row."""
    E = len(ys)
    N, k = slot.shape
    D = next((y.shape[1] for y in ys if y is not None), None)
    dev = slot.device
    D = D if D is not None else 0
    flat = torch.zeros((E * C + 1, D), dtype=torch.float32, device=dev)
    for e, y in enumerate(ys):
        if y is not None:
            flat[e * C:(e + 1) * C] = y
    acc = torch.zeros((N, D), dtype=torch.float32, device=dev)
    for j in range(k):
        acc = acc + flat[slot[:, j].to(torch.int64)] * w[:, j:j + 1]
    return acc


# ---- the serving network's bodies (graphs/serving.py) ------------------- #
# The slot table's columns and status codes, as graphs/serving.py numbers
# them; a row is HEADER columns, P prompt columns, N generated-token columns.
(C_ACTIVE, C_REQ, C_POS, C_PROD, C_BUDGET, C_FIN, C_LAST, C_NEW, C_LAT,
 C_STATUS, C_DEADLINE, C_AGE) = range(SLOT_HEADER)
STATUS_OK, STATUS_TIMEOUT, STATUS_SHED = 0, 1, 2


def _i32(x: int) -> int:
    """``x`` wrapped to int32, as the actors' int32 arithmetic wraps."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def serving_admission(fb: List[List[int]], taken: List[int], t: int,
                      prompts: List[List[int]], budgets: List[int],
                      arrivals: List[int], deadlines: List[int], P: int, N: int,
                      qd: int) -> Tuple[List[List[int]], List[List[int]], List[int],
                                        List[int]]:
    """Admission's firing on the slot table ``fb`` (B rows), as the kernel
    computes it: ranks by counting in request and slot order.  Returns the
    new table, the finished rows, the control token ``[n_active,
    n_finished, n_admitted]`` and the new taken flags (``t`` and
    ``retired`` move by 1 and by the token's second word)."""
    B, R, W = len(fb), len(taken), SLOT_HEADER + P + N
    expired = [row[C_ACTIVE] > 0 and row[C_DEADLINE] < t for row in fb]
    fin = [e or row[C_FIN] > 0 for e, row in zip(expired, fb)]
    free = [f or row[C_ACTIVE] == 0 for f, row in zip(fin, fb)]
    n_fin = sum(fin)
    waiting = [taken[i] == 0 and arrivals[i] <= t for i in range(R)]
    exp_wait = [w and deadlines[i] < t for i, w in enumerate(waiting)]
    admissible = [w and not e for w, e in zip(waiting, exp_wait)]
    k = min(sum(admissible), sum(free))
    # The j-th admitted request goes to the j-th free slot, the j-th shed
    # record (of at most B - n_fin) to the j-th slot that did not finish.
    by_adm: List[int] = []
    by_shed: List[int] = []
    new_taken = list(taken)
    a_rank = s_rank = 0
    for i in range(R):
        overflow = False
        if admissible[i]:
            if a_rank < k:
                by_adm.append(i)
                new_taken[i] = 1
            overflow = a_rank >= k + qd
            a_rank += 1
        if exp_wait[i] or overflow:
            if s_rank < B - n_fin:
                by_shed.append(i)
                new_taken[i] = 1
            s_rank += 1
    table: List[List[int]] = []
    fins: List[List[int]] = []
    f_rank = r_rank = 0
    for b, row in enumerate(fb):
        if free[b] and f_rank < k:
            i = by_adm[f_rank]
            table.append([1, i, P - 1, 0, budgets[i], 0, 0, 1, 0, STATUS_OK,
                          deadlines[i], 0] + list(prompts[i]) + [0] * N)
        elif fin[b]:
            table.append([0] * W)
        else:
            table.append(list(row))
        if not fin[b] and r_rank < len(by_shed):
            i = by_shed[r_rank]
            status = STATUS_TIMEOUT if deadlines[i] < t else STATUS_SHED
            fins.append([0, i, 0, 0, budgets[i], 1, 0, 0, _i32(t - arrivals[i]), status,
                         deadlines[i], 0] + [0] * (P + N))
        elif fin[b]:
            out = list(row)
            if expired[b]:
                out[C_FIN], out[C_STATUS] = 1, STATUS_TIMEOUT
            out[C_LAT] = _i32(t - 1 - arrivals[min(max(row[C_REQ], 0), R - 1)])
            fins.append(out)
        else:
            fins.append([0] * W)
        f_rank += free[b]
        r_rank += not fin[b]
    ctl = [sum(row[C_ACTIVE] > 0 for row in table), n_fin + len(by_shed), k]
    return table, fins, ctl, new_taken


def serving_merge(tbl: List[List[int]], y: List[int], eos: int, P: int,
                  N: int) -> List[List[int]]:
    """Merge's firing: each active row takes its decoded token at column
    ``HEADER + P + produced``, advances, and finishes on EOS or its
    budget."""
    out = []
    for row, yb in zip(tbl, y):
        active = row[C_ACTIVE] > 0
        act = int(active)
        produced = row[C_PROD]
        gen = list(row[SLOT_HEADER + P:])
        if active and 0 <= produced < N:
            gen[produced] = yb
        produced = _i32(produced + act)
        fin = active and (yb == eos or produced >= row[C_BUDGET])
        out.append([int(active and not fin), row[C_REQ], _i32(row[C_POS] + act),
                    produced, row[C_BUDGET], int(fin), yb if active else row[C_LAST],
                    0, row[C_LAT], row[C_STATUS], row[C_DEADLINE],
                    _i32(row[C_AGE] + act)] + list(row[SLOT_HEADER:SLOT_HEADER + P]) + gen)
    return out


def serving_retire(rows: List[List[int]], R: int, P: int
                   ) -> List[Tuple[int, List[int], int, int, int]]:
    """Retire's firing: ``(request, generated tokens, produced, latency,
    status)`` of each finished row with a request id in ``[0, R)``, in row
    order (a later row wins)."""
    return [(row[C_REQ], list(row[SLOT_HEADER + P:]), row[C_PROD], row[C_LAT],
             row[C_STATUS]) for row in rows
            if row[C_FIN] > 0 and 0 <= row[C_REQ] < R]


def _rows(t: List, like: torch.Tensor) -> torch.Tensor:
    """Lists of ints as an int32 tensor on ``like``'s device."""
    return torch.tensor(t, dtype=torch.int32, device=like.device)


def execute(table: Sequence[int], tensors: List[Optional[torch.Tensor]],
            commands: Sequence[Command],
            value_fault: Optional[torch.Tensor] = None,
            io: Optional[List[int]] = None) -> None:
    """Run the commands' bodies on ``tensors`` in the order given (the
    kernel's body threads).  With ``value_fault`` (an int32 vector, one
    word per channel) every enabled float window a body reads, before it
    runs, and writes, after, is checked for NaN and Inf.  The control
    tokens bodies write go into ``io`` (``Command.ctrl_out``)."""
    P = _Table(table)
    t, fifo, actor = P.t, P.fifo, P.actor
    rings = tensors[:P.n_fifos]
    aptr = tensors[P.n_fifos:]
    for c in commands:
        r = actor[c.actor]
        kind = r[A_KIND]
        ins, outs = P.ports(c.actor)
        win = [rings[f][o:o + fifo[f][F_RATE]] for f, o in zip(ins, c.in_off)]
        dst = [None if fifo[f][F_CTRL] else rings[f][o:o + fifo[f][F_RATE]]
               for f, o in zip(outs, c.out_off)]
        if value_fault is not None:
            for e, f, w in zip(c.in_en, ins, win):
                if e:
                    _check_finite(P, value_fault, f, w)
                    _check_domain(P, value_fault, f, w)
        if kind in (SOURCE, SINK):
            # Plane p of window idx sits at p * stride + idx * wb of the slab.
            wb = r[A_N0]
            stride = c.n_idx * wb
            slab = _bytes(aptr[r[A_PTR0]])
            ring = _bytes(dst[0] if kind == SOURCE else win[0])
            for p in range(r[A_PLANES]):
                at = p * stride + c.idx * wb
                if kind == SINK:
                    slab[at:at + wb].copy_(ring[p * wb:(p + 1) * wb])
                elif c.out_en[0]:
                    ring[p * wb:(p + 1) * wb].copy_(slab[at:at + wb])
        elif kind == FORK:
            for e, d in zip(c.out_en, dst):
                if e:
                    d.copy_(win[0])
        elif kind == POLY:
            hist = aptr[r[A_PTR0]]
            y, nxt = poly_ref(hist, win[0][0], aptr[r[A_PTR1]], r[A_ORDER])
            hist.copy_(nxt)
            if c.out_en[0]:
                dst[0][0].copy_(y)
        elif kind == ADDER:
            acc = torch.zeros_like(win[0])
            for k in t[r[A_AUX]:r[A_AUX] + r[A_NAUX]]:
                if c.in_en[k]:
                    acc.add_(win[k])
            if c.out_en[0]:
                dst[0].copy_(acc)
        elif kind == GAUSS:
            out = gauss5x5_u8_ref(win[0])
            for e, d in zip(c.out_en, dst):
                if e:
                    d.copy_(out)
        elif kind == THRES:
            threshold = struct.unpack("<f", struct.pack("<i", r[A_FPARAM]))[0]
            if c.out_en[0]:
                dst[0].copy_(to_u8(thres_ref(win[0].to(torch.float32),
                                             win[1].to(torch.float32),
                                             threshold)))
        elif kind == MED:
            if c.out_en[0]:
                dst[0].copy_(to_u8(med_ref(win[0].to(torch.float32))))
        elif kind == ROUTER:
            E, C, k = r[A_N2], r[A_N3], r[A_ORDER]
            logits = aptr[r[A_PTR0] + 1].view(r[A_N0], E)
            logits.copy_(moe_logits(win[0][0], aptr[r[A_PTR0]]))
            slot, w, counts = moe_route(logits, k, C)
            slabs = moe_dispatch(win[0][0], slot, E, C)
            for e in range(E):
                dst[e][0].copy_(slabs[e * C:(e + 1) * C])
                dst[2 * E + 2 + e][0].copy_(counts[e:e + 1])
            dst[2 * E][0].copy_(slot)
            dst[2 * E + 1][0].copy_(w)
            _write_ctrl(io, c.ctrl_out[E:2 * E], counts.tolist())
        elif kind == EXPERT:
            if c.out_en[0]:
                base = r[A_PTR0]
                h = aptr[base + 3].view(r[A_N0], r[A_AUX])
                h.copy_(moe_expert_hidden(win[0][0], aptr[base], aptr[base + 1]))
                dst[0][0].copy_(_dot(h, aptr[base + 2]))
        elif kind == COMBINE:
            E, C = r[A_N2], r[A_N3]
            ys = [win[e][0] if c.in_en[e] else None for e in range(E)]
            dst[0][0].copy_(moe_combine(ys, win[E][0], win[E + 1][0], C))
        elif kind == PACKER:
            E = r[A_N2]
            counts = [int(x) for x in torch.cat([w.reshape(-1) for w in win]).tolist()]
            _write_ctrl(io, c.ctrl_out[:1], [counts + counts])
        elif kind == GATE:
            for e, w, d in zip(c.out_en, win, dst):
                if e:
                    d.copy_(w)
        elif kind == ADMISSION:
            if io is None:
                raise RuntimeError("ref.execute: admission keeps its state in "
                                   "the io words; pass io=")
            Pn, Nn, R = r[A_N0], r[A_N1], r[A_N3]
            s = P.io_scal + 2 * r[A_SCALAR]
            base = P.io_ctrl + r[A_AUX]
            retired, t_now = io[s], io[s + 1]
            consts = [aptr[r[A_PTR0] + j].tolist() for j in range(4)]
            tbl, fins, ctl, taken = serving_admission(
                win[0][0].tolist(), io[base:base + R], t_now, *consts, Pn, Nn, r[A_ORDER])
            for d, rows in zip(dst[:3], (tbl, tbl, fins)):
                d[0].copy_(_rows(rows, d))
            io[s], io[s + 1] = retired + ctl[1], t_now + 1
            io[base:base + R] = taken
            _write_ctrl(io, c.ctrl_out[3:], [ctl] * len(c.ctrl_out[3:]))
        elif kind == MERGE:
            rows = serving_merge(win[0][0].tolist(), win[1][0].tolist(), r[A_ORDER],
                                 r[A_N0], r[A_N1])
            dst[0][0].copy_(_rows(rows, dst[0]))
        elif kind == RETIRE:
            gen, lens, lat, status, done = (aptr[r[A_PTR0] + j] for j in range(5))
            for req, toks, n, lt, st in serving_retire(win[0][0].tolist(), r[A_N3],
                                                       r[A_N0]):
                gen[req].copy_(_rows(toks, gen))
                for buf, v in ((lens, n), (lat, lt), (status, st), (done, 1)):
                    buf[req] = v
        if value_fault is not None:
            for e, f, d in zip(c.out_en, outs, dst):
                if e and d is not None:
                    _check_finite(P, value_fault, f, d)
                    _check_domain(P, value_fault, f, d)
        for on, f in zip(c.copy_back, outs):
            if on:
                rings[f][0].copy_(rings[f][3 * fifo[f][F_RATE]])


def _write_ctrl(io: Optional[List[int]], words: Sequence[int],
                values: Sequence) -> None:
    """Control tokens a body wrote, into their io words (a token is an int
    or a list of ints)."""
    if io is None:
        raise RuntimeError("ref.execute: this body writes control tokens; "
                           "pass io=")
    for at, v in zip(words, values):
        if at < 0:
            continue
        vals = v if isinstance(v, list) else [v]
        io[at:at + len(vals)] = [int(x) for x in vals]


def zero_forwarded(table: Sequence[int], tensors: List[Optional[torch.Tensor]]) -> None:
    """Forwarded data rings start the run from zeros (the dead-slot rule)."""
    P = _Table(table)
    for f in range(P.n_fifos):
        if P.fifo[f][F_FWD] and not P.fifo[f][F_CTRL]:
            _bytes(tensors[f]).zero_()


def step_windows(table: Sequence[int], tensors: List[Optional[torch.Tensor]],
                 io: Sequence[int]) -> Tuple[int, List[int], List[int],
                                             List[torch.Tensor], List[torch.Tensor]]:
    """The pending step firing of ``io``'s yield words: ``(actor, input
    enables, output enables, input windows, output windows)``, each window
    a view of its ring at the offset the firing took (every input's, as a
    masked read hands it over; every output's)."""
    P = _Table(table)
    Y = P.io_yield
    a = io[Y + Y_ACTOR]
    ins, outs = P.ports(a)
    in_en = [(io[Y + Y_IN_EN] >> i) & 1 for i in range(len(ins))]
    out_en = [(io[Y + Y_OUT_EN] >> o) & 1 for o in range(len(outs))]
    wins = [tensors[f][o:o + P.fifo[f][F_RATE]]
            for f, o in zip(ins, io[Y + Y_OFF:Y + Y_OFF + len(ins)])]
    outw = [tensors[f][o:o + P.fifo[f][F_RATE]]
            for f, o in zip(outs, io[Y + Y_OFF + MAX_STEP_PORTS:
                                     Y + Y_OFF + MAX_STEP_PORTS + len(outs)])]
    return a, in_en, out_en, wins, outw


def run_program(table: Sequence[int], tensors: List[Optional[torch.Tensor]],
                io: List[int], max_sweeps: int, multi_firing: bool,
                guards: bool = False,
                trace_ring: Optional[np.ndarray] = None) -> None:
    """Run the device program to quiescence on ``tensors`` (rings, then
    actor tensors) and ``io`` (the io block), in place, or to the next
    enabled firing of a step actor (``Y_PENDING`` set in the yield words).
    Called again on such io words it resumes: forwarded rings keep what
    they hold, and with ``guards`` the step firing's windows (which the
    caller has run the actor on) are checked first, its enabled inputs and
    outputs for NONFINITE and DOMAIN, as the kernel's first command after a
    resume does.  With ``guards`` or a ``trace_ring``, ``io`` holds the
    health and trace words after the meta words (``stage(...,
    health_words=True)``)."""
    P = _Table(table)
    value_fault = None
    if guards:
        device = next((x.device for x in tensors[:P.n_fifos] if x is not None),
                      torch.device("cpu"))
        value_fault = torch.zeros(P.n_fifos, dtype=torch.int32, device=device)
    if not io[P.io_yield + Y_PENDING]:
        zero_forwarded(table, tensors)
    elif value_fault is not None:
        a, in_en, out_en, wins, outw = step_windows(table, tensors, io)
        ins, outs = P.ports(a)
        for e, f, w in zip(in_en + out_en, ins + outs, wins + outw):
            if e and not P.fifo[f][F_CTRL]:
                _check_finite(P, value_fault, f, w)
                _check_domain(P, value_fault, f, w)
    ran = 0      # commands run so far

    def flush(commands: List[Command], upto: int) -> None:
        nonlocal ran
        todo = [c for c in commands[ran:] if c.seq <= upto]
        execute(table, tensors, todo, value_fault, io)
        ran += len(todo)

    commands = schedule(table, tensors, io, max_sweeps, multi_firing,
                        guards=guards, trace_ring=trace_ring, flush=flush)
    execute(table, tensors, commands[ran:], value_fault, io)
    if value_fault is not None:
        for f, bits in enumerate(value_fault.tolist()):
            io[P.io_fault + f] |= bits
