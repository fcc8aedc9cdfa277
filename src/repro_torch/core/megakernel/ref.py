"""The plain PyTorch version of kernel B2 (``csrc/megakernel.cu``).

:func:`run_program` runs a :class:`~.program.DeviceProgram` the way the
kernel does: it reads the same packed table and the same io words, and
never calls the network's Python bodies.  The loop is the kernel's and the
host dynamic executor's (``executor.run_dynamic``):

* sweeps in the program's visit order until one fires nothing, or
  ``max_sweeps``;
* per visit up to ``_max_fireable`` firings (cap 8), each guarded by
  ``_can_fire`` on the rate table, the control token peeked first;
* masked ring reads and writes at the reference's offsets
  (``src/repro/core/megakernel/kernel.py:151-214``): a delay channel writes
  one slot further on and, after an enabled phase-2 write, copies slot
  ``3r`` back to slot 0 (Fig. 2);
* op bodies in plain torch: window copies (byte for byte, through the
  source's and sink's slab descriptors), ``poly_ref`` for Poly, the adder
  as ``add_`` from zeros in its terms' order, and motion detection's
  ``gauss5x5_u8_ref``, ``thres_ref`` and ``med_ref`` with the u8 rounding.

Every tensor it is given is updated in place and ``io`` is rewritten, as
the kernel rewrites its argument block.  The megakernel backend runs it for
CPU states; ``chip_smoke.py`` runs it on the card as the kernel's oracle.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

import struct

from repro_torch.core.megakernel.program import (
    A_AUX, A_CTRL, A_DHI, A_DLO, A_FPARAM, A_IN, A_KIND, A_N0, A_NAUX, A_NIN,
    A_NOUT, A_ORDER, A_OUT, A_PLANES, A_PTR0, A_PTR1, A_RATES, A_READY,
    A_SCALAR, ACTOR_FIELDS, ERR_DOMAIN, ERR_SLAB, F_BOUND, F_CBASE, F_CTRL,
    F_DELAY, F_FWD, F_NPH, F_RATE, FIFO_FIELDS, H_ACTOR_OFF, H_FIFO_OFF,
    H_N_ACTORS, H_N_CTRL, H_N_FIFOS, H_N_SCALARS, H_N_VISIT, H_VISIT_OFF,
    KIND_CODES, M_ERR_ACTOR, M_ERR_VALUE, M_ERROR, M_STALLED, M_SWEEPS)
from repro_torch.kernels.dyn_fir.ref import poly_ref
from repro_torch.kernels.gauss5x5.ref import gauss5x5_u8_ref, to_u8
from repro_torch.kernels.motion_post.ref import med_ref, thres_ref

#: The reference's per-visit firing cap (``executor.py:31``).
MAX_FIRINGS_PER_VISIT = 8

SOURCE, CONFIG, FORK, POLY, ADDER, SINK, GAUSS, THRES, MED = (
    KIND_CODES[k] for k in ("source", "config", "fork", "poly", "adder",
                            "sink", "gauss", "thres", "med"))


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


class _Stop(Exception):
    """An error word was set; the run ends there, as the kernel's does."""


def run_program(table: Sequence[int], tensors: List[Optional[torch.Tensor]],
                io: List[int], max_sweeps: int, multi_firing: bool) -> None:
    """Run the device program to quiescence on ``tensors`` (rings, then
    actor tensors) and ``io`` (the io block), in place."""
    t = [int(v) for v in table]
    n_fifos, n_actors = t[H_N_FIFOS], t[H_N_ACTORS]
    fifo = [t[t[H_FIFO_OFF] + FIFO_FIELDS * i:][:FIFO_FIELDS]
            for i in range(n_fifos)]
    actor = [t[t[H_ACTOR_OFF] + ACTOR_FIELDS * a:][:ACTOR_FIELDS]
             for a in range(n_actors)]
    visit = t[t[H_VISIT_OFF]:t[H_VISIT_OFF] + t[H_N_VISIT]]
    rings = tensors[:n_fifos]
    aptr = tensors[n_fifos:]
    io_scal = 3 * n_fifos
    io_ctrl = io_scal + 2 * t[H_N_SCALARS]
    io_counts = io_ctrl + t[H_N_CTRL]
    io_meta = io_counts + n_actors
    schedules = {a: aptr[actor[a][A_PTR0]].tolist()
                 for a in range(n_actors) if actor[a][A_KIND] == CONFIG}

    def occ(f: int) -> int:
        return io[3 * f + 2]

    def rd_off(f: int) -> int:
        return read_offset(fifo[f], io[3 * f])

    def wr_off(f: int) -> int:
        return write_offset(fifo[f], io[3 * f + 1])

    def ports(a: int):
        r = actor[a]
        return (t[r[A_IN]:r[A_IN] + r[A_NIN]], t[r[A_OUT]:r[A_OUT] + r[A_NOUT]])

    def rates(a: int) -> List[int]:
        """0/1 per port (inputs, then outputs); peeks the control token."""
        r = actor[a]
        n = r[A_NIN] + r[A_NOUT]
        if r[A_CTRL] < 0:
            return [1] * n
        c = r[A_CTRL]
        tok = io[io_ctrl + fifo[c][F_CBASE] + rd_off(c)]
        if not r[A_DLO] <= tok <= r[A_DHI]:
            io[io_meta + M_ERROR] = ERR_DOMAIN
            io[io_meta + M_ERR_ACTOR] = a
            io[io_meta + M_ERR_VALUE] = tok
            raise _Stop
        row = r[A_RATES] + (tok - r[A_DLO]) * n
        return t[row:row + n]

    def can_fire(a: int) -> bool:
        r = actor[a]
        if r[A_READY] >= 0 and io[io_scal + 2 * r[A_SCALAR]] >= r[A_READY]:
            return False
        if r[A_CTRL] >= 0 and occ(r[A_CTRL]) < 1:
            return False
        en = rates(a)
        ins, outs = ports(a)
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
        ins, outs = ports(a)
        for f in ins:
            k = min(k, occ(f) // fifo[f][F_RATE])
        for f in outs:
            k = min(k, (fifo[f][F_BOUND] - occ(f)) // fifo[f][F_RATE])
        return k

    def fire(a: int) -> None:
        r = actor[a]
        en = rates(a)
        if r[A_CTRL] >= 0:                       # consume the control token
            c = r[A_CTRL]
            io[3 * c] += 1
            io[3 * c + 2] -= 1
        ins, outs = ports(a)
        in_off = []
        for e, f in zip(en, ins):
            in_off.append(rd_off(f))
            if e:
                io[3 * f] += 1
                io[3 * f + 2] -= fifo[f][F_RATE]
        out_en = en[len(ins):]
        out_off = [wr_off(f) for f in outs]
        if r[A_CTRL] < 0 or not en or any(en):
            body(a, ins, outs, en[:len(ins)], out_en, in_off, out_off)
        for e, f in zip(out_en, outs):
            if e:
                copy_back(rings[f], fifo[f], io[3 * f + 1])
                io[3 * f + 1] += 1
                io[3 * f + 2] += fifo[f][F_RATE]
        io[io_counts + a] += 1

    def body(a, ins, outs, in_en, out_en, in_off, out_off) -> None:
        r = actor[a]
        kind = r[A_KIND]
        win = [rings[f][o:o + fifo[f][F_RATE]] for f, o in zip(ins, in_off)]
        dst = [None if fifo[f][F_CTRL] else rings[f][o:o + fifo[f][F_RATE]]
               for f, o in zip(outs, out_off)]
        if kind in (SOURCE, CONFIG, SINK):
            s = io_scal + 2 * r[A_SCALAR]
            idx = io[s]
            if kind != CONFIG and not 0 <= idx < io[s + 1]:
                io[io_meta + M_ERROR] = ERR_SLAB
                io[io_meta + M_ERR_ACTOR] = a
                io[io_meta + M_ERR_VALUE] = idx
                raise _Stop
            io[s] = idx + 1
        if kind in (SOURCE, SINK):
            # Plane p of window idx sits at p * stride + idx * wb of the slab.
            wb = r[A_N0]
            stride = io[s + 1] * wb
            slab = _bytes(aptr[r[A_PTR0]])
            ring = _bytes(dst[0] if kind == SOURCE else win[0])
            for p in range(r[A_PLANES]):
                at = p * stride + idx * wb
                if kind == SINK:
                    slab[at:at + wb].copy_(ring[p * wb:(p + 1) * wb])
                elif out_en[0]:
                    ring[p * wb:(p + 1) * wb].copy_(slab[at:at + wb])
        elif kind == CONFIG:
            sched = schedules[a]
            value = sched[min(max(idx, 0), r[A_AUX] - 1)]
            for e, f, o in zip(out_en, outs, out_off):
                if e:
                    io[io_ctrl + fifo[f][F_CBASE] + o] = value
        elif kind == FORK:
            for e, d in zip(out_en, dst):
                if e:
                    d.copy_(win[0])
        elif kind == POLY:
            hist = aptr[r[A_PTR0]]
            y, nxt = poly_ref(hist, win[0][0], aptr[r[A_PTR1]], r[A_ORDER])
            hist.copy_(nxt)
            if out_en[0]:
                dst[0][0].copy_(y)
        elif kind == ADDER:
            acc = torch.zeros_like(win[0])
            for k in t[r[A_AUX]:r[A_AUX] + r[A_NAUX]]:
                if in_en[k]:
                    acc.add_(win[k])
            if out_en[0]:
                dst[0].copy_(acc)
        elif kind == GAUSS:
            out = gauss5x5_u8_ref(win[0])
            for e, d in zip(out_en, dst):
                if e:
                    d.copy_(out)
        elif kind == THRES:
            threshold = struct.unpack("<f", struct.pack("<i", r[A_FPARAM]))[0]
            if out_en[0]:
                dst[0].copy_(to_u8(thres_ref(win[0].to(torch.float32),
                                             win[1].to(torch.float32),
                                             threshold)))
        elif kind == MED:
            if out_en[0]:
                dst[0].copy_(to_u8(med_ref(win[0].to(torch.float32))))

    for f in range(n_fifos):                     # the dead-slot rule
        if fifo[f][F_FWD] and not fifo[f][F_CTRL]:
            _bytes(rings[f]).zero_()
    sweeps = 0
    fired_any = True
    try:
        while fired_any and sweeps < max_sweeps:
            fired_any = False
            for a in visit:
                k = max_fireable(a) if multi_firing else 1
                for _ in range(k):
                    if not can_fire(a):
                        break
                    fire(a)
                    fired_any = True
            sweeps += 1
    except _Stop:
        pass
    io[io_meta + M_SWEEPS] = sweeps
    io[io_meta + M_STALLED] = int(fired_any and sweeps >= max_sweeps)
