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
  (``src/repro/core/megakernel/kernel.py:151-214``);
* op bodies in plain torch: window copies, ``poly_ref`` for Poly, and the
  adder as ``add_`` from zeros in its terms' order.

Every tensor it is given is updated in place and ``io`` is rewritten, as
the kernel rewrites its argument block.  The megakernel backend runs it for
CPU states; ``chip_smoke.py`` runs it on the card as the kernel's oracle.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.megakernel.program import (
    A_AUX, A_CTRL, A_DHI, A_DLO, A_IN, A_KIND, A_NAUX, A_NIN, A_NOUT, A_ORDER,
    A_OUT, A_PTR0, A_PTR1, A_RATES, A_READY, A_SCALAR, ACTOR_FIELDS,
    ERR_DOMAIN, ERR_SLAB, F_BOUND, F_CBASE, F_CTRL, F_FWD, F_NPH, F_RATE,
    FIFO_FIELDS, H_ACTOR_OFF, H_FIFO_OFF, H_L, H_N_ACTORS, H_N_CTRL,
    H_N_FIFOS, H_N_SCALARS, H_N_VISIT, H_VISIT_OFF, KIND_CODES, M_ERR_ACTOR, M_ERR_VALUE,
    M_ERROR, M_STALLED, M_SWEEPS)
from repro_torch.kernels.dyn_fir.ref import poly_ref

#: The reference's per-visit firing cap (``executor.py:31``).
MAX_FIRINGS_PER_VISIT = 8

SOURCE, CONFIG, FORK, POLY, ADDER, SINK = (
    KIND_CODES[k] for k in ("source", "config", "fork", "poly", "adder", "sink"))


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
    L = t[H_L]
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
        return (io[3 * f] % fifo[f][F_NPH]) * fifo[f][F_RATE]

    def wr_off(f: int) -> int:
        return (io[3 * f + 1] % fifo[f][F_NPH]) * fifo[f][F_RATE]

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
                io[3 * f + 1] += 1
                io[3 * f + 2] += fifo[f][F_RATE]
        io[io_counts + a] += 1

    def body(a, ins, outs, in_en, out_en, in_off, out_off) -> None:
        r = actor[a]
        kind = r[A_KIND]
        win = [rings[f][o] for f, o in zip(ins, in_off)]
        dst = [None if fifo[f][F_CTRL] else rings[f][o]
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
        if kind == SOURCE:
            if out_en[0]:
                dst[0].copy_(aptr[r[A_PTR0]][:, idx * L:(idx + 1) * L])
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
            y, nxt = poly_ref(hist, win[0], aptr[r[A_PTR1]], r[A_ORDER])
            hist.copy_(nxt)
            if out_en[0]:
                dst[0].copy_(y)
        elif kind == ADDER:
            acc = torch.zeros_like(win[0])
            for k in t[r[A_AUX]:r[A_AUX] + r[A_NAUX]]:
                if in_en[k]:
                    acc.add_(win[k])
            if out_en[0]:
                dst[0].copy_(acc)
        elif kind == SINK:
            aptr[r[A_PTR0]][:, idx * L:(idx + 1) * L].copy_(win[0])

    for f in range(n_fifos):                     # the dead-slot rule
        if fifo[f][F_FWD] and not fifo[f][F_CTRL]:
            rings[f].zero_()
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
