"""Runtime health layer: per-channel fault flags and host-side diagnostics.

The run-time half of the reference's health layer (``core/health.py``; the
build-time half is ``NetworkBuilder.check_bounds``):

* a packed per-channel **fault word** (:data:`OVERFLOW`,
  :data:`UNDERFLOW`, :data:`CURSOR_INVALID`, :data:`NONFINITE`,
  :data:`STALL`, :data:`DOMAIN`) and per-channel **high-water marks** of
  the true occupancy, collected by the host dynamic executor and by kernel
  B2 (and its plain version) when ``ExecutionPlan(guards=True)``;
* the guard predicates evaluated next to every channel operation, from
  the PRE-op cursors: :func:`read_guard_bits` / :func:`write_guard_bits`
  on host ints and tensors.  The cursor guards recompute the true
  occupancy ``delay + (wr - rd) * rate`` from the monotonic rd/wr cursors,
  so a corrupted occupancy counter is itself detected;
* the decode into :class:`Diagnostics` / :class:`NetworkFaultError`,
  naming the channel and its endpoint actors, and the stall forensics
  (:func:`diagnose_stall`) of a run that left through ``max_sweeps``.

Guards observe, they never change an operation: a faulty operation goes
ahead and is reported, and a clean guarded run is bit-identical to an
unguarded one.

In the port, cursors are host ints (``core/fifo.py``), so the cursor
guards cost no device work.  NONFINITE and DOMAIN read token values: for
data rings on the card :class:`HealthState` ORs them into a device int32
vector (``value_fault``) without a host sync, read once when the run ends.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

# The packed fault word: one int32 per channel, bits OR-ed over the run.
# STALL is a run-level condition and appears only in the host decode.
OVERFLOW = 1        # enabled write past the Eq. 1 writable occupancy bound
UNDERFLOW = 2       # enabled read from a channel with < rate true tokens
CURSOR_INVALID = 4  # occ counter disagrees with delay + (wr - rd) * rate
NONFINITE = 8       # NaN/Inf in an enabled window (float channels only)
STALL = 16          # sweep loop exhausted max_sweeps with work remaining
DOMAIN = 32         # enabled window outside the channel's declared domain

FAULT_NAMES = {
    OVERFLOW: "OVERFLOW",
    UNDERFLOW: "UNDERFLOW",
    CURSOR_INVALID: "CURSOR_INVALID",
    NONFINITE: "NONFINITE",
    STALL: "STALL",
    DOMAIN: "DOMAIN",
}

Bits = Union[int, torch.Tensor]


def fault_names(bits: int) -> Tuple[str, ...]:
    """Decode a packed fault word into its set-bit names."""
    return tuple(name for bit, name in sorted(FAULT_NAMES.items())
                 if bits & bit)


def true_occupancy(spec, rd, wr):
    """Occupancy from the monotonic cursors alone: ``delay`` initial tokens
    plus ``rate`` per write not yet read."""
    return spec.delay + (wr - rd) * spec.rate


def int_domain(spec) -> Tuple[int, int]:
    """A channel's declared domain as the reference compares it with
    integer tokens (each bound cast to the token type, truncating), or the
    whole int32 range when it declares none."""
    if spec.domain is None:
        return -2 ** 31, 2 ** 31 - 1
    return int(spec.domain[0]), int(spec.domain[1])


def _cursor_bits(spec, rd: int, wr: int, occ: int) -> Tuple[int, int]:
    t = true_occupancy(spec, rd, wr)
    return (CURSOR_INVALID if occ != t else 0), t


def value_bits(spec, values: torch.Tensor, enabled) -> Bits:
    """NONFINITE | DOMAIN of one window, 0 when ``enabled`` is off.  A
    host window (a control ring) gives an int; a window on the card a 0-d
    int32 tensor on its device, with no host sync."""
    if not enabled:
        return 0
    if values.device.type == "cpu":
        bits = 0
        if values.dtype.is_floating_point and not bool(torch.isfinite(values).all()):
            bits |= NONFINITE
        if spec.domain is not None:
            lo, hi = _domain_bounds(spec, values)
            if not bool(((values >= lo) & (values <= hi)).all()):
                bits |= DOMAIN
        return bits
    bits = None
    if values.dtype.is_floating_point:
        bits = (~torch.isfinite(values)).any().to(torch.int32) * NONFINITE
    if spec.domain is not None:
        lo, hi = _domain_bounds(spec, values)
        dom = (~((values >= lo) & (values <= hi))).any().to(torch.int32) * DOMAIN
        bits = dom if bits is None else bits | dom
    return 0 if bits is None else bits


def _domain_bounds(spec, values: torch.Tensor):
    if values.dtype.is_floating_point:
        return spec.domain
    return int_domain(spec)


def read_guard_bits(spec, rd: int, wr: int, occ: int, enabled,
                    window: Optional[torch.Tensor]) -> Bits:
    """Fault bits of one (possibly masked) read, from the pre-op state.
    ``enabled`` gates UNDERFLOW and the value bits; CURSOR_INVALID is
    unconditional."""
    bits, t = _cursor_bits(spec, rd, wr, occ)
    if enabled and t < spec.rate:
        bits |= UNDERFLOW
    return bits if window is None else bits | value_bits(spec, window, enabled)


def write_guard_bits(spec, rd: int, wr: int, occ: int, enabled,
                     tokens: Optional[torch.Tensor]) -> Bits:
    """Fault bits of one (possibly masked) write, from the pre-op state."""
    bits, t = _cursor_bits(spec, rd, wr, occ)
    if enabled and t + spec.rate > spec.writable_occupancy_bound:
        bits |= OVERFLOW
    return bits if tokens is None else bits | value_bits(spec, tokens, enabled)


class HealthState:
    """Per-channel fault words and high-water marks of one run.

    ``fault`` and ``high_water`` are host int lists (the cursor guards run
    on host ints); ``value_fault`` is the device int32 vector the value
    guards OR into, read once by :meth:`fault_words`.  ``high_water[i]``
    is the largest true occupancy after any write the run attempted on
    channel ``i`` (enabled or not), so an overflow's size is visible even
    when the counter is what was corrupted.
    """

    def __init__(self, n_fifos: int, device: Optional[torch.device] = None,
                 fault=None, high_water=None) -> None:
        self.fault: List[int] = list(fault) if fault is not None else [0] * n_fifos
        self.high_water: List[int] = (list(high_water) if high_water is not None
                                      else [0] * n_fifos)
        self.value_fault = (torch.zeros(n_fifos, dtype=torch.int32, device=device)
                            if device is not None and torch.device(device).type != "cpu"
                            else None)

    def record(self, fi: int, bits: Bits) -> None:
        if isinstance(bits, int):
            self.fault[fi] |= bits
        else:
            self.value_fault[fi:fi + 1].bitwise_or_(bits)

    def mark_high_water(self, fi: int, occupancy: int) -> None:
        self.high_water[fi] = max(self.high_water[fi], occupancy)

    def fault_words(self) -> np.ndarray:
        """Every channel's fault word (one device read when values were
        guarded on the card)."""
        out = np.asarray(self.fault, np.int64)
        if self.value_fault is not None:
            out |= self.value_fault.cpu().numpy().astype(np.int64)
        return out


def init_health(n_fifos: int, device: Optional[torch.device] = None) -> HealthState:
    return HealthState(n_fifos, device)


# ----------------------------------------------------------------------- #
# Host-side decode.
# ----------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ChannelFault:
    """One faulting channel, named end to end."""

    fifo: str
    src_actor: str
    src_port: str
    dst_actor: str
    dst_port: str
    bits: int
    faults: Tuple[str, ...]
    high_water: int
    occupancy_bound: int

    def describe(self) -> str:
        return (f"channel {self.fifo!r} ({self.src_actor}.{self.src_port} -> "
                f"{self.dst_actor}.{self.dst_port}): "
                f"{', '.join(self.faults)} "
                f"[high-water {self.high_water} / bound "
                f"{self.occupancy_bound}]")


@dataclasses.dataclass(frozen=True)
class StallReport:
    """Forensics of a ``max_sweeps`` exhaustion: each non-fireable actor
    with its first blocking condition, the actors that could still fire,
    and the final occupancy of every channel."""

    runnable: Tuple[str, ...]
    blocked: Tuple[Tuple[str, str], ...]
    occupancy: Dict[str, int]

    def describe(self) -> str:
        parts = [f"{a}: {why}" for a, why in self.blocked]
        if self.runnable:
            parts.append(f"still runnable: {', '.join(self.runnable)}")
        return "; ".join(parts) if parts else "no actors blocked"


@dataclasses.dataclass(frozen=True)
class Diagnostics:
    """Host-decoded health of one run (``RunResult.diagnostics``)."""

    ok: bool
    stalled: bool
    faults: Tuple[ChannelFault, ...]
    high_water: Dict[str, int]
    stall: Optional[StallReport] = None

    def summary(self) -> str:
        if self.ok:
            return "healthy"
        parts = [f.describe() for f in self.faults]
        if self.stalled:
            msg = "STALL: sweep budget exhausted with work remaining"
            if self.stall is not None:
                msg += f" ({self.stall.describe()})"
            parts.append(msg)
        return "; ".join(parts)


class NetworkFaultError(RuntimeError):
    """A guarded run tripped at least one fault flag (or stalled); carries
    the :class:`Diagnostics` as ``.diagnostics`` and, from ``Program.run``,
    the partial :class:`~repro_torch.core.program.RunResult` as
    ``.result``."""

    def __init__(self, diagnostics: Diagnostics):
        self.diagnostics = diagnostics
        super().__init__(f"network fault: {diagnostics.summary()}")


def decode_health(network, health: Optional[HealthState], stalled: bool,
                  state=None) -> Diagnostics:
    """Decode a run's health into named diagnostics.  With ``health=None``
    (guards off) only the stall is decoded; ``state`` (the final state)
    feeds the stall forensics."""
    names = list(network.fifos)
    if health is None:
        fault = np.zeros((len(names),), np.int64)
        hw = np.zeros((len(names),), np.int64)
    else:
        fault = health.fault_words()
        hw = np.asarray(health.high_water, np.int64)
    faults = []
    for i, name in enumerate(names):
        bits = int(fault[i])
        if not bits:
            continue
        spec = network.fifos[name]
        e = network.edge_of(name)
        faults.append(ChannelFault(
            fifo=name, src_actor=e.src_actor, src_port=e.src_port,
            dst_actor=e.dst_actor, dst_port=e.dst_port, bits=bits,
            faults=fault_names(bits), high_water=int(hw[i]),
            occupancy_bound=spec.writable_occupancy_bound))
    stall = (diagnose_stall(network, state)
             if stalled and state is not None else None)
    high_water = ({} if health is None
                  else {name: int(hw[i]) for i, name in enumerate(names)})
    return Diagnostics(ok=not faults and not stalled, stalled=bool(stalled),
                       faults=tuple(faults), high_water=high_water,
                       stall=stall)


def diagnose_stall(network, state) -> StallReport:
    """Per-actor blocking analysis of a final state: the dynamic
    executor's ``_can_fire`` with each first blocking condition named."""
    occupancy = {name: int(state.fifos[i].occ)
                 for name, i in network.fifo_index.items()}
    runnable, blocked = [], []
    for name, a in network.actors.items():
        reason = None
        if a.ready is not None and not bool(
                a.ready(state.actors[network.actor_index[name]])):
            reason = "ready() gate closed (source feed exhausted?)"
        rates = None
        ctl = network.control_specs[name]
        if reason is None:
            if ctl is not None:
                cspec, ci = ctl
                if int(state.fifos[ci].occ) < 1:
                    reason = (f"starved on empty control channel "
                              f"{cspec.name!r}")
                else:
                    tok = cspec.peek(state.fifos[ci]).tolist()
                    rates = {p: int(v) for p, v in a.rates_for(tok).items()}
            else:
                rates = {p: int(v) for p, v in a.rates_for(None).items()}
        if reason is None:
            for p, spec, fi in network.in_port_specs[name]:
                if rates[p] and int(state.fifos[fi].occ) < spec.rate:
                    reason = (f"starved on empty channel {spec.name!r} "
                              f"(occupancy {int(state.fifos[fi].occ)}, "
                              f"needs {spec.rate})")
                    break
        if reason is None:
            for p, spec, fi in network.out_port_specs[name]:
                o = int(state.fifos[fi].occ)
                if rates[p] and o + spec.rate > spec.writable_occupancy_bound:
                    reason = (f"blocked on full channel {spec.name!r} "
                              f"(occupancy {o} / bound "
                              f"{spec.writable_occupancy_bound})")
                    break
        if reason is None:
            runnable.append(name)
        else:
            blocked.append((name, reason))
    return StallReport(runnable=tuple(runnable), blocked=tuple(blocked),
                       occupancy=occupancy)
