"""Host-driven network executors — paper §3.3.

Two strategies with the reference's observable FIFO semantics, driven
eagerly from the host; the data they move lives on the network's device
and every Poly body is a kernel launch there:

1. **Static** single-appearance schedule (:func:`run_static`): each
   iteration fires every actor once in topological order, dynamic actors
   with their rate-0 ports frozen.  With ``specialize=True`` channels in
   ``Network.register_fifos`` forward their window producer -> consumer
   and never touch the ring; in eager torch that is all specialization
   means, since cursor offsets are host ints already.  So the port's
   specialized static mode also takes a phase-misaligned state (say,
   motion detection advanced one iteration, its delay ring mid-period),
   where the reference's raises and asks for ``specialize=False``: the
   reference bakes the phase offsets of one unroll period into its trace,
   the port reads them from the cursors.  ``specialize=False`` is also
   the reference's interpreted mode (``_run_interpreted``,
   ``src/repro/core/executor.py:686``, Table 3's multicore baseline): the
   reference jits each firing on its own there where its static mode
   traces the whole schedule, but the port fires eagerly either way.
2. **Dynamic** token-driven scheduler (:func:`run_dynamic`): sweeps visit
   every actor in declaration order, firing it while its blocking
   predicates hold (the control token peeked first), up to
   ``_MAX_FIRINGS_PER_VISIT`` per visit, until a sweep fires nothing.
   ``guards=True`` evaluates the health layer's guards next to every
   channel operation (``core/health.py``) and ``trace_capacity=N``
   records every firing attempt (``core/trace.py``); both observe and
   change nothing, and with both off the executor does what it did
   without them.

Both update the state in place.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.health import (HealthState, init_health, read_guard_bits,
                                     true_occupancy, write_guard_bits)
from repro_torch.core.network import Network, NetworkState
from repro_torch.core.schedule import validate_single_appearance
from repro_torch.core.trace import init_trace

# Worst-case firings of one actor per multi-firing visit (the reference's
# bound: Eq. 1 caps a channel at 3 windows, 8 leaves slack).
_MAX_FIRINGS_PER_VISIT = 8


class RuntimeMode(enum.Enum):
    PROPOSED = "proposed"        # this paper: dynamic rates allowed everywhere
    STATIC_DAL = "static_dal"    # reference framework: SDF only on the accelerator


def assert_mode_allows(network: Network, mode: RuntimeMode,
                       accelerated: Optional[List[str]] = None) -> None:
    """DAL's OpenCL path rejects dynamic actors (paper §2.3 / §4.3): under
    ``STATIC_DAL`` every accelerated actor (every actor when
    ``accelerated`` is None) must be static."""
    if mode is not RuntimeMode.STATIC_DAL:
        return
    accel = accelerated if accelerated is not None else list(network.actors)
    bad = [n for n in accel if network.actors[n].is_dynamic]
    if bad:
        raise ValueError(
            f"STATIC_DAL mode: dynamic-rate actors {bad} cannot be mapped to "
            "the accelerator (SDF-only reference framework); rewrite them "
            "statically or run them interpreted")


def _forwarded(regs: Dict[int, Optional[torch.Tensor]], fi: int, spec,
               name: str) -> Optional[torch.Tensor]:
    if fi not in regs:
        raise ValueError(
            f"fifo {spec.name}: consumer {name} fired before its producer "
            "in the specialized schedule — pass a topological order (or "
            "specialize=False)")
    return regs[fi]


def fire_actor(network: Network, name: str, state: NetworkState,
               regs: Optional[Dict[int, Optional[torch.Tensor]]] = None,
               health: Optional[HealthState] = None) -> None:
    """Fire actor ``name`` once, in place (paper §2.2 firing protocol).

    1. A dynamic actor consumes one control token; its control function
       pins every regular port to rate 0 or r.
    2. Enabled inputs are consumed (masked cursor advance).
    3. The body runs unless the actor is dynamic and every regular port is
       disabled: such a firing is still a firing (its control token is
       consumed and the caller counts it) but launches nothing.
    4. Enabled outputs are produced; a disabled write leaves the ring and
       its cursors untouched.

    ``regs`` (a per-iteration dict keyed by fifo index) turns on transient
    forwarding for ``network.register_fifos``: the producer's window is
    handed to the consumer and only the cursors move.  Callers guarantee
    the blocking preconditions.

    ``health`` arms the channel guards: each read and write ORs its fault
    bits, from the pre-op cursors and its window, into ``health``, and
    each write of the firing marks the channel's true occupancy after it.
    The guards ride the masked path only (``regs`` must be None).
    """
    a = network.actors[name]
    fifos = state.fifos
    if health is not None and regs is not None:
        raise ValueError(
            "fire_actor: health guards apply to the dynamic (masked-cursor) "
            "path; the static schedule proves its blocking bounds at build "
            "time")

    def is_reg(spec) -> bool:
        return regs is not None and spec.name in network.register_fifos

    ctrl_tok = None
    ctl = network.control_specs[name]
    if ctl is not None:
        cspec, ci = ctl
        if is_reg(cspec):
            window = _forwarded(regs, ci, cspec, name)
            fifos[ci].rd += 1
            fifos[ci].occ -= 1
        else:
            st = fifos[ci]
            pre = (st.rd, st.wr, st.occ)
            window = cspec.read(st)
            if health is not None:
                health.record(ci, read_guard_bits(cspec, *pre, 1, window))
        ctrl_tok = window[0].tolist()
    rates = a.rates_for(ctrl_tok)

    windows: Dict[str, Any] = {}
    for p, spec, fi in network.in_port_specs[name]:
        en = rates[p]
        st = fifos[fi]
        if is_reg(spec):
            win = _forwarded(regs, fi, spec, name)
            # A disabled producer forwarded nothing; the MoC leaves a
            # rate-0 window unspecified, so hand over the ring's slots.
            windows[p] = win if win is not None else spec.read_masked(st, 0)
            if en:
                st.rd += 1
                st.occ -= spec.rate
        else:
            pre = (st.rd, st.wr, st.occ)
            windows[p] = spec.read_masked(st, en)
            if health is not None:
                health.record(fi, read_guard_bits(spec, *pre, en, windows[p]))

    ports = (*a.in_ports, *a.out_ports)
    run_body = not a.is_dynamic or not ports or any(rates[p] for p in ports)
    aidx = network.actor_index[name]
    outputs: Dict[str, torch.Tensor] = {}
    if run_body:
        new_st, outs = a.fire(state.actors[aidx], windows, rates)
        missing = set(a.out_ports) - set(outs)
        if missing:
            raise ValueError(f"actor {name}: fire() missing outputs {sorted(missing)}")
        for p, spec, _ in network.out_port_specs[name]:
            outputs[p] = outs[p].reshape((spec.rate,) + tuple(spec.token_shape))
        state.actors[aidx] = new_st

    for p, spec, fi in network.out_port_specs[name]:
        en = rates[p]
        if is_reg(spec):
            regs[fi] = outputs[p] if en else None
            if en:
                fifos[fi].wr += 1
                fifos[fi].occ += spec.rate
        else:
            st = fifos[fi]
            if health is not None:
                health.record(fi, write_guard_bits(spec, st.rd, st.wr, st.occ,
                                                   en, outputs.get(p)))
                health.mark_high_water(fi, true_occupancy(spec, st.rd, st.wr)
                                       + (spec.rate if en else 0))
            spec.write_masked(st, outputs.get(p), en)


# --------------------------------------------------------------------------- #
# 1. Static single-appearance schedule.
# --------------------------------------------------------------------------- #
def run_static(network: Network, state: NetworkState, n_iterations: int,
               order: Optional[List[str]] = None,
               specialize: bool = True) -> NetworkState:
    """Fire the single-appearance schedule ``n_iterations`` times in place.

    ``specialize=True`` forwards the windows of register-allocated channels
    (their rings keep their initial contents, as in the reference); those
    channels must enter drained.
    """
    order = list(order) if order is not None else network.topological_order()
    validate_single_appearance(order, list(network.actors))
    network.check_schedule_feasible(order)
    if specialize:
        for fname in sorted(network.register_fifos):
            occ = state.fifos[network.fifo_index[fname]].occ
            if occ:
                raise ValueError(
                    f"static mode (specialize=True): transient fifo {fname} "
                    f"enters with occupancy {occ}; register-allocated "
                    "channels must be drained (start from Network.init_state "
                    "or pass specialize=False)")
    for _ in range(n_iterations):
        regs: Optional[Dict[int, Optional[torch.Tensor]]] = {} if specialize else None
        for nm in order:
            fire_actor(network, nm, state, regs)
    return state


# --------------------------------------------------------------------------- #
# 2. Token-driven dynamic scheduler.
# --------------------------------------------------------------------------- #
def _can_fire(network: Network, name: str, state: NetworkState) -> bool:
    """Blocking predicate of paper §2.2, without side effects; a dynamic
    actor's control token is peeked so its rates are known first."""
    a = network.actors[name]
    fifos = state.fifos
    if a.ready is not None and not a.ready(state.actors[network.actor_index[name]]):
        return False
    ctl = network.control_specs[name]
    if ctl is not None:
        cspec, ci = ctl
        if not cspec.can_peek(fifos[ci]):
            return False
        rates = a.rates_for(cspec.peek(fifos[ci]).tolist())
    else:
        rates = a.rates_for(None)
    for p, spec, fi in network.in_port_specs[name]:
        if rates[p] and not spec.can_read(fifos[fi]):
            return False
    for p, spec, fi in network.out_port_specs[name]:
        if rates[p] and not spec.can_write(fifos[fi]):
            return False
    return True


def _max_fireable(network: Network, name: str, state: NetworkState) -> int:
    """Occupancy bound on this visit's firings: the control channel's
    occupancy for a dynamic actor (rate-0 firings need no data tokens),
    ``min(occ // r, room // r)`` over the ports of a static one."""
    ctl = network.control_specs[name]
    if ctl is not None:
        return min(_MAX_FIRINGS_PER_VISIT, state.fifos[ctl[1]].occ)
    k = _MAX_FIRINGS_PER_VISIT
    for _, spec, fi in network.in_port_specs[name]:
        k = min(k, state.fifos[fi].occ // spec.rate)
    for _, spec, fi in network.out_port_specs[name]:
        k = min(k, (spec.writable_occupancy_bound - state.fifos[fi].occ) // spec.rate)
    return k


class DynamicResult(tuple):
    """``(state, fire_counts, sweeps, stalled)`` of a dynamic run, with the
    health layer's record as attributes: ``health`` (a
    :class:`~repro_torch.core.health.HealthState`, or None with guards
    off) and ``trace`` (a :class:`~repro_torch.core.trace.TraceState`, or
    None with tracing off)."""

    def __new__(cls, state, counts, sweeps, stalled, health=None, trace=None):
        self = tuple.__new__(cls, (state, counts, sweeps, stalled))
        self.health = health
        self.trace = trace
        return self


def run_dynamic(network: Network, state: NetworkState,
                max_sweeps: int = 1_000_000, multi_firing: bool = True,
                guards: bool = False, trace_capacity: Optional[int] = None
                ) -> DynamicResult:
    """Sweep to quiescence in place.

    Returns ``(state, fire_counts, sweeps, stalled)`` (a
    :class:`DynamicResult`); ``stalled`` is True when the loop left through
    ``max_sweeps`` with work remaining.  Within a visit every firing is
    guarded by :func:`_can_fire`; a failed attempt leaves the state
    unchanged, so the rest of the visit's budget would fail too and the
    visit ends there.

    ``guards=True`` collects the channel guards' fault words and
    high-water marks (``.health``): cursor guards on the host ints, value
    guards into one device vector read after the run.  ``trace_capacity``
    records one event per attempt into a ring of that many events
    (``.trace``); a visit's attempts after a failed one are recorded as
    skipped, as the reference attempts all of them.
    """
    names = list(network.actors)
    counts = {nm: 0 for nm in names}
    n_fifos = len(network.fifos)
    health = init_health(n_fifos, network.device) if guards else None
    trace = init_trace(n_fifos, trace_capacity) if trace_capacity else None

    def occs() -> List[int]:
        return [f.occ for f in state.fifos]

    sweeps = 0
    fired_any = True
    while fired_any and sweeps < max_sweeps:
        fired_any = False
        for nm in names:
            k = _max_fireable(network, nm, state) if multi_firing else 1
            for i in range(k):
                if not _can_fire(network, nm, state):
                    if trace is not None:
                        row = occs()
                        for _ in range(k - i):
                            trace.record(network.actor_index[nm], sweeps, 0, row)
                    break
                fire_actor(network, nm, state, health=health)
                counts[nm] += 1
                fired_any = True
                if trace is not None:
                    trace.record(network.actor_index[nm], sweeps, 1, occs())
        sweeps += 1
    stalled = fired_any and sweeps >= max_sweeps
    return DynamicResult(state, counts, sweeps, stalled, health, trace)


def collect_sink(network: Network, state: NetworkState, actor: str) -> Any:
    """Run an actor's ``finish`` hook on its final state (paper §3.1)."""
    a = network.actors[actor]
    st = state.actors[network.actor_index[actor]]
    return a.finish(st) if a.finish is not None else st
