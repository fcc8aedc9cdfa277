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

Both update the state in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.network import Network, NetworkState
from repro_torch.core.schedule import validate_single_appearance

# Worst-case firings of one actor per multi-firing visit (the reference's
# bound: Eq. 1 caps a channel at 3 windows, 8 leaves slack).
_MAX_FIRINGS_PER_VISIT = 8


def _forwarded(regs: Dict[int, Optional[torch.Tensor]], fi: int, spec,
               name: str) -> Optional[torch.Tensor]:
    if fi not in regs:
        raise ValueError(
            f"fifo {spec.name}: consumer {name} fired before its producer "
            "in the specialized schedule — pass a topological order (or "
            "specialize=False)")
    return regs[fi]


def fire_actor(network: Network, name: str, state: NetworkState,
               regs: Optional[Dict[int, Optional[torch.Tensor]]] = None) -> None:
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
    """
    a = network.actors[name]
    fifos = state.fifos

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
            window = cspec.read(fifos[ci])
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
            windows[p] = spec.read_masked(st, en)

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
            spec.write_masked(fifos[fi], outputs.get(p), en)


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


def run_dynamic(network: Network, state: NetworkState,
                max_sweeps: int = 1_000_000, multi_firing: bool = True
                ) -> Tuple[NetworkState, Dict[str, int], int, bool]:
    """Sweep to quiescence in place.

    Returns ``(state, fire_counts, sweeps, stalled)``; ``stalled`` is True
    when the loop left through ``max_sweeps`` with work remaining.  Within
    a visit every firing is guarded by :func:`_can_fire`; a failed attempt
    leaves the state unchanged, so the rest of the visit's budget would
    fail too and the visit ends there.
    """
    names = list(network.actors)
    counts = {nm: 0 for nm in names}
    sweeps = 0
    fired_any = True
    while fired_any and sweeps < max_sweeps:
        fired_any = False
        for nm in names:
            k = _max_fireable(network, nm, state) if multi_firing else 1
            for _ in range(k):
                if not _can_fire(network, nm, state):
                    break
                fire_actor(network, nm, state)
                counts[nm] += 1
                fired_any = True
        sweeps += 1
    stalled = fired_any and sweeps >= max_sweeps
    return state, counts, sweeps, stalled


def collect_sink(network: Network, state: NetworkState, actor: str) -> Any:
    """Run an actor's ``finish`` hook on its final state (paper §3.1)."""
    a = network.actors[actor]
    st = state.actors[network.actor_index[actor]]
    return a.finish(st) if a.finish is not None else st
