"""Fault injection: corrupt a network state the way real bugs would.

The chaos half of the health layer's proof (``core/health.py``): each
injector takes a valid :class:`~repro_torch.core.network.NetworkState` and
returns a copy corrupted like one bug class would corrupt it, so a guarded
run must raise a :class:`~repro_torch.core.health.NetworkFaultError` naming
the channel, on the host dynamic executor and on kernel B2 alike.

* :func:`inject_overflow` lowers a channel's occupancy counter: the
  scheduler believes there is room, the producer writes past the Eq. 1
  bound, and the write guard sees the true (cursor-derived) occupancy
  exceed it.
* :func:`inject_underflow` raises the counter: the consumer fires on
  tokens that do not exist.
* :func:`corrupt_cursor` offsets rd/wr/occ (a stuck bit or torn update):
  any inconsistency trips ``CURSOR_INVALID`` on the channel's next visit.
* :func:`poison_tokens` appends a NaN window with consistent cursors, so
  the only flag the run can raise is ``NONFINITE``.
* :func:`truncate_feed` drops trailing windows from a host stream.

Injectors never touch the network, only a state, and leave their input
unchanged.  The serving injectors corrupt a staged serving workload
(``graphs/serving.py``'s ``ServingWorkload``) instead and return a copy:

* :func:`poison_request` writes an out-of-domain value into one request's
  prompt row, so a guarded run flags ``DOMAIN`` where admission writes it
  and ``ActorEngine(on_fault="quarantine")`` retires the request;
* :func:`expire_deadline` gives one request a deadline already past, so
  admission retires it as a timeout (a policy outcome, no fault).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.network import Network, NetworkState


def _fifo_index(network: Network, fifo: str) -> int:
    if fifo not in network.fifo_index:
        raise ValueError(
            f"unknown channel {fifo!r}; known: {sorted(network.fifos)}")
    return network.fifo_index[fifo]


def _offset(network: Network, state: NetworkState, fifo: str,
            rd: int = 0, wr: int = 0, occ: int = 0) -> NetworkState:
    fi = _fifo_index(network, fifo)
    out = state.clone()
    fs = out.fifos[fi]
    fs.rd, fs.wr, fs.occ = fs.rd + int(rd), fs.wr + int(wr), fs.occ + int(occ)
    return out


def inject_overflow(network: Network, state: NetworkState, fifo: str,
                    by: Optional[int] = None) -> NetworkState:
    """Lower ``fifo``'s occupancy counter by ``by`` tokens (default one
    window, ``rate``), rd/wr untouched: the producer's next spurious room
    check writes past the Eq. 1 bound (``OVERFLOW`` and
    ``CURSOR_INVALID``)."""
    _fifo_index(network, fifo)
    spec = network.fifos[fifo]
    return _offset(network, state, fifo,
                   occ=-(spec.rate if by is None else int(by)))


def inject_underflow(network: Network, state: NetworkState, fifo: str,
                     by: Optional[int] = None) -> NetworkState:
    """Raise ``fifo``'s occupancy counter by ``by`` tokens (default one
    window): the consumer fires on tokens the cursors say are not there
    (``UNDERFLOW`` and ``CURSOR_INVALID``)."""
    _fifo_index(network, fifo)
    spec = network.fifos[fifo]
    return _offset(network, state, fifo,
                   occ=spec.rate if by is None else int(by))


def corrupt_cursor(network: Network, state: NetworkState, fifo: str,
                   rd: int = 0, wr: int = 0, occ: int = 0) -> NetworkState:
    """Offset ``fifo``'s cursors additively; any combination that breaks
    ``occ == delay + (wr - rd) * rate`` trips ``CURSOR_INVALID`` on the
    channel's next read or write, fired or not."""
    return _offset(network, state, fifo, rd=rd, wr=wr, occ=occ)


def poison_tokens(network: Network, state: NetworkState, fifo: str,
                  value: float = float("nan")) -> NetworkState:
    """Append one window of ``value`` (NaN by default) to ``fifo`` with a
    consistent cursor advance: a producer emitting garbage, not a
    scheduling bug.  Needs a float channel with room for one window."""
    fi = _fifo_index(network, fifo)
    spec = network.fifos[fifo]
    if not spec.dtype.is_floating_point:
        raise ValueError(
            f"poison_tokens: channel {fifo!r} carries {spec.dtype} tokens; "
            "non-finite poison needs a float channel")
    fs = state.fifos[fi]
    if fs.occ + spec.rate > spec.writable_occupancy_bound:
        raise ValueError(
            f"poison_tokens: channel {fifo!r} has no room for a poison "
            f"window (occupancy {fs.occ} / bound "
            f"{spec.writable_occupancy_bound}); drain it first")
    out = state.clone()
    window = torch.full((spec.rate,) + tuple(spec.token_shape), value,
                        dtype=spec.dtype, device=fs.buf.device)
    spec.write(out.fifos[fi], window)
    return out


def truncate_feed(feeds: Mapping[str, Any], fifo: str,
                  drop: int = 1) -> Dict[str, Any]:
    """Drop the last ``drop`` windows of one channel's host stream (a
    truncated capture)."""
    if fifo not in feeds:
        raise ValueError(
            f"truncate_feed: no feed named {fifo!r}; feeds: "
            f"{sorted(feeds)}")
    out = dict(feeds)
    arr = out[fifo]
    n = int(arr.shape[0])
    if drop < 0 or drop > n:
        raise ValueError(f"truncate_feed: cannot drop {drop} of {n} windows")
    out[fifo] = arr[:n - drop] if isinstance(arr, torch.Tensor) else np.asarray(arr)[:n - drop]
    return out


# --------------------------------------------------------------------- #
# Serving-level injectors: corrupt the staged workload, not a ring.
# --------------------------------------------------------------------- #
POISON_VALUE = -(2 ** 20)


def _check_slot(workload, slot: int) -> int:
    n = int(np.asarray(workload.prompts).shape[0])
    if not 0 <= slot < n:
        raise ValueError(
            f"request slot {slot} out of range for a workload of {n} requests")
    return slot


def poison_request(workload, slot: int, value: int = POISON_VALUE):
    """Poison one staged request's prompt row with an out-of-domain value
    (a corrupted or adversarial request).  Every slot-table channel
    declares ``SLOT_DOMAIN``, so a guarded run flags ``DOMAIN`` the moment
    admission writes the row; ``faulted_requests`` maps the fault back to
    this slot."""
    from repro_torch.graphs.serving import SLOT_DOMAIN
    _check_slot(workload, slot)
    lo, hi = SLOT_DOMAIN
    if lo <= value <= hi:
        raise ValueError(
            f"poison_request: value {value} is inside SLOT_DOMAIN {SLOT_DOMAIN}; "
            "an in-domain value is not a poison")
    prompts = np.array(workload.prompts, np.int32, copy=True)
    prompts[slot, :] = value
    return dataclasses.replace(workload, prompts=prompts)


def expire_deadline(workload, slot: int, at: int = 0):
    """Give one staged request a deadline already past: it expires before
    step ``at`` (default 0, before the network's first firing).  Admission
    retires it as a ``STATUS_TIMEOUT`` rate-0 firing the first step it has
    both arrived and expired; no fault is raised."""
    from repro_torch.graphs.serving import NO_DEADLINE
    _check_slot(workload, slot)
    deadlines = (np.array(workload.deadlines, np.int32, copy=True)
                 if workload.deadlines is not None
                 else np.full((np.asarray(workload.prompts).shape[0],), NO_DEADLINE,
                              np.int32))
    deadlines[slot] = at - 1
    return dataclasses.replace(workload, deadlines=deadlines)
