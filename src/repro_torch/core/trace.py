"""Firing-level event tracing and occupancy profiling.

The timeline layer of the reference's ``core/trace.py``, shared by the
port's two dynamic backends:

* the **host dynamic executor** records one event per firing *attempt*
  (actor index, sweep, fired or skipped, every channel's occupancy after
  the attempt) into a host :class:`TraceState` ring;
* **kernel B2** (and its plain version) writes the same rows into a
  ``(capacity, 3 + n_fifos)`` int32 ring on the card under a monotonic
  event count, in its ``MK_TRACE`` build.

An attempt is what the reference counts: every one of the ``k`` attempts
of a visit, ``k`` the actor's occupancy bound at the start of the visit,
the skipped ones after a failed attempt included (they change no state, so
their occupancies repeat).  When a run outgrows the ring, the oldest
events are dropped and :attr:`Trace.dropped` counts them.

:func:`decode_trace` unwraps a ring into a :class:`Trace`, which exports
Chrome trace-event JSON (:meth:`Trace.to_perfetto`, checked by
:func:`validate_chrome_trace`) and derives a :class:`Profile`, whose
:meth:`Profile.as_cut_weights` feeds
``ExecutionPlan(cut_objective="profile", profile=...)``.

Event rows are int32 ``[actor_index, sweep, fired, occ_0..occ_{F-1}]``
(columns :data:`COL_ACTOR`, :data:`COL_SWEEP`, :data:`COL_FIRED`,
:data:`COL_OCC`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

#: Default trace-ring capacity in events (one event per firing attempt).
TRACE_CAPACITY_DEFAULT = 4096

# Event-row column layout (int32): [actor, sweep, fired, occ_0..occ_{F-1}].
COL_ACTOR, COL_SWEEP, COL_FIRED, COL_OCC = 0, 1, 2, 3


@dataclasses.dataclass
class TraceState:
    """A fixed-capacity event ring and the number of events ever recorded
    (``count > capacity``: the ring wrapped and the oldest ``count -
    capacity`` events are gone).  ``ring`` is ``(capacity, 3 + n_fifos)``
    int32: a host numpy array on the host executor, a tensor on the card
    from B2."""

    ring: Union[np.ndarray, torch.Tensor]
    count: int = 0

    def record(self, actor_index: int, sweep: int, fired: int,
               occs: Sequence[int]) -> None:
        """Append one event row in place (wraps when full)."""
        row = self.ring[self.count % self.ring.shape[0]]
        row[COL_ACTOR] = actor_index
        row[COL_SWEEP] = sweep
        row[COL_FIRED] = fired
        row[COL_OCC:] = occs
        self.count += 1


def init_trace(n_fifos: int, capacity: int = TRACE_CAPACITY_DEFAULT
               ) -> TraceState:
    """Empty host trace ring for a network with ``n_fifos`` channels."""
    return TraceState(ring=np.zeros((int(capacity), COL_OCC + int(n_fifos)),
                                    np.int32))


# --------------------------------------------------------------------------- #
# Host-side decoded trace.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Trace:
    """Chronologically ordered firing events, decoded on host."""

    actor_names: Tuple[str, ...]
    fifo_names: Tuple[str, ...]
    #: ``(n_events, 3 + n_fifos)`` int32 — see the COL_* constants.
    events: np.ndarray
    capacity: int
    dropped: int = 0
    wall_time_s: Optional[float] = None
    #: Static per-actor cost estimates (flops), for wall-clock attribution.
    actor_flops: Tuple[int, ...] = ()
    #: Per-channel token sizes (bytes), for churn-in-bytes profiles.
    fifo_token_bytes: Tuple[int, ...] = ()
    #: Core index per actor under grid partitioning (None = single core).
    actor_cores: Optional[Tuple[int, ...]] = None

    @property
    def n_events(self) -> int:
        return int(self.events.shape[0])

    def firing_counts(self) -> Dict[str, int]:
        """Events with ``fired == 1`` per actor (drops excluded)."""
        fired = self.events[self.events[:, COL_FIRED] == 1, COL_ACTOR]
        return {nm: int((fired == i).sum())
                for i, nm in enumerate(self.actor_names)}

    def attempt_counts(self) -> Dict[str, int]:
        """All recorded attempts (fired + skipped) per actor."""
        return {nm: int((self.events[:, COL_ACTOR] == i).sum())
                for i, nm in enumerate(self.actor_names)}

    def occupancy(self, fifo: str) -> np.ndarray:
        """The sampled occupancy series of one channel, in event order."""
        return self.events[:, COL_OCC + self.fifo_names.index(fifo)]

    def extend(self, other: "Trace") -> "Trace":
        """Concatenate a later chunk's trace onto this one (stream use):
        the other trace's sweep numbers are offset past this trace's
        last sweep so the merged timeline stays monotonic."""
        if (other.actor_names != self.actor_names
                or other.fifo_names != self.fifo_names):
            raise ValueError("Trace.extend: traces come from different "
                             "networks")
        offset = (int(self.events[:, COL_SWEEP].max()) + 1
                  if self.n_events else 0)
        ev = other.events.copy()
        ev[:, COL_SWEEP] += offset
        wall = None
        if self.wall_time_s is not None or other.wall_time_s is not None:
            wall = (self.wall_time_s or 0.0) + (other.wall_time_s or 0.0)
        return dataclasses.replace(
            self, events=np.concatenate([self.events, ev], axis=0),
            dropped=self.dropped + other.dropped, wall_time_s=wall)

    # ------------------------------------------------------------------ #
    def profile(self) -> "Profile":
        """Derive measured per-actor costs and per-channel churn."""
        firings = self.firing_counts()
        # Wall-clock attribution: the run's wall time split over actors in
        # proportion to firings x static flops (one clock around the whole
        # run; none per firing).  Without a wall time the cost stays None
        # and as_cut_weights uses the same firings x flops weights.
        flops = {nm: max(1, int(f)) for nm, f in
                 zip(self.actor_names, self.actor_flops or
                     (1,) * len(self.actor_names))}
        weight = {nm: firings.get(nm, 0) * flops[nm]
                  for nm in self.actor_names}
        total_w = sum(weight.values())
        cost_s: Optional[Dict[str, float]] = None
        if self.wall_time_s is not None and total_w > 0:
            cost_s = {}
            for nm in self.actor_names:
                n = firings.get(nm, 0)
                cost_s[nm] = (self.wall_time_s * weight[nm] / total_w / n
                              if n else 0.0)
        # Occupancy churn: total |delta occ| between consecutive samples,
        # scaled to bytes by the channel token size — a measured stand-in
        # for "traffic through this channel" that a crossing cut wants to
        # keep inside one core.
        tok_bytes = (self.fifo_token_bytes or
                     (1,) * len(self.fifo_names))
        churn: Dict[str, int] = {}
        for i, nm in enumerate(self.fifo_names):
            occ = self.events[:, COL_OCC + i].astype(np.int64)
            delta = int(np.abs(np.diff(occ)).sum()) if len(occ) > 1 else 0
            churn[nm] = delta * max(1, int(tok_bytes[i]))
        return Profile(actor_names=self.actor_names,
                       firing_counts=firings, actor_flops=flops,
                       actor_cost_s=cost_s, channel_churn_bytes=churn,
                       wall_time_s=self.wall_time_s, dropped=self.dropped)

    # ------------------------------------------------------------------ #
    def to_perfetto(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing).

        One thread track per actor — named ``actor [core k]`` under grid
        partitioning — plus one counter track per channel (``occ:name``,
        emitted on change).  Fired attempts are complete ("X") slices,
        skipped attempts thread-scoped instants ("i").  Event timestamps
        are event-ordinal microseconds scaled so the timeline spans the
        measured wall time when one exists.
        """
        n = self.n_events
        scale = (self.wall_time_s * 1e6 / n
                 if self.wall_time_s and n else 1.0)
        ev: List[dict] = [{"name": "process_name", "ph": "M", "pid": 0,
                           "tid": 0, "args": {"name": "actor network"}}]
        for i, nm in enumerate(self.actor_names):
            label = nm
            if self.actor_cores is not None:
                label = f"{nm} [core {self.actor_cores[i]}]"
            ev.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": i + 1, "args": {"name": label}})
        prev_occ: Dict[str, int] = {}
        for k in range(n):
            row = self.events[k]
            ts = k * scale
            a = int(row[COL_ACTOR])
            base = {"cat": "firing", "pid": 0, "tid": a + 1, "ts": ts,
                    "args": {"sweep": int(row[COL_SWEEP])}}
            if int(row[COL_FIRED]):
                ev.append({"name": self.actor_names[a], "ph": "X",
                           "dur": scale, **base})
            else:
                ev.append({"name": f"{self.actor_names[a]} (skipped)",
                           "ph": "i", "s": "t", **base})
            for i, fnm in enumerate(self.fifo_names):
                occ = int(row[COL_OCC + i])
                if prev_occ.get(fnm) != occ:
                    prev_occ[fnm] = occ
                    ev.append({"name": f"occ:{fnm}", "ph": "C", "pid": 0,
                               "ts": ts, "args": {"tokens": occ}})
        doc = {"traceEvents": ev, "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self.dropped,
                             "capacity": self.capacity,
                             "wall_time_s": self.wall_time_s}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def merge_traces(traces: Sequence[Trace]) -> Optional[Trace]:
    """Fold per-chunk traces into one stream-long trace (sweep offsets
    applied chunk by chunk); None when the sequence is empty."""
    traces = [t for t in traces if t is not None]
    if not traces:
        return None
    out = traces[0]
    for t in traces[1:]:
        out = out.extend(t)
    return out


# --------------------------------------------------------------------------- #
# Derived profile -> partition weights.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Profile:
    """Measured per-actor cost and per-channel occupancy churn."""

    actor_names: Tuple[str, ...]
    firing_counts: Dict[str, int]
    actor_flops: Dict[str, int]
    #: Mean seconds per firing (None when no wall clock was measured —
    #: the in-kernel case; weights then fall back to firings x flops).
    actor_cost_s: Optional[Dict[str, float]]
    channel_churn_bytes: Dict[str, int]
    wall_time_s: Optional[float] = None
    dropped: int = 0

    def as_cut_weights(self) -> Dict[str, Dict[str, int]]:
        """Integer weights for ``cut_objective="profile"``: per-actor
        load (firings x flops, floor 1 so unfired actors keep a seat)
        and per-channel measured churn in bytes."""
        actors = {nm: max(1, self.firing_counts.get(nm, 0)
                          * self.actor_flops.get(nm, 1))
                  for nm in self.actor_names}
        return {"actors": actors,
                "channels": dict(self.channel_churn_bytes)}


# --------------------------------------------------------------------------- #
# Decode (ring -> host Trace).
# --------------------------------------------------------------------------- #
def decode_trace(network, trace: Optional[TraceState],
                 wall_time_s: Optional[float] = None,
                 actor_cores: Optional[Mapping[str, int]] = None
                 ) -> Optional[Trace]:
    """Unwrap a trace ring into a chronological :class:`Trace`."""
    if trace is None:
        return None
    ring = trace.ring
    if isinstance(ring, torch.Tensor):
        ring = ring.cpu().numpy()
    ring = np.asarray(ring, np.int32)
    total = int(trace.count)
    cap = int(ring.shape[0])
    if total <= cap:
        events = ring[:total].copy()
    else:
        s = total % cap
        events = np.concatenate([ring[s:], ring[:s]], axis=0)
    actor_names = tuple(network.actors)
    fifo_names = tuple(network.fifos)
    flops = tuple(max(1, int(getattr(a, "cost_flops", 1) or 1))
                  for a in network.actors.values())
    tok_bytes = tuple(int(spec.token_size_bytes)
                      for spec in network.fifos.values())
    cores = None
    if actor_cores is not None:
        cores = tuple(int(actor_cores.get(nm, 0)) for nm in actor_names)
    return Trace(actor_names=actor_names, fifo_names=fifo_names,
                 events=events, capacity=cap,
                 dropped=max(0, total - cap), wall_time_s=wall_time_s,
                 actor_flops=flops, fifo_token_bytes=tok_bytes,
                 actor_cores=cores)


# --------------------------------------------------------------------------- #
# Chrome trace-event schema validation.
# --------------------------------------------------------------------------- #
_REQUIRED_KEYS = {
    "M": ("name", "ph", "pid", "args"),
    "X": ("name", "ph", "pid", "tid", "ts", "dur"),
    "i": ("name", "ph", "pid", "tid", "ts", "s"),
    "C": ("name", "ph", "pid", "ts", "args"),
}


def validate_chrome_trace(doc: Any) -> List[str]:
    """Validate a Chrome trace-event document; returns a list of problem
    strings (empty == valid).  Checks the JSON object format, per-phase
    required keys, and non-decreasing timestamps per track (thread
    tracks keyed by (pid, tid); counter tracks by (pid, name))."""
    problems: List[str] = []
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["JSON-object format: 'traceEvents' missing or not a "
                    "list"]
    elif isinstance(doc, list):
        events = doc
    else:
        return [f"document is {type(doc).__name__}, expected dict or list"]
    last_ts: Dict[tuple, float] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph is None:
            problems.append(f"event {i}: missing 'ph'")
            continue
        required = _REQUIRED_KEYS.get(ph)
        if required is None:
            # Other phases (B/E/b/e/s/f/...) are legal Chrome events;
            # the exporter here only emits M/X/i/C, so just sanity-check.
            required = ("name", "ph")
        missing = [k for k in required if k not in e]
        if missing:
            problems.append(f"event {i} (ph={ph!r}): missing keys "
                            f"{missing}")
            continue
        if ph == "M":
            continue
        if "ts" in e:
            key = ((e["pid"], "C", e["name"]) if ph == "C"
                   else (e["pid"], e.get("tid")))
            ts = float(e["ts"])
            if ts < last_ts.get(key, float("-inf")):
                problems.append(
                    f"event {i} (ph={ph!r}, track {key}): ts {ts} goes "
                    f"backwards (prev {last_ts[key]})")
            last_ts[key] = ts
    return problems
