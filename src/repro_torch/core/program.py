"""Program: the compile/run/stream entry point — paper §3.4.

::

    prog = net.compile(ExecutionPlan(mode="static", n_iterations=8))
    result = prog.run()                 # RunResult(state, counts, sweeps)

The port carries the reference's host-driven ``"static"``, ``"dynamic"``
and ``"interpreted"`` modes and its ``"megakernel"`` mode (one launch of
the persistent kernel B2 per run on the card; its plain version for CPU
states), with the grid knobs ``cores``, ``assign`` and ``cut_objective``,
the health layer's ``guards``, ``trace``, ``trace_capacity`` and
``profile``, and ``runtime_mode``.

Heterogeneous placement (``accelerated=[...]``) splits the network when
the program is built (:func:`~repro_torch.core.mapping.heterogeneous_split`):
boundary channels become feed and fetch actors, and :meth:`Program.stream`
is the host transfer loop — chunked (one run per ``n_iterations``-window
chunk; in megakernel mode one B2 launch per chunk, re-entered with the
state the last chunk left), ``persistent=True`` (one run over the whole
stream) and durable (``checkpoint_dir=``, :meth:`Program.resume_stream`).
:meth:`Program.run_checkpointed` and :meth:`Program.resume_run` run to
quiescence in segments of a sweep budget with a snapshot after each.

``devices=k`` shards a dynamic-mode network across the ``k`` ranks of a
``torch.distributed`` process group (:mod:`repro_torch.core.shard`), one
process per device, each rank compiling and running the same program.

Every other plan field of the reference raises with the ROADMAP item that
ports it; none is silently ignored.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointIntegrityError, load_stream_checkpoint,
                                    save_stream_checkpoint)
from repro_torch.core.executor import (RuntimeMode, assert_mode_allows, collect_sink,
                                       run_dynamic, run_static)
from repro_torch.core.fifo import FifoState
from repro_torch.core.health import Diagnostics, NetworkFaultError, decode_health
from repro_torch.core.mapping import heterogeneous_split
from repro_torch.core.megakernel import (CUT_OBJECTIVES, compile_megakernel,
                                         entry_staging_bytes, lower_network,
                                         partition_layout, state_hbm_bytes)
from repro_torch.core.network import Network, NetworkState, tree_leaves, tree_map
from repro_torch.core.schedule import phase_unroll_period
from repro_torch.core.shard import (build_device_partition, collective_bytes_per_sweep,
                                    compile_sharded, decode_device_trace)
from repro_torch.core.trace import (TRACE_CAPACITY_DEFAULT, Trace, decode_trace,
                                    merge_traces)

_MODES = ("static", "dynamic", "interpreted", "megakernel")

#: Reference plan fields not ported yet -> the ROADMAP item that ports them.
_UNPORTED_FIELDS = {
    "donate": "A3 (the port updates rings in place; Program.run(state, "
              "in_place=True) is its form of donation)",
    "donate_threshold_bytes": "A3 (donation)",
    "unroll_bound": "A3 (eager cursors need no phase unroll)",
}

#: The reference's default ``unroll_bound``: the phase-period rule of
#: specialized static streams is judged at it.
_UNROLL_BOUND = 6

#: Why B2 is not re-entered with forwarded transients (ROADMAP A11).
_REENTRY = ("B2 would be re-entered mid-run with forwarded transient "
            "channels, which must enter drained (ROADMAP A11: a chunk or "
            "segment boundary leaves them holding tokens); plan "
            "specialize=False to keep every ring in scratch")


def _dtype_str(dt: Any) -> str:
    """A dtype by its numpy name (``float32``), torch's or numpy's."""
    return str(dt).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Declarative execution policy.

    Fields:
      mode:          ``"static"`` (single-appearance schedule for
                     ``n_iterations``), ``"interpreted"`` (the same
                     schedule fired actor by actor, no forwarding: Table
                     3's multicore baseline), ``"dynamic"`` (token-driven
                     sweeps to quiescence, driven from the host) or
                     ``"megakernel"`` (the same sweeps in one launch of the
                     persistent kernel B2).
      n_iterations:  iteration count of static and interpreted mode, and
                     the chunk length of :meth:`Program.stream` (required
                     with ``accelerated``, which sizes the feed and fetch
                     slabs with it).
      specialize:    static mode: forward the windows of transient
                     (``register_fifos``) channels instead of buffering;
                     megakernel mode: forward the core-private transient
                     channels (they must enter drained and start from
                     zeros).
      multi_firing:  dynamic/megakernel modes: fire each actor up to its
                     occupancy bound per visit.
      max_sweeps:    dynamic/megakernel mode sweep bound.
      order:         optional static firing order (defaults topological).
      runtime_mode:  ``RuntimeMode.PROPOSED`` (this paper, the default) or
                     ``RuntimeMode.STATIC_DAL`` (the reference framework,
                     which refuses dynamic-rate actors on the accelerator);
                     any other value raises ``ValueError``.  Judged when
                     the program is built, in static, dynamic and
                     megakernel mode, on the accelerated actors (every
                     actor without ``accelerated``); interpreted mode is
                     the host-thread baseline, which the reference does not
                     check either.
      cores:         megakernel mode: grid partitions of the firing table
                     (the reference's actor-to-core mapping).  The port's
                     kernel runs the partitions' visit order in one
                     replicated scheduler, so results equal ``cores=1``.
      assign:        megakernel mode: explicit actor -> core map (of the
                     split subnetwork under ``accelerated``).
      cut_objective: megakernel mode: ``"crossing"`` or ``"flops"`` default
                     cut, or ``"profile"``: the crossing cut over the
                     measured weights of ``profile``.
      interpret:     the reference's Pallas interpret switch; the port
                     raises, since the state's device picks the kernel or
                     its plain version.
      accelerated:   the actors mapped to the accelerator: the network is
                     split (``heterogeneous_split``), the plan executes the
                     accelerated subnetwork, and :meth:`Program.stream`
                     feeds and fetches its boundary channels.
      guards:        dynamic/megakernel modes: evaluate the health layer's
                     per-channel guards (``core/health.py``); a faulting
                     run raises :class:`NetworkFaultError` naming the
                     channel and its actors, and ``RunResult.diagnostics``
                     carries fault words and high-water marks.  A clean
                     guarded run is bit-identical to an unguarded one.
      trace:         dynamic/megakernel modes: record one event per firing
                     attempt (``core/trace.py``) onto ``RunResult.trace``.
      trace_capacity: events the trace ring holds (requires ``trace``);
                     None is ``TRACE_CAPACITY_DEFAULT``.  The newest are
                     kept.
      profile:       megakernel mode: the weights of
                     ``cut_objective="profile"``: a ``Profile``, its
                     ``as_cut_weights()`` mapping, or the frozen pair
                     tuples a plan normalises it to.
      devices:       dynamic mode: shard the network across ``devices``
                     ranks of a ``torch.distributed`` process group
                     (:mod:`repro_torch.core.shard`), one process per
                     device: the crossing-bytes cut of the megakernel grid
                     with ``cores`` = devices, each rank sweeping only its
                     actors, crossing channels exchanging rings and
                     cursors at sweep barriers, quiescence an all-reduce
                     of the ranks' fired flags.  States, rings, cursors and
                     fire counts equal the single-device dynamic run's bit
                     for bit; sweeps count barrier rounds.  Every rank
                     compiles and runs the same program, in a group of
                     exactly ``devices`` ranks.  ``devices=1`` is exactly
                     the plain dynamic path.
      device_assign: explicit actor -> device map for ``devices > 1``
                     (covering every actor; a delay channel with ``delay <
                     rate`` may not cross devices).  Default: the crossing
                     cut.

    The reference's other fields exist so a plan written for it
    constructs; any value but the default ``None`` raises, naming the
    ROADMAP item that ports it.
    """

    mode: str = "static"
    n_iterations: Optional[int] = None
    specialize: bool = True
    multi_firing: bool = True
    max_sweeps: int = 1_000_000
    order: Optional[Tuple[str, ...]] = None
    donate: Any = None
    donate_threshold_bytes: Any = None
    runtime_mode: Any = RuntimeMode.PROPOSED
    unroll_bound: Any = None
    interpret: Any = None
    cores: int = 1
    assign: Optional[Any] = None
    cut_objective: str = "crossing"
    accelerated: Optional[Tuple[str, ...]] = None
    guards: bool = False
    trace: bool = False
    trace_capacity: Optional[int] = None
    profile: Optional[Any] = None
    devices: int = 1
    device_assign: Optional[Any] = None

    def __post_init__(self) -> None:
        mode = getattr(self.mode, "value", self.mode)
        object.__setattr__(self, "mode", mode)
        if mode not in _MODES:
            raise ValueError(
                f"ExecutionPlan.mode must be one of {_MODES}, got {mode!r}")
        if not isinstance(self.runtime_mode, RuntimeMode):
            raise ValueError(
                f"ExecutionPlan.runtime_mode must be one of {list(RuntimeMode)}, got "
                f"{self.runtime_mode!r}")
        for field, item in _UNPORTED_FIELDS.items():
            if getattr(self, field) is not None:
                raise NotImplementedError(
                    f"ExecutionPlan.{field} is not ported yet: ROADMAP {item}")
        if self.interpret is not None:
            raise ValueError(
                "ExecutionPlan.interpret has no counterpart in the port: the "
                "state's device picks the kernel (CUDA) or its plain "
                "PyTorch version (CPU)")
        if (not isinstance(self.cores, int) or isinstance(self.cores, bool)
                or self.cores < 1):
            raise ValueError(
                f"ExecutionPlan.cores must be an int >= 1, got {self.cores!r}")
        if (not isinstance(self.devices, int) or isinstance(self.devices, bool)
                or self.devices < 1):
            raise ValueError(
                f"ExecutionPlan.devices must be an int >= 1, got {self.devices!r}")
        for field in ("assign", "device_assign"):
            if getattr(self, field) is not None:
                # A sorted pair tuple keeps the frozen plan immutable.
                object.__setattr__(self, field, tuple(sorted(
                    (str(k), int(v)) for k, v in dict(getattr(self, field)).items())))
        if self.cut_objective not in CUT_OBJECTIVES:
            raise ValueError(
                f"ExecutionPlan.cut_objective must be one of "
                f"{CUT_OBJECTIVES}, got {self.cut_objective!r}")
        if self.trace_capacity is not None and (
                not isinstance(self.trace_capacity, int)
                or isinstance(self.trace_capacity, bool)
                or self.trace_capacity < 1):
            raise ValueError(
                f"ExecutionPlan.trace_capacity must be None or an int "
                f">= 1, got {self.trace_capacity!r}")
        if self.profile is not None:
            # A Profile, its as_cut_weights() mapping, or the frozen form a
            # plan normalised it to; frozen to sorted pair tuples.
            prof = self.profile
            if hasattr(prof, "as_cut_weights"):
                prof = prof.as_cut_weights()
            if isinstance(prof, tuple):
                prof = {k: dict(v) for k, v in prof}
            if (not isinstance(prof, Mapping) or "actors" not in prof
                    or set(prof) - {"actors", "channels"}):
                raise ValueError(
                    "ExecutionPlan.profile must be a "
                    "repro_torch.core.trace.Profile or a mapping with "
                    f"'actors' (and optional 'channels') weights, got {prof!r}")
            object.__setattr__(self, "profile", (
                ("actors", tuple(sorted(
                    (str(k), int(v)) for k, v in dict(prof["actors"]).items()))),
                ("channels", tuple(sorted(
                    (str(k), int(v))
                    for k, v in dict(prof.get("channels", {})).items()))),
            ))
        if self.n_iterations is not None and self.n_iterations < 0:
            raise ValueError(
                f"ExecutionPlan: n_iterations must be >= 0, got {self.n_iterations}")
        if self.mode in ("static", "interpreted") and self.n_iterations is None:
            raise ValueError(
                f"ExecutionPlan(mode={self.mode!r}): pass n_iterations= — "
                "static/interpreted schedules run a fixed iteration count "
                "(dynamic mode runs to quiescence without one)")
        if self.order is not None:
            object.__setattr__(self, "order", tuple(self.order))
        if self.accelerated is not None:
            object.__setattr__(self, "accelerated", tuple(self.accelerated))

    def validate(self, network: Network, *,
                 stream_persistent: Optional[bool] = None,
                 stream_on_fault: Optional[str] = None,
                 stream_checkpoint_dir: Optional[str] = None) -> "ExecutionPlan":
        """The cross-field rules against ``network``, judged when a
        :class:`Program` is built and, with the stream's arguments, when
        :meth:`Program.stream` starts (the reference's ``program.py:352-479``).
        Returns ``self``."""
        if (self.cores != 1 or self.assign is not None
                or self.cut_objective != "crossing") \
                and self.mode != "megakernel":
            raise ValueError(
                f"ExecutionPlan(mode={self.mode!r}): cores=/assign=/"
                "cut_objective= are grid-partition knobs of the megakernel "
                "backend; the host executors have no core axis (use "
                "mode='megakernel', or accelerated=[...] for host/accelerator "
                "placement)")
        if self.guards and self.mode not in ("dynamic", "megakernel"):
            raise ValueError(
                f"ExecutionPlan(mode={self.mode!r}): guards=True is a "
                "sweep-loop health knob of the dynamic and megakernel "
                "backends; the static and interpreted schedules have no "
                "per-channel cursor state for the guards to watch")
        if self.trace and self.mode not in ("dynamic", "megakernel"):
            raise ValueError(
                f"ExecutionPlan(mode={self.mode!r}): trace=True is a "
                "sweep-loop observability knob of the dynamic and "
                "megakernel backends; the static/interpreted schedules "
                "have no firing attempts to record")
        if self.trace_capacity is not None and not self.trace:
            raise ValueError("ExecutionPlan.trace_capacity requires trace=True")
        if self.cut_objective == "profile" and self.profile is None:
            raise ValueError(
                "ExecutionPlan(cut_objective='profile') needs measured "
                "weights: run once with ExecutionPlan(trace=True), then "
                "pass profile=RunResult.trace.profile() (or its "
                ".as_cut_weights() dict)")
        if self.profile is not None and self.cut_objective != "profile":
            raise ValueError(
                f"ExecutionPlan.profile is only consumed by "
                f"cut_objective='profile', but the plan says "
                f"{self.cut_objective!r}")
        if self.devices > 1 and self.cores != 1:
            raise ValueError(
                f"ExecutionPlan(devices={self.devices}, cores={self.cores}): "
                "devices= (the mesh axis) and cores= (the megakernel grid "
                "axis) are exclusive — pick one partition axis per plan")
        if self.device_assign is not None and self.devices == 1:
            raise ValueError(
                "ExecutionPlan(device_assign=..., devices=1): device_assign "
                "places actors on mesh devices, so it requires devices > 1 "
                "(use assign= for the megakernel grid's core map)")
        if self.devices > 1 and self.mode != "dynamic":
            raise ValueError(
                f"ExecutionPlan(mode={self.mode!r}, devices={self.devices}): "
                "multi-device sharding runs the token-driven dynamic "
                "executor per device; use mode='dynamic' (one megakernel "
                "per device is a ROADMAP item, not a plan knob yet)")
        if self.devices > 1 and self.accelerated is not None:
            raise ValueError(
                f"ExecutionPlan(devices={self.devices}, accelerated=[...]): "
                "sharding and heterogeneous host/accelerator placement are "
                "exclusive — the mesh IS the accelerator set under "
                "devices=, so drop accelerated= (or stream with devices=1)")
        if self.accelerated is not None and self.n_iterations is None:
            raise ValueError(
                f"ExecutionPlan(mode={self.mode!r}, accelerated=[...]): pass "
                "n_iterations= — static/interpreted schedules compile a fixed "
                "iteration count, and heterogeneous plans size their boundary "
                "feed/fetch slabs with it (dynamic mode alone runs to "
                "quiescence without one)")
        if self.accelerated is not None:
            unknown = set(self.accelerated) - set(network.actors)
            if unknown:
                raise ValueError(
                    f"ExecutionPlan.accelerated names unknown actors "
                    f"{sorted(unknown)}; known: {sorted(network.actors)}")
        if self.assign is not None and self.accelerated is None:
            # Under accelerated= the executed network is the split
            # subnetwork, which partition_layout validates the map against.
            network.validate_partition(dict(self.assign), self.cores)
        if self.device_assign is not None:
            network.validate_partition(dict(self.device_assign), self.devices,
                                       unit="device")
        if (stream_persistent is not None or stream_on_fault is not None
                or stream_checkpoint_dir is not None):
            if self.accelerated is None:
                raise ValueError(
                    "Program.stream: this plan has no heterogeneous "
                    "placement; pass ExecutionPlan(accelerated=[...], "
                    "n_iterations=chunk) so boundary channels become "
                    "host feed/fetch actors")
            if stream_persistent and stream_checkpoint_dir is not None:
                raise ValueError(
                    "Program.stream: persistent=True runs the whole "
                    "stream as one kernel entry with no chunk boundaries "
                    "to snapshot at, so checkpoint_dir= has no cadence; "
                    "use the chunked loop (persistent=False) for durable "
                    "checkpoints")
        return self


@dataclasses.dataclass(frozen=True)
class RunResult:
    """One execution's outcome; ``fire_counts`` / ``sweeps`` / ``stalled``
    / ``diagnostics`` are set by the dynamic and megakernel modes only.
    ``diagnostics`` decodes the stall flag always, and the fault words and
    high-water marks under ``guards=True``; ``trace`` is the decoded
    :class:`~repro_torch.core.trace.Trace` of a ``trace=True`` run."""

    state: NetworkState
    fire_counts: Optional[Dict[str, int]] = None
    sweeps: Optional[int] = None
    stalled: bool = False
    diagnostics: Optional[Diagnostics] = None
    trace: Optional[Trace] = None


@dataclasses.dataclass(frozen=True)
class ProgramStats:
    """The buffer accounting of a compiled program plus its last run's
    sweeps and fire counts.  The megakernel fields (``scratch_bytes`` on)
    are the reference's, set in megakernel mode only; ``hbm_state_bytes``
    and ``partition_fire_counts`` after a run.  The ``last_stream_*``
    fields describe the last :meth:`Program.stream`: its chunks, whether it
    ran persistent, and the bytes staged per chunk and in all (the feed and
    fetch slabs every chunk, plus B2's ring and cursor scratch on every
    kernel entry: each chunk when chunked, once when persistent).

    ``devices`` is always present (1 unsharded).  A sharded program
    (``plan.devices > 1``) also reports ``device_partition_actors`` (actor
    names per device, visit order), ``collective_bytes_per_sweep`` (what
    one barrier round moves: each crossing channel's ring and rd/wr pair,
    plus the fired flag) and ``quiescence_allreduces`` (the last run's
    barrier rounds, one all-reduce each)."""

    mode: str
    n_actors: int
    n_fifos: int
    buffer_bytes: int
    register_fifos: Tuple[str, ...]
    last_sweeps: Optional[int] = None
    last_fire_counts: Optional[Dict[str, int]] = None
    scratch_bytes: Optional[int] = None
    transient_scratch_bytes: Optional[int] = None
    forwarded_fifos: Optional[Tuple[str, ...]] = None
    reclaimed_scratch_bytes: Optional[int] = None
    hbm_state_bytes: Optional[int] = None
    grid_cores: Optional[int] = None
    partition_actors: Optional[Tuple[Tuple[str, ...], ...]] = None
    core_scratch_bytes: Optional[Tuple[int, ...]] = None
    shared_scratch_bytes: Optional[int] = None
    shared_fifos: Optional[Tuple[str, ...]] = None
    core_cursor_rows: Optional[Tuple[int, ...]] = None
    cut_objective: Optional[str] = None
    partition_fire_counts: Optional[Tuple[int, ...]] = None
    last_stream_chunks: Optional[int] = None
    last_stream_persistent: Optional[bool] = None
    last_stream_staged_bytes_per_chunk: Optional[int] = None
    last_stream_total_staged_bytes: Optional[int] = None
    devices: int = 1
    device_partition_actors: Optional[Tuple[Tuple[str, ...], ...]] = None
    collective_bytes_per_sweep: Optional[int] = None
    quiescence_allreduces: Optional[int] = None

    #: Version of the :meth:`to_json` schema: the reference's (v2).
    SCHEMA_VERSION = 2

    def to_json(self) -> Dict[str, Any]:
        """The stats as a ``json.dump``-able dict: every field under its own
        name, tuples lowered to lists, and ``schema_version``."""
        def lower(v):
            if isinstance(v, tuple):
                return [lower(x) for x in v]
            if isinstance(v, dict):
                return {k: lower(x) for k, x in v.items()}
            return v

        doc: Dict[str, Any] = {"schema_version": self.SCHEMA_VERSION}
        for f in dataclasses.fields(self):
            doc[f.name] = lower(getattr(self, f.name))
        return doc


# --------------------------------------------------------------------------- #
# Snapshot payloads: states and traces as plain containers of arrays, the
# reference's layout (host ints as 0-d int32 arrays).
# --------------------------------------------------------------------------- #
def _leaf_payload(x: Any) -> Any:
    return x if isinstance(x, torch.Tensor) else np.asarray(x, np.int32)


def _trace_to_payload(t: Trace) -> Dict[str, Any]:
    return {"actor_names": list(t.actor_names),
            "fifo_names": list(t.fifo_names),
            "events": np.asarray(t.events, np.int32),
            "capacity": int(t.capacity),
            "dropped": int(t.dropped),
            "wall_time_s": None if t.wall_time_s is None else float(t.wall_time_s),
            "actor_flops": [int(x) for x in t.actor_flops],
            "fifo_token_bytes": [int(x) for x in t.fifo_token_bytes],
            "actor_cores": (None if t.actor_cores is None
                            else [int(x) for x in t.actor_cores])}


def _trace_from_payload(d: Mapping[str, Any]) -> Trace:
    return Trace(actor_names=tuple(d["actor_names"]),
                 fifo_names=tuple(d["fifo_names"]),
                 events=np.asarray(d["events"], np.int32),
                 capacity=int(d["capacity"]),
                 dropped=int(d["dropped"]),
                 wall_time_s=d["wall_time_s"],
                 actor_flops=tuple(int(x) for x in d["actor_flops"]),
                 fifo_token_bytes=tuple(int(x) for x in d["fifo_token_bytes"]),
                 actor_cores=(None if d["actor_cores"] is None
                              else tuple(int(x) for x in d["actor_cores"])))


def _add_counts(acc: Optional[Dict[str, int]], counts: Optional[Mapping[str, int]]
                ) -> Optional[Dict[str, int]]:
    if counts is None:
        return acc
    acc = {} if acc is None else acc
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + int(v)
    return acc


class Program:
    """A network compiled under a plan; built by :meth:`Network.compile`.
    Run it with :meth:`run`, or stream host data through a heterogeneous
    plan with :meth:`stream`."""

    def __init__(self, network: Network, plan: ExecutionPlan):
        self.plan = plan.validate(network)
        self.source_network = network
        self._feed_by_fifo: Dict[str, str] = {}
        self._fetch_by_fifo: Dict[str, str] = {}
        if plan.accelerated is not None:
            sub, feeds, fetches = heterogeneous_split(
                network, list(plan.accelerated), plan.n_iterations)
            self.network = sub
            self._feed_by_fifo = {f[len("__feed_"):]: f for f in feeds}
            self._fetch_by_fifo = {f[len("__fetch_"):]: f for f in fetches}
        else:
            self.network = network
        if plan.mode != "interpreted":
            # The executed network: the accelerated actors (and the static
            # feed and fetch actors) under a heterogeneous plan.
            assert_mode_allows(self.network, plan.runtime_mode)
        self._last: Optional[RunResult] = None
        self._last_is_stream_chunk = False
        #: Per-chunk fault/recovery log of the last :meth:`stream` (entries
        #: only for chunks that needed the on_fault policy).
        self.last_stream_report: List[Dict[str, Any]] = []
        self._last_stream: Optional[Dict[str, Any]] = None
        #: The last stream's chunk traces merged into one (None unless
        #: ``plan.trace``).
        self.last_stream_trace: Optional[Trace] = None
        #: Fire counts and sweeps summed over the last stream's chunks; a
        #: resumed stream's equal the uninterrupted one's.
        self.last_stream_fire_counts: Optional[Dict[str, int]] = None
        self.last_stream_sweeps: Optional[int] = None
        #: Twin programs, built on first use: full-length ones for
        #: persistent streams (by window count), bounded-sweep ones for
        #: run_checkpointed (by sweep budget).
        self._persistent_progs: Dict[int, "Program"] = {}
        self._segment_progs: Dict[int, "Program"] = {}
        self._layout = self._partition = self._runner = None
        self._shard_layout = self._shard_partition = None
        if plan.devices > 1:
            # One rank per device: the partition is cut and this rank's
            # runner built (the group checked) now, as the reference does.
            self._shard_layout, self._shard_partition = build_device_partition(
                self.network, plan.devices,
                device_assign=(dict(plan.device_assign)
                               if plan.device_assign is not None else None),
                cut_objective=plan.cut_objective)
            self._runner = compile_sharded(
                self.network, self._shard_layout, self._shard_partition,
                plan.max_sweeps, plan.runtime_mode, plan.multi_firing,
                guards=plan.guards, trace_capacity=self._trace_capacity)
        if plan.mode == "megakernel":
            # Lower and partition once, as the reference does.
            self._layout = lower_network(self.network)
            self._partition = partition_layout(
                self.network, self._layout, plan.cores,
                dict(plan.assign) if plan.assign is not None else None,
                objective=plan.cut_objective,
                forward_transients=plan.specialize,
                profile=({k: dict(v) for k, v in plan.profile}
                         if plan.profile is not None else None))
            self._runner = compile_megakernel(
                self.network, plan.max_sweeps, plan.multi_firing,
                layout=self._layout, partition=self._partition,
                guards=plan.guards, trace_capacity=self._trace_capacity)

    @property
    def _trace_capacity(self) -> Optional[int]:
        if not self.plan.trace:
            return None
        return self.plan.trace_capacity or TRACE_CAPACITY_DEFAULT

    def init_state(self) -> NetworkState:
        """Fresh state of the executed network (the accelerated subnetwork
        under a heterogeneous plan)."""
        return self.network.init_state()

    def run(self, state: Optional[NetworkState] = None, *,
            in_place: bool = False) -> RunResult:
        """Execute once from ``state`` (a fresh :meth:`init_state` if None).

        Channels and actor states are updated in place, so a caller's state
        is cloned first unless ``in_place=True``.
        """
        if state is None:
            st = self.init_state()
        else:
            st = self.network.state_from_dict(state)
            st = st if in_place else st.clone()
        plan = self.plan
        self._last_is_stream_chunk = False
        if plan.mode in ("dynamic", "megakernel"):
            t0 = time.perf_counter()
            if plan.mode == "dynamic" and self._shard_partition is None:
                res = run_dynamic(self.network, st, plan.max_sweeps,
                                  plan.multi_firing, guards=plan.guards,
                                  trace_capacity=self._trace_capacity)
            else:
                res = self._runner(st)
            st, counts, sweeps, stalled = res
            trace = None
            if res.trace is not None and self._shard_partition is not None:
                # One ring per rank, gathered: decoded and interleaved by
                # barrier round, actor_cores naming each actor's device.
                trace = decode_device_trace(self.network, res.trace,
                                            self._shard_partition,
                                            wall_time_s=time.perf_counter() - t0)
            elif res.trace is not None:
                # The run ended with its results on the host, so this clock
                # covers it; firings get a proportional share of it.
                cores = None
                part = self._partition
                if part is not None and part.n_cores > 1:
                    names = tuple(self.network.actors)
                    cores = {names[i]: c for c, rows in enumerate(part.core_rows)
                             for i in rows}
                trace = decode_trace(self.network, res.trace,
                                     wall_time_s=time.perf_counter() - t0,
                                     actor_cores=cores)
            diag = decode_health(self.network, res.health, stalled,
                                 st if stalled else None)
            result = RunResult(st, fire_counts=counts, sweeps=sweeps,
                               stalled=stalled, diagnostics=diag, trace=trace)
            self._last = result
            if not diag.ok:
                if plan.guards:
                    err = NetworkFaultError(diag)
                    err.result = result
                    raise err
                warnings.warn(
                    f"Program.run: sweep budget (max_sweeps={plan.max_sweeps}) "
                    "exhausted with work remaining — partial state returned; "
                    f"{diag.summary()}", RuntimeWarning, stacklevel=2)
        else:
            # Interpreted mode is the static schedule without forwarding.
            order = list(plan.order) if plan.order is not None else None
            result = RunResult(run_static(
                self.network, st, plan.n_iterations, order=order,
                specialize=plan.specialize and plan.mode == "static"))
        self._last = result
        return result

    def collect(self, actor: str, state: Optional[NetworkState] = None) -> Any:
        """Run ``actor``'s ``finish`` hook on ``state`` (default: the last
        run's final state)."""
        if state is None:
            if self._last is None:
                raise ValueError("Program.collect: no run yet; pass a state "
                                 "or call run() first")
            if self._last_is_stream_chunk:
                raise ValueError(
                    "Program.collect: the last execution was stream(), whose "
                    "implicit final state covers only the LAST chunk; use "
                    "the dict stream() returned for the full output, or "
                    "pass a state explicitly")
            state = self._last.state
        return collect_sink(self.network, state, actor)

    # ------------------------------------------------------------------ #
    # The chunked host feed / fetch loop (heterogeneous plans).
    # ------------------------------------------------------------------ #
    @staticmethod
    def _with_actor(state: NetworkState, name: str, value: Any) -> NetworkState:
        """``state`` with one actor's state replaced (the rest shared)."""
        actors = list(state.actors)
        actors[state.actor_names.index(name)] = value
        return NetworkState(list(state.fifos), actors, state.fifo_names,
                            state.actor_names)

    def _normalize_feed(self, fifo: str, feed_actor: str, spec: Any, raw: Any,
                        where: str = "") -> Tuple[str, torch.Tensor]:
        """Check one feed array and bring it to ``(n, r, *token_shape)``
        windows of the channel's dtype on the network's device; returns
        ``(its dtype's name, windows)``."""
        raw = torch.as_tensor(raw)
        # Real-to-real casts (int windows into a float channel) are host
        # conveniences; complex data into a real channel would drop the
        # imaginary half, a wrong feed on the right name.
        if raw.is_complex() and not spec.dtype.is_complex:
            raise ValueError(
                f"Program.stream: feed {fifo!r}{where} (staged into actor "
                f"{feed_actor!r}) carries dtype {_dtype_str(raw.dtype)}, but "
                f"the channel expects {_dtype_str(spec.dtype)}; cast the "
                "stream explicitly if the conversion is intended")
        arr = raw.to(device=self.network.device, dtype=spec.dtype)
        window = (spec.rate,) + tuple(spec.token_shape)
        if tuple(arr.shape[1:]) != window:
            if (arr.dim() >= 1 and arr.shape[0] % spec.rate == 0
                    and tuple(arr.shape[1:]) == tuple(spec.token_shape)):
                arr = arr.reshape((-1,) + window)
            else:
                raise ValueError(
                    f"Program.stream: feed {fifo!r}{where} (staged into "
                    f"actor {feed_actor!r}) has shape {tuple(arr.shape)}; "
                    f"expected (n, {spec.rate}, *{tuple(spec.token_shape)}) "
                    "windows or the flattened token stream")
        return _dtype_str(raw.dtype), arr.contiguous()

    def stream(self, feeds: Mapping[str, Any], on_fault: str = "raise",
               max_retries: int = 2, persistent: bool = False,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 1) -> Dict[str, torch.Tensor]:
        """Stream host data through the accelerated subnetwork.

        ``feeds`` maps each inbound boundary channel to its whole stream:
        ``(total_windows, r, *token_shape)`` windows, the flattened
        ``(total_windows * r, *token_shape)`` tokens, or a list of per-chunk
        arrays (each ``plan.n_iterations`` windows, every one with chunk
        0's dtype and shape; a drift is refused naming the chunk).  Arrays
        may be numpy arrays or tensors on any device.  The stream runs in
        chunks of ``plan.n_iterations`` windows: each chunk's windows are
        staged into the feed actors, the plan runs, and the fetch actors'
        slabs are collected.  Actor and channel state carries across
        chunks, so N chunks equal one long run over the concatenation.

        ``persistent=True`` runs one full-length twin program (the same
        network at ``n_iterations=total``) once, staging the feed slabs
        once: in megakernel mode one B2 launch for the stream, bit-identical
        to the chunked loop.  With ``on_fault="resume"`` / ``"skip"`` a
        faulting persistent run falls back to the chunked loop (logged as
        ``action="fallback-chunked"``).

        ``checkpoint_dir=`` makes the chunked loop durable: every
        ``checkpoint_every`` chunks (and after the last) the state, the
        fetched windows, fire counts, sweeps and chunk traces are written
        as a snapshot (:mod:`repro_torch.checkpoint`); after a kill,
        :meth:`resume_stream` on a fresh program continues bit-identically.

        ``on_fault`` decides what a guarded run's
        :class:`NetworkFaultError` does: ``"raise"`` (re-raised naming the
        chunk), ``"resume"`` (the chunk re-run from the state before it, up
        to ``max_retries`` times) or ``"skip"`` (that state restored, the
        chunk's fetch windows zero, the stream goes on).  Chunks that needed
        the policy are logged in ``last_stream_report``.

        Returns ``{outbound channel: (total_windows, r, *token_shape)}``.
        """
        arrays, total, chunk, n_chunks, slab_bytes, ring_bytes = \
            self._prepare_stream(feeds, on_fault, max_retries, persistent,
                                 checkpoint_dir, checkpoint_every)
        report: List[Dict[str, Any]] = []
        self.last_stream_report = report
        if persistent:
            try:
                return self._stream_persistent(arrays, total, n_chunks,
                                               slab_bytes, ring_bytes)
            except NetworkFaultError as err:
                if on_fault == "raise":
                    raise
                # The chunk loop has states to restore; by the concatenation
                # invariant its outputs are the same, so the fallback changes
                # recovery, not data.
                report.append({"chunk": None, "attempts": 1,
                               "action": "fallback-chunked", "fault": str(err)})
        return self._stream_chunked(arrays, total, chunk, n_chunks, on_fault,
                                    max_retries, slab_bytes, ring_bytes, report,
                                    checkpoint_dir, checkpoint_every)

    def _check_reentry(self, what: str) -> None:
        """Refuse up front a plan that would enter B2 mid-run with forwarded
        transients (they must enter drained)."""
        if self._partition is not None and self._partition.forwarded_fifos:
            fwd = [self._layout.fifo_names[i] for i in self._partition.forwarded_fifos]
            raise ValueError(f"{what}: forwarded channels {fwd}: {_REENTRY}")

    def _prepare_stream(self, feeds: Mapping[str, Any], on_fault: str,
                        max_retries: int, persistent: bool,
                        checkpoint_dir: Optional[str], checkpoint_every: int):
        """The stream's checks and feed normalisation, shared by
        :meth:`stream` and :meth:`resume_stream`."""
        if on_fault not in ("raise", "resume", "skip"):
            raise ValueError(
                f"Program.stream: on_fault must be 'raise', 'resume' or "
                f"'skip', got {on_fault!r}")
        self.plan.validate(self.source_network, stream_persistent=persistent,
                           stream_on_fault=on_fault,
                           stream_checkpoint_dir=checkpoint_dir)
        if not isinstance(max_retries, int) or isinstance(max_retries, bool) \
                or max_retries < 0:
            raise ValueError(
                f"Program.stream: max_retries must be an int >= 0, got "
                f"{max_retries!r}")
        if not isinstance(checkpoint_every, int) \
                or isinstance(checkpoint_every, bool) or checkpoint_every < 1:
            raise ValueError(
                f"Program.stream: checkpoint_every must be an int >= 1, "
                f"got {checkpoint_every!r}")
        chunk = self.plan.n_iterations
        if self.plan.mode == "static" and self.plan.specialize:
            # The reference's specialized static schedule needs chunks of
            # whole phase-unroll periods; the rule stays the plan's.
            period = phase_unroll_period(
                [spec.n_write_phases for name, spec in self.network.fifos.items()
                 if name not in self.network.register_fifos],
                bound=_UNROLL_BOUND)
            if chunk % period:
                raise ValueError(
                    f"Program.stream: n_iterations={chunk} is not a "
                    f"multiple of the phase-unroll period {period} of the "
                    "accelerated subnetwork, so chunks after the first "
                    "would resume from non-phase-aligned cursors; use a "
                    "multiple (delay channels cycle 3, double buffers 2) "
                    "or plan specialize=False")
        unknown = set(feeds) - set(self._feed_by_fifo)
        if unknown:
            raise ValueError(
                f"Program.stream: unknown feed channels {sorted(unknown)}; "
                f"inbound boundary channels: {sorted(self._feed_by_fifo)}")
        missing = set(self._feed_by_fifo) - set(feeds)
        if missing:
            raise ValueError(
                f"Program.stream: missing feeds for inbound boundary "
                f"channels {sorted(missing)}")
        arrays: Dict[str, torch.Tensor] = {}
        total = None
        for fifo, arr in feeds.items():
            spec = self.source_network.fifos[fifo]
            feed_actor = self._feed_by_fifo[fifo]
            if isinstance(arr, (list, tuple)):
                # One array per chunk, each held to chunk 0's dtype and
                # windows: a drifting chunk fails here, naming it.
                if len(arr) == 0:
                    raise ValueError(
                        f"Program.stream: feed {fifo!r} is an empty "
                        "per-chunk list; pass one array per chunk")
                dt0 = a0 = None
                parts = []
                for i, piece in enumerate(arr):
                    dt, a = self._normalize_feed(fifo, feed_actor, spec, piece,
                                                 where=f" chunk {i}")
                    if i == 0:
                        dt0, a0 = dt, a
                        if a.shape[0] != chunk:
                            raise ValueError(
                                f"Program.stream: per-chunk feed {fifo!r} "
                                f"chunk 0 covers {a.shape[0]} windows, but "
                                f"chunks are n_iterations={chunk} windows "
                                "each; pass whole chunks (or one "
                                "concatenated array)")
                    else:
                        if dt != dt0:
                            raise ValueError(
                                f"Program.stream: feed {fifo!r} chunk {i} "
                                f"carries dtype {dt}, but chunk 0 staged "
                                f"{dt0}; per-chunk feeds must keep one "
                                "dtype across the stream (cast explicitly "
                                "if the drift is intended)")
                        if a.shape != a0.shape:
                            raise ValueError(
                                f"Program.stream: feed {fifo!r} chunk {i} "
                                f"has window shape {tuple(a.shape)}, but "
                                f"chunk 0 staged {tuple(a0.shape)}; "
                                "per-chunk feeds must keep a consistent "
                                "window count and token shape across "
                                "chunks")
                    parts.append(a)
                arr = torch.cat(parts, dim=0)
            else:
                _, arr = self._normalize_feed(fifo, feed_actor, spec, arr)
            if total is None:
                total = arr.shape[0]
            elif arr.shape[0] != total:
                raise ValueError(
                    f"Program.stream: feed {fifo!r} carries {arr.shape[0]} "
                    f"windows but other feeds carry {total}; all feeds "
                    "must cover the same number of iterations")
            arrays[fifo] = arr
        if total is None:
            raise ValueError("Program.stream: no feeds given")
        if total % chunk:
            raise ValueError(
                f"Program.stream: {total} windows do not divide into "
                f"chunks of n_iterations={chunk}; pad the stream or pick "
                "a dividing chunk size")
        n_chunks = total // chunk
        if n_chunks > 1 and (not persistent or on_fault != "raise"):
            self._check_reentry("Program.stream")
        # Staging bills: the feed/fetch slab share of every chunk, and B2's
        # ring + cursor scratch, staged on every kernel entry.
        slab_bytes = 0
        for f in list(arrays) + list(self._fetch_by_fifo):
            spec = self.source_network.fifos[f]
            slab_bytes += chunk * spec.rate * spec.token_size_bytes
        ring_bytes = (entry_staging_bytes(self._layout, self._partition)
                      if self._layout is not None else 0)
        self._check_feed_domains(arrays, chunk)
        return arrays, total, chunk, n_chunks, slab_bytes, ring_bytes

    def _check_feed_domains(self, arrays: Mapping[str, torch.Tensor],
                            chunk: int) -> None:
        """Refuse out-of-domain feed windows before any chunk runs, naming
        the window's chunk and, where the channel declares ``row_id_col``,
        the request id its row carries."""
        for fifo, arr in arrays.items():
            spec = self.source_network.fifos[fifo]
            if spec.domain is None:
                continue
            lo, hi = spec.domain
            a = arr.double()
            bad = (a < lo) | (a > hi) | ~torch.isfinite(a)
            if not bool(bad.any()):
                continue
            idx = tuple(int(x) for x in torch.nonzero(bad)[0])
            w = idx[0]
            detail = ""
            if spec.row_id_col is not None and len(idx) >= 2:
                rid = int(arr[idx[:-1] + (int(spec.row_id_col),)])
                detail = f", request id {rid}"
            raise ValueError(
                f"Program.stream: feed {fifo!r} window {w} (chunk "
                f"{w // chunk}) carries value {arr[idx].item()!r} outside the "
                f"channel domain [{lo}, {hi}]{detail}; drop or repair the "
                "request before streaming")

    def _stream_persistent(self, arrays: Mapping[str, torch.Tensor], total: int,
                           n_chunks: int, slab_bytes: int,
                           ring_bytes: int) -> Dict[str, torch.Tensor]:
        # One full-length program over the same source network: its single
        # run equals the chunked loop (the concatenation invariant), with
        # the feed slabs staged once.
        prog = self._persistent_progs.get(total)
        if prog is None:
            prog = Program(self.source_network,
                           dataclasses.replace(self.plan, n_iterations=total))
            self._persistent_progs[total] = prog
        base = prog.init_state()
        for fifo, arr in arrays.items():
            base = self._with_actor(base, prog._feed_by_fifo[fifo], (arr, 0))
        result = prog.run(base, in_place=True)
        # collect() stays guarded: the state is the twin program's.
        self._last = result
        self._last_is_stream_chunk = True
        self.last_stream_trace = result.trace
        self.last_stream_fire_counts = (dict(result.fire_counts)
                                        if result.fire_counts is not None else None)
        self.last_stream_sweeps = result.sweeps
        self._last_stream = {
            "chunks": n_chunks, "persistent": True,
            "staged_bytes_per_chunk": slab_bytes,
            "total_staged_bytes": ring_bytes + n_chunks * slab_bytes,
        }
        return {f: result.state.actor(prog._fetch_by_fifo[f])[0]
                for f in self._fetch_by_fifo}

    def _stream_chunked(self, arrays: Mapping[str, torch.Tensor], total: int,
                        chunk: int, n_chunks: int, on_fault: str,
                        max_retries: int, slab_bytes: int, ring_bytes: int,
                        report: List[Dict[str, Any]],
                        checkpoint_dir: Optional[str], checkpoint_every: int,
                        start_chunk: int = 0,
                        state: Optional[NetworkState] = None,
                        outs: Optional[Dict[str, list]] = None,
                        traces: Optional[List[Trace]] = None,
                        counts: Optional[Dict[str, int]] = None,
                        sweeps: int = 0) -> Dict[str, torch.Tensor]:
        """The chunk loop, entered at chunk 0 by :meth:`stream` and after
        the newest snapshot by :meth:`resume_stream` with every accumulator
        restored: the loop cannot tell the two apart."""
        if state is None:
            state = self.init_state()
        if outs is None:
            outs = {f: [] for f in self._fetch_by_fifo}
        chunk_traces: List[Trace] = [] if traces is None else traces
        acc_counts = counts
        acc_sweeps = int(sweeps)
        self.last_stream_trace = None
        retrying = on_fault in ("resume", "skip")
        for c in range(start_chunk, n_chunks):
            # The state before the chunk: restoring it re-runs (or skips)
            # the chunk with actor and channel history intact.  A run
            # under a retrying policy works on a copy of it.
            checkpoint = state
            attempts = 0
            while True:
                base = checkpoint
                for fifo, arr in arrays.items():
                    base = self._with_actor(base, self._feed_by_fifo[fifo],
                                            (arr[c * chunk:(c + 1) * chunk], 0))
                for fifo, fetch in self._fetch_by_fifo.items():
                    base = self._with_actor(base, fetch,
                                            (torch.zeros_like(base.actor(fetch)[0]), 0))
                attempts += 1
                try:
                    chunk_res = self.run(base, in_place=not retrying)
                    state = chunk_res.state
                    acc_counts = _add_counts(acc_counts, chunk_res.fire_counts)
                    if chunk_res.sweeps is not None:
                        acc_sweeps += int(chunk_res.sweeps)
                    if chunk_res.trace is not None:
                        chunk_traces.append(chunk_res.trace)
                    # The implicit last state holds only this chunk's fetch
                    # slabs: collect() is guarded from here on.
                    self._last_is_stream_chunk = True
                    if attempts > 1:
                        report.append({"chunk": c, "attempts": attempts,
                                       "action": "recovered", "fault": None})
                    for fifo, fetch in self._fetch_by_fifo.items():
                        outs[fifo].append(state.actor(fetch)[0])
                    break
                except NetworkFaultError as err:
                    self._last_is_stream_chunk = True
                    if on_fault == "resume" and attempts <= max_retries:
                        continue
                    if on_fault == "skip":
                        report.append({"chunk": c, "attempts": attempts,
                                       "action": "skip", "fault": str(err)})
                        state = checkpoint
                        for fifo, fetch in self._fetch_by_fifo.items():
                            outs[fifo].append(torch.zeros_like(state.actor(fetch)[0]))
                        break
                    report.append({"chunk": c, "attempts": attempts,
                                   "action": "raise", "fault": str(err)})
                    err.args = (f"Program.stream: chunk {c} of {n_chunks} "
                                f"failed after {attempts} attempt(s): "
                                f"{err.args[0]}",)
                    raise
            if checkpoint_dir is not None and (
                    (c + 1) % checkpoint_every == 0 or c + 1 == n_chunks):
                # After the chunk commits: the snapshot's step is the count
                # of chunks durably done.
                self._save_stream_snapshot(
                    checkpoint_dir, c + 1, n_chunks, chunk, total, state, outs,
                    acc_counts, acc_sweeps, chunk_traces)
        self.last_stream_fire_counts = (dict(acc_counts)
                                        if acc_counts is not None else None)
        self.last_stream_sweeps = acc_sweeps
        self._last_stream = {
            "chunks": n_chunks, "persistent": False,
            "staged_bytes_per_chunk": ring_bytes + slab_bytes,
            "total_staged_bytes": n_chunks * (ring_bytes + slab_bytes),
        }
        # One trace for the stream: later chunks' sweeps offset past the
        # earlier ones'.
        self.last_stream_trace = merge_traces(chunk_traces)
        return {f: torch.cat(ws, dim=0) for f, ws in outs.items()}

    # ------------------------------------------------------------------ #
    # Durable snapshots.
    # ------------------------------------------------------------------ #
    def _save_stream_snapshot(self, directory: str, done_chunks: int,
                              n_chunks: int, chunk: int, total: int,
                              state: NetworkState, outs: Dict[str, list],
                              counts: Optional[Dict[str, int]], sweeps: int,
                              traces: List[Trace]) -> None:
        payload = {
            "state": self._state_payload(state),
            "outs": {f: list(ws) for f, ws in outs.items()},
            "fire_counts": dict(counts) if counts is not None else None,
            "sweeps": int(sweeps),
            "traces": [_trace_to_payload(t) for t in traces],
        }
        meta = {
            "kind": "stream", "chunk": int(done_chunks),
            "n_chunks": int(n_chunks), "chunk_windows": int(chunk),
            "total_windows": int(total), "mode": self.plan.mode,
            "devices": int(self.plan.devices),
            "feed_fifos": sorted(self._feed_by_fifo),
            "fetch_fifos": sorted(self._fetch_by_fifo),
        }
        # Through the module-level name, so a hook installed on this module
        # sees every snapshot.
        save_stream_checkpoint(directory, int(done_chunks), payload, meta)

    @staticmethod
    def _state_payload(state: NetworkState) -> Dict[str, Any]:
        """A state as name-keyed plain containers: per channel its ring and
        cursors, per actor its leaves in order (host ints as 0-d int32
        arrays, as the reference's int32 scalars)."""
        fifos = {name: {"buf": fs.buf, "rd": _leaf_payload(fs.rd),
                        "wr": _leaf_payload(fs.wr), "occ": _leaf_payload(fs.occ)}
                 for name, fs in zip(state.fifo_names, state.fifos)}
        actors = {name: [_leaf_payload(leaf) for leaf in tree_leaves(a)]
                  for name, a in zip(state.actor_names, state.actors)}
        return {"fifos": fifos, "actors": actors}

    def _state_from_payload(self, payload: Mapping[str, Any]) -> NetworkState:
        """A state of this program's network from a snapshot payload, each
        leaf checked against the template state's shape and placed on its
        device with its dtype."""
        template = self.network.init_state()

        def tensor_like(t: torch.Tensor, saved: Any, what: str) -> torch.Tensor:
            arr = torch.as_tensor(saved)
            if tuple(arr.shape) != tuple(t.shape):
                raise CheckpointIntegrityError(
                    f"snapshot {what} has shape {tuple(arr.shape)}, expected "
                    f"{tuple(t.shape)}")
            return arr.to(device=t.device, dtype=t.dtype).contiguous()

        fifos = []
        for name, fs in zip(template.fifo_names, template.fifos):
            if name not in payload["fifos"]:
                raise CheckpointIntegrityError(
                    f"snapshot has no channel {name!r}; it was taken on a "
                    "different network")
            d = payload["fifos"][name]
            try:
                buf = tensor_like(fs.buf, d["buf"], f"channel {name!r} ring")
            except CheckpointIntegrityError as e:
                raise CheckpointIntegrityError(
                    f"{e}; capacities (Eq. 1) or token shapes differ") from None
            fifos.append(FifoState(buf, int(d["rd"]), int(d["wr"]), int(d["occ"])))
        actors = []
        for name, a in zip(template.actor_names, template.actors):
            if name not in payload["actors"]:
                raise CheckpointIntegrityError(
                    f"snapshot has no actor {name!r}; it was taken on a "
                    "different network")
            saved = list(payload["actors"][name])
            n = len(list(tree_leaves(a)))
            if len(saved) != n:
                raise CheckpointIntegrityError(
                    f"snapshot actor {name!r} carries {len(saved)} state "
                    f"leaves, this network expects {n}")
            it = iter(saved)

            def fill(t: Any) -> Any:
                s = next(it)
                if isinstance(t, torch.Tensor):
                    return tensor_like(t, s, f"actor {name!r} leaf")
                return type(t)(torch.as_tensor(s).item())
            actors.append(tree_map(fill, a))
        return NetworkState(fifos, actors, template.fifo_names, template.actor_names)

    def resume_stream(self, checkpoint_dir: str, feeds: Mapping[str, Any],
                      on_fault: str = "raise", max_retries: int = 2,
                      checkpoint_every: int = 1) -> Dict[str, torch.Tensor]:
        """Continue an interrupted ``stream(checkpoint_dir=...)``.

        Call it on a freshly compiled program over the same network with the
        same feeds: the newest intact snapshot restores the state, fetched
        windows, fire counts, sweeps and chunk traces, and the chunk loop
        goes on at the first unfinished chunk.  Outputs and telemetry are
        bit-identical to the uninterrupted stream; a snapshot that fails its
        CRC is passed over for the next older one.
        """
        arrays, total, chunk, n_chunks, slab_bytes, ring_bytes = \
            self._prepare_stream(feeds, on_fault, max_retries, False,
                                 checkpoint_dir, checkpoint_every)
        payload, meta, _ = load_stream_checkpoint(checkpoint_dir)
        if meta.get("kind") != "stream":
            raise ValueError(
                f"resume_stream: {checkpoint_dir!r} holds a "
                f"{meta.get('kind')!r} checkpoint; those resume via "
                "Program.resume_run")
        if (int(meta["chunk_windows"]) != chunk
                or int(meta["total_windows"]) != total):
            raise ValueError(
                f"resume_stream: snapshot covers chunks of "
                f"{meta['chunk_windows']} windows over a "
                f"{meta['total_windows']}-window stream, but this program "
                f"streams {chunk}-window chunks over {total} windows; "
                "resume with the original plan and feeds")
        state = self._state_from_payload(payload["state"])
        dev = self.network.device
        outs: Dict[str, list] = {
            f: [torch.as_tensor(w).to(device=dev, dtype=self.source_network.fifos[f].dtype)
                for w in payload["outs"].get(f, [])]
            for f in self._fetch_by_fifo}
        counts = (dict(payload["fire_counts"])
                  if payload.get("fire_counts") is not None else None)
        traces = [_trace_from_payload(d) for d in payload.get("traces", [])]
        report: List[Dict[str, Any]] = []
        self.last_stream_report = report
        return self._stream_chunked(
            arrays, total, chunk, n_chunks, on_fault, max_retries, slab_bytes,
            ring_bytes, report, checkpoint_dir, checkpoint_every,
            start_chunk=int(meta["chunk"]), state=state, outs=outs,
            traces=traces, counts=counts, sweeps=int(payload.get("sweeps", 0)))

    # ------------------------------------------------------------------ #
    # Durable segmented runs: run() to quiescence, a snapshot every N
    # sweeps, so a killed process resumes bit-identically.
    # ------------------------------------------------------------------ #
    def _segment_program(self, every_sweeps: int) -> "Program":
        seg = self._segment_progs.get(every_sweeps)
        if seg is None:
            seg = Program(self.source_network,
                          dataclasses.replace(self.plan, max_sweeps=every_sweeps))
            self._segment_progs[every_sweeps] = seg
        return seg

    @staticmethod
    def _run_one_segment(seg_prog: "Program", state: NetworkState
                         ) -> Tuple[RunResult, bool]:
        """One bounded segment, in place; returns (result, stalled).  A
        segment that spends its sweep budget without quiescing is the normal
        case mid-run, so the stall ``run()`` warns or raises about is read
        as a segment boundary; a stall with fault flags set still raises."""
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                res = seg_prog.run(state, in_place=True)
        except NetworkFaultError as err:
            diag = err.diagnostics
            if (diag is not None and diag.stalled and not diag.faults
                    and getattr(err, "result", None) is not None):
                return err.result, True
            raise
        return res, bool(res.stalled)

    def run_checkpointed(self, checkpoint_dir: str, every_sweeps: int,
                         state: Optional[NetworkState] = None,
                         keep: int = 3) -> RunResult:
        """:meth:`run` with a durable snapshot every ``every_sweeps``.

        The run goes in segments (a twin program with
        ``max_sweeps=every_sweeps``; in megakernel mode one B2 launch a
        segment, re-entered with the state the last one left); after each
        the state, summed fire counts, sweeps and traces are committed to
        ``checkpoint_dir``.  After a kill, :meth:`resume_run` continues from
        the newest intact snapshot, and the final result is bit-identical
        to the uninterrupted run: each sweep is a function of the state, so
        cutting the run at sweep boundaries changes only the wall time.
        Dynamic and megakernel mode only; heterogeneous plans checkpoint
        through ``stream(checkpoint_dir=...)``.
        """
        if self.plan.mode not in ("dynamic", "megakernel"):
            raise ValueError(
                f"Program.run_checkpointed: mode {self.plan.mode!r} runs a "
                "fixed iteration count, not to quiescence; checkpoint "
                "streams via stream(checkpoint_dir=...) instead")
        if self.plan.accelerated is not None:
            raise ValueError(
                "Program.run_checkpointed: heterogeneous plans execute via "
                "stream(); use stream(checkpoint_dir=...) for durability")
        if not isinstance(every_sweeps, int) or isinstance(every_sweeps, bool) \
                or every_sweeps < 1:
            raise ValueError(
                f"Program.run_checkpointed: every_sweeps must be an int "
                f">= 1, got {every_sweeps!r}")
        self._check_reentry("Program.run_checkpointed")
        st = (self.init_state() if state is None
              else self.network.state_from_dict(state).clone())
        return self._run_segments(self._segment_program(every_sweeps), st,
                                  counts=None, sweeps_total=0, traces=[],
                                  segment=0, checkpoint_dir=checkpoint_dir,
                                  every_sweeps=every_sweeps, keep=keep)

    def _run_segments(self, seg_prog: "Program", st: NetworkState,
                      counts: Optional[Dict[str, int]], sweeps_total: int,
                      traces: List[Trace], segment: int, checkpoint_dir: str,
                      every_sweeps: int, keep: int) -> RunResult:
        while True:
            res, stalled = self._run_one_segment(seg_prog, st)
            st = res.state
            counts = _add_counts(counts, res.fire_counts)
            if res.sweeps is not None:
                sweeps_total += int(res.sweeps)
            if res.trace is not None:
                traces.append(res.trace)
            segment += 1
            done = not stalled
            over_budget = stalled and sweeps_total >= self.plan.max_sweeps
            payload = {
                "state": self._state_payload(st),
                "outs": {},
                "fire_counts": dict(counts) if counts is not None else None,
                "sweeps": int(sweeps_total),
                "traces": [_trace_to_payload(t) for t in traces],
            }
            meta = {"kind": "run", "segment": int(segment),
                    "every_sweeps": int(every_sweeps),
                    "done": bool(done or over_budget),
                    "mode": self.plan.mode, "devices": int(self.plan.devices)}
            self._commit_run_snapshot(checkpoint_dir, segment, payload, meta, keep)
            if over_budget:
                # run()'s contract on the whole budget (the segment budget is
                # an implementation detail).
                if self.plan.guards and res.diagnostics is not None:
                    err = NetworkFaultError(res.diagnostics)
                    err.result = self._final_run_result(st, counts, sweeps_total,
                                                        traces, res)
                    raise err
                warnings.warn(
                    f"Program.run_checkpointed: stalled after {sweeps_total} "
                    f"sweeps (max_sweeps={self.plan.max_sweeps}) without "
                    "quiescing", RuntimeWarning, stacklevel=2)
                done = True
            if done:
                final = self._final_run_result(st, counts, sweeps_total, traces, res)
                self._last = final
                self._last_is_stream_chunk = False
                return final

    def _commit_run_snapshot(self, checkpoint_dir: str, segment: int,
                             payload: Dict[str, Any], meta: Dict[str, Any],
                             keep: int) -> None:
        """Write one segment's snapshot.  A sharded run's state is
        replicated on every rank, so rank 0 writes it and the ranks meet
        at a barrier: no rank runs on past a snapshot not yet committed."""
        if self._shard_partition is None:
            save_stream_checkpoint(checkpoint_dir, segment, payload, meta, keep=keep)
            return
        import torch.distributed as dist
        if dist.get_rank() == 0:
            save_stream_checkpoint(checkpoint_dir, segment, payload, meta, keep=keep)
        dist.barrier()

    @staticmethod
    def _final_run_result(st: NetworkState, counts: Optional[Dict[str, int]],
                          sweeps_total: int, traces: List[Trace],
                          res: RunResult) -> RunResult:
        return RunResult(
            state=st,
            fire_counts=dict(counts) if counts is not None else None,
            sweeps=sweeps_total if res.sweeps is not None else None,
            stalled=res.stalled,
            diagnostics=res.diagnostics,
            trace=merge_traces(traces) if traces else None)

    def resume_run(self, checkpoint_dir: str, keep: int = 3) -> RunResult:
        """Continue (or recover the result of) a :meth:`run_checkpointed`.

        The newest intact snapshot under ``checkpoint_dir`` is loaded: a
        ``done`` one gives back the final result, anything else continues
        the segments until quiescence.  Either way the result is
        bit-identical to the uninterrupted run.
        """
        payload, meta, _ = load_stream_checkpoint(checkpoint_dir)
        if meta.get("kind") != "run":
            raise ValueError(
                f"resume_run: {checkpoint_dir!r} holds a "
                f"{meta.get('kind')!r} checkpoint; those resume via "
                "Program.resume_stream")
        st = self._state_from_payload(payload["state"])
        counts = (dict(payload["fire_counts"])
                  if payload.get("fire_counts") is not None else None)
        sweeps_total = int(payload.get("sweeps", 0))
        traces = [_trace_from_payload(d) for d in payload.get("traces", [])]
        if meta.get("done"):
            final = RunResult(
                state=st,
                fire_counts=dict(counts) if counts is not None else None,
                sweeps=sweeps_total if sweeps_total else None,
                diagnostics=None,
                trace=merge_traces(traces) if traces else None)
            self._last = final
            self._last_is_stream_chunk = False
            return final
        self._check_reentry("Program.resume_run")
        every = int(meta["every_sweeps"])
        return self._run_segments(
            self._segment_program(every), st, counts=counts,
            sweeps_total=sweeps_total, traces=traces, segment=int(meta["segment"]),
            checkpoint_dir=checkpoint_dir, every_sweeps=every, keep=keep)

    # ------------------------------------------------------------------ #
    def stats(self) -> ProgramStats:
        net = self.network
        last = self._last
        mega: Dict[str, Any] = {}
        layout, part = self._layout, self._partition
        if layout is not None:
            names = tuple(net.actors)
            mega = dict(
                scratch_bytes=part.scratch_bytes(layout),
                transient_scratch_bytes=layout.transient_scratch_bytes,
                forwarded_fifos=tuple(layout.fifo_names[i]
                                      for i in part.forwarded_fifos),
                reclaimed_scratch_bytes=part.reclaimed_ring_bytes(layout),
                grid_cores=part.n_cores,
                partition_actors=tuple(tuple(names[i] for i in rows)
                                       for rows in part.core_rows),
                core_scratch_bytes=part.private_ring_bytes(layout),
                shared_scratch_bytes=(part.shared_ring_bytes(layout)
                                      + part.semaphore_bytes()),
                shared_fifos=tuple(layout.fifo_names[i]
                                   for i in part.shared_fifos),
                core_cursor_rows=part.core_cursor_rows,
                cut_objective=part.objective)
            if last is not None:
                # Every operand the kernel touches: the state plus the
                # DeviceOps' tensors (the reference's hoisted constants).
                mega["hbm_state_bytes"] = (state_hbm_bytes(last.state)
                                           + self._runner.hoisted_const_bytes)
                mega["partition_fire_counts"] = tuple(
                    sum(last.fire_counts[names[i]] for i in rows)
                    for rows in part.core_rows)
        shard: Dict[str, Any] = {}
        if self._shard_partition is not None:
            names = tuple(net.actors)
            shard = dict(
                device_partition_actors=tuple(
                    tuple(names[i] for i in rows)
                    for rows in self._shard_partition.core_rows),
                collective_bytes_per_sweep=collective_bytes_per_sweep(
                    self._shard_layout, self._shard_partition),
                quiescence_allreduces=(int(last.sweeps) if last is not None
                                       and last.sweeps is not None else None))
        ls = self._last_stream or {}
        return ProgramStats(
            mode=self.plan.mode,
            n_actors=len(net.actors),
            n_fifos=len(net.fifos),
            buffer_bytes=net.buffer_bytes(),
            register_fifos=tuple(sorted(net.register_fifos)),
            last_sweeps=last.sweeps if last is not None else None,
            last_fire_counts=(dict(last.fire_counts) if last is not None
                              and last.fire_counts is not None else None),
            last_stream_chunks=ls.get("chunks"),
            last_stream_persistent=ls.get("persistent"),
            last_stream_staged_bytes_per_chunk=ls.get("staged_bytes_per_chunk"),
            last_stream_total_staged_bytes=ls.get("total_staged_bytes"),
            devices=self.plan.devices,
            **mega, **shard)
