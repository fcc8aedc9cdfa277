"""Program: the compile/run entry point — paper §3.4.

::

    prog = net.compile(ExecutionPlan(mode="static", n_iterations=8))
    result = prog.run()                 # RunResult(state, counts, sweeps)

The port carries the reference's host-driven ``"static"``, ``"dynamic"``
and ``"interpreted"`` modes and its ``"megakernel"`` mode (one launch of
the persistent kernel B2 per run on the card; its plain version for CPU
states), with the grid knobs ``cores``, ``assign`` and ``cut_objective``,
the health layer's ``guards``, ``trace``, ``trace_capacity`` and
``profile``, and ``runtime_mode``.  Every other mode or plan field of the
reference raises with the ROADMAP item that ports it; none is silently
ignored.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.core.executor import (RuntimeMode, assert_mode_allows, collect_sink,
                                       run_dynamic, run_static)
from repro_torch.core.health import Diagnostics, NetworkFaultError, decode_health
from repro_torch.core.megakernel import (CUT_OBJECTIVES, compile_megakernel,
                                         lower_network, partition_layout,
                                         state_hbm_bytes)
from repro_torch.core.network import Network, NetworkState
from repro_torch.core.trace import TRACE_CAPACITY_DEFAULT, Trace, decode_trace

_MODES = ("static", "dynamic", "interpreted", "megakernel")

#: Reference plan fields not ported yet -> the ROADMAP item that ports them.
_UNPORTED_FIELDS = {
    "donate": "A3 (the port updates rings in place; Program.run(state, "
              "in_place=True) is its form of donation)",
    "donate_threshold_bytes": "A3 (donation)",
    "unroll_bound": "A3 (eager cursors need no phase unroll)",
    "accelerated": "A11 (heterogeneous mapping and Program.stream)",
    "devices": "A12 (multi-device)",
    "device_assign": "A12 (multi-device)",
}


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
      n_iterations:  iteration count of static and interpreted mode.
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
                     any other value raises ``ValueError``.  Judged when the program is
                     built, in static, dynamic and megakernel mode;
                     interpreted mode is the host-thread baseline, which
                     the reference does not check either.
      cores:         megakernel mode: grid partitions of the firing table
                     (the reference's actor-to-core mapping).  The port's
                     kernel runs the partitions' visit order in one
                     replicated scheduler, so results equal ``cores=1``.
      assign:        megakernel mode: explicit actor -> core map.
      cut_objective: megakernel mode: ``"crossing"`` or ``"flops"`` default
                     cut, or ``"profile"``: the crossing cut over the
                     measured weights of ``profile``.
      interpret:     the reference's Pallas interpret switch; the port
                     raises, since the state's device picks the kernel or
                     its plain version.
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
    accelerated: Any = None
    guards: bool = False
    trace: bool = False
    trace_capacity: Optional[int] = None
    profile: Optional[Any] = None
    devices: Any = None
    device_assign: Any = None

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
        if self.assign is not None:
            # A sorted pair tuple keeps the frozen plan immutable.
            object.__setattr__(self, "assign", tuple(sorted(
                (str(k), int(v)) for k, v in dict(self.assign).items())))
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

    def validate(self, network: Network) -> "ExecutionPlan":
        """The cross-field rules against ``network``, judged when a
        :class:`Program` is built (the reference's ``program.py:370-378``
        and ``:455``)."""
        if (self.cores != 1 or self.assign is not None
                or self.cut_objective != "crossing") \
                and self.mode != "megakernel":
            raise ValueError(
                f"ExecutionPlan(mode={self.mode!r}): cores=/assign=/"
                "cut_objective= are grid-partition knobs of the megakernel "
                "backend; the host executors have no core axis (use "
                "mode='megakernel')")
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
        if self.assign is not None:
            network.validate_partition(dict(self.assign), self.cores)
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
    and ``partition_fire_counts`` after a run."""

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


class Program:
    """A network compiled under a plan; built by :meth:`Network.compile`."""

    def __init__(self, network: Network, plan: ExecutionPlan):
        self.network = network
        self.plan = plan.validate(network)
        if plan.mode != "interpreted":
            assert_mode_allows(network, plan.runtime_mode)
        self._last: Optional[RunResult] = None
        self._layout = self._partition = self._runner = None
        if plan.mode == "megakernel":
            # Lower and partition once, as the reference does.
            self._layout = lower_network(network)
            self._partition = partition_layout(
                network, self._layout, plan.cores,
                dict(plan.assign) if plan.assign is not None else None,
                objective=plan.cut_objective,
                forward_transients=plan.specialize,
                profile=({k: dict(v) for k, v in plan.profile}
                         if plan.profile is not None else None))
            self._runner = compile_megakernel(
                network, plan.max_sweeps, plan.multi_firing,
                layout=self._layout, partition=self._partition,
                guards=plan.guards, trace_capacity=self._trace_capacity)

    @property
    def _trace_capacity(self) -> Optional[int]:
        if not self.plan.trace:
            return None
        return self.plan.trace_capacity or TRACE_CAPACITY_DEFAULT

    def init_state(self) -> NetworkState:
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
            st = state if in_place else state.clone()
        plan = self.plan
        if plan.mode in ("dynamic", "megakernel"):
            t0 = time.perf_counter()
            if plan.mode == "dynamic":
                res = run_dynamic(self.network, st, plan.max_sweeps,
                                  plan.multi_firing, guards=plan.guards,
                                  trace_capacity=self._trace_capacity)
            else:
                res = self._runner(st)
            st, counts, sweeps, stalled = res
            trace = None
            if res.trace is not None:
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
            state = self._last.state
        return collect_sink(self.network, state, actor)

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
        return ProgramStats(
            mode=self.plan.mode,
            n_actors=len(net.actors),
            n_fifos=len(net.fifos),
            buffer_bytes=net.buffer_bytes(),
            register_fifos=tuple(sorted(net.register_fifos)),
            last_sweeps=last.sweeps if last is not None else None,
            last_fire_counts=(dict(last.fire_counts) if last is not None
                              and last.fire_counts is not None else None),
            **mega)
