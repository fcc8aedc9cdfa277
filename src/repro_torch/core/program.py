"""Program: the compile/run entry point — paper §3.4.

::

    prog = net.compile(ExecutionPlan(mode="static", n_iterations=8))
    result = prog.run()                 # RunResult(state, counts, sweeps)

The port carries the reference's host-driven ``"static"``, ``"dynamic"``
and ``"interpreted"`` modes and its ``"megakernel"`` mode (one launch of
the persistent kernel B2 per run on the card; its plain version for CPU
states), with the grid knobs ``cores``, ``assign`` and ``cut_objective``.  Every other mode or plan field
of the reference raises with the ROADMAP item that ports it; none is
silently ignored.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.executor import collect_sink, run_dynamic, run_static
from repro_torch.core.megakernel import (CUT_OBJECTIVES, compile_megakernel,
                                         lower_network, partition_layout,
                                         state_hbm_bytes)
from repro_torch.core.network import Network, NetworkState

_MODES = ("static", "dynamic", "interpreted", "megakernel")

#: Reference plan fields not ported yet -> the ROADMAP item that ports them.
_UNPORTED_FIELDS = {
    "donate": "A3 (the port updates rings in place; Program.run(state, "
              "in_place=True) is its form of donation)",
    "donate_threshold_bytes": "A3 (donation)",
    "runtime_mode": "A3 (STATIC_DAL runtime mode)",
    "unroll_bound": "A3 (eager cursors need no phase unroll)",
    "accelerated": "A11 (heterogeneous mapping) and A9 (Program.stream)",
    "guards": "A7 (health guards)",
    "trace": "A7 (firing trace)",
    "trace_capacity": "A7 (firing trace)",
    "profile": "A7 (firing trace)",
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
      cores:         megakernel mode: grid partitions of the firing table
                     (the reference's actor-to-core mapping).  The port's
                     kernel runs the partitions' visit order in one
                     replicated scheduler, so results equal ``cores=1``.
      assign:        megakernel mode: explicit actor -> core map.
      cut_objective: megakernel mode: ``"crossing"`` or ``"flops"`` default
                     cut; ``"profile"`` raises (ROADMAP A7).
      interpret:     the reference's Pallas interpret switch; the port
                     raises, since the state's device picks the kernel or
                     its plain version.

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
    runtime_mode: Any = None
    unroll_bound: Any = None
    interpret: Any = None
    cores: int = 1
    assign: Optional[Any] = None
    cut_objective: str = "crossing"
    accelerated: Any = None
    guards: Any = None
    trace: Any = None
    trace_capacity: Any = None
    profile: Any = None
    devices: Any = None
    device_assign: Any = None

    def __post_init__(self) -> None:
        mode = getattr(self.mode, "value", self.mode)
        object.__setattr__(self, "mode", mode)
        if mode not in _MODES:
            raise ValueError(
                f"ExecutionPlan.mode must be one of {_MODES}, got {mode!r}")
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
        if self.assign is not None:
            network.validate_partition(dict(self.assign), self.cores)
        return self


@dataclasses.dataclass(frozen=True)
class RunResult:
    """One execution's outcome; ``fire_counts`` / ``sweeps`` / ``stalled``
    are set by the dynamic and megakernel modes only."""

    state: NetworkState
    fire_counts: Optional[Dict[str, int]] = None
    sweeps: Optional[int] = None
    stalled: bool = False


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


class Program:
    """A network compiled under a plan; built by :meth:`Network.compile`."""

    def __init__(self, network: Network, plan: ExecutionPlan):
        self.network = network
        self.plan = plan.validate(network)
        self._last: Optional[RunResult] = None
        self._layout = self._partition = self._runner = None
        if plan.mode == "megakernel":
            # Lower and partition once, as the reference does.
            self._layout = lower_network(network)
            self._partition = partition_layout(
                network, self._layout, plan.cores,
                dict(plan.assign) if plan.assign is not None else None,
                objective=plan.cut_objective,
                forward_transients=plan.specialize)
            self._runner = compile_megakernel(
                network, plan.max_sweeps, plan.multi_firing,
                layout=self._layout, partition=self._partition)

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
            if plan.mode == "dynamic":
                st, counts, sweeps, stalled = run_dynamic(
                    self.network, st, plan.max_sweeps, plan.multi_firing)
            else:
                st, counts, sweeps, stalled = self._runner(st)
            result = RunResult(st, fire_counts=counts, sweeps=sweeps,
                               stalled=stalled)
            if stalled:
                warnings.warn(
                    f"Program.run: sweep budget (max_sweeps={plan.max_sweeps}) "
                    "exhausted with work remaining — partial state returned",
                    RuntimeWarning, stacklevel=2)
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
