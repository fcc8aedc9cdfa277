"""Program: the compile/run entry point — paper §3.4.

::

    prog = net.compile(ExecutionPlan(mode="static", n_iterations=8))
    result = prog.run()                 # RunResult(state, counts, sweeps)

The port carries the reference's host-driven ``"static"`` and ``"dynamic"``
modes.  Every other mode or plan field of the reference raises with the
ROADMAP item that ports it; none is silently ignored.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.executor import collect_sink, run_dynamic, run_static
from repro_torch.core.network import Network, NetworkState

_MODES = ("static", "dynamic")

#: Reference modes not ported yet -> the ROADMAP item that ports them.
_UNPORTED_MODES = {
    "megakernel": "B2 (persistent scheduler kernel, with A5)",
    "interpreted": "A3 (interpreted mode)",
}

#: Reference plan fields not ported yet -> the ROADMAP item that ports them.
_UNPORTED_FIELDS = {
    "donate": "A3 (the port updates rings in place; Program.run(state, "
              "in_place=True) is its form of donation)",
    "donate_threshold_bytes": "A3 (donation)",
    "runtime_mode": "A3 (STATIC_DAL runtime mode)",
    "unroll_bound": "A3 (eager cursors need no phase unroll)",
    "interpret": "B2 (persistent scheduler kernel)",
    "cores": "B2 (persistent scheduler kernel)",
    "assign": "B2 (persistent scheduler kernel)",
    "cut_objective": "B2 (persistent scheduler kernel)",
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
      mode:         ``"static"`` (single-appearance schedule for
                    ``n_iterations``) or ``"dynamic"`` (token-driven
                    sweeps to quiescence).
      n_iterations: iteration count of static mode.
      specialize:   static mode: forward the windows of transient
                    (``register_fifos``) channels instead of buffering.
      multi_firing: dynamic mode: fire each actor up to its occupancy
                    bound per visit.
      max_sweeps:   dynamic mode sweep bound.
      order:        optional static firing order (defaults topological).

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
    cores: Any = None
    assign: Any = None
    cut_objective: Any = None
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
        if mode in _UNPORTED_MODES:
            raise NotImplementedError(
                f"ExecutionPlan(mode={mode!r}) is not ported yet: ROADMAP "
                f"{_UNPORTED_MODES[mode]}")
        if mode not in _MODES:
            raise ValueError(
                f"ExecutionPlan.mode must be one of {_MODES}, got {mode!r}")
        for field, item in _UNPORTED_FIELDS.items():
            if getattr(self, field) is not None:
                raise NotImplementedError(
                    f"ExecutionPlan.{field} is not ported yet: ROADMAP {item}")
        if self.n_iterations is not None and self.n_iterations < 0:
            raise ValueError(
                f"ExecutionPlan: n_iterations must be >= 0, got {self.n_iterations}")
        if self.mode == "static" and self.n_iterations is None:
            raise ValueError(
                "ExecutionPlan(mode='static'): pass n_iterations= — the "
                "static schedule runs a fixed iteration count (dynamic mode "
                "runs to quiescence without one)")
        if self.order is not None:
            object.__setattr__(self, "order", tuple(self.order))


@dataclasses.dataclass(frozen=True)
class RunResult:
    """One execution's outcome; ``fire_counts`` / ``sweeps`` / ``stalled``
    are set by dynamic mode only."""

    state: NetworkState
    fire_counts: Optional[Dict[str, int]] = None
    sweeps: Optional[int] = None
    stalled: bool = False


@dataclasses.dataclass(frozen=True)
class ProgramStats:
    """The buffer accounting of a compiled program plus its last run's
    sweeps and fire counts."""

    mode: str
    n_actors: int
    n_fifos: int
    buffer_bytes: int
    register_fifos: Tuple[str, ...]
    last_sweeps: Optional[int] = None
    last_fire_counts: Optional[Dict[str, int]] = None


class Program:
    """A network compiled under a plan; built by :meth:`Network.compile`."""

    def __init__(self, network: Network, plan: ExecutionPlan):
        self.network = network
        self.plan = plan
        self._last: Optional[RunResult] = None

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
        if plan.mode == "dynamic":
            st, counts, sweeps, stalled = run_dynamic(
                self.network, st, plan.max_sweeps, plan.multi_firing)
            result = RunResult(st, fire_counts=counts, sweeps=sweeps,
                               stalled=stalled)
            if stalled:
                warnings.warn(
                    f"Program.run: sweep budget (max_sweeps={plan.max_sweeps}) "
                    "exhausted with work remaining — partial state returned",
                    RuntimeWarning, stacklevel=2)
        else:
            order = list(plan.order) if plan.order is not None else None
            result = RunResult(run_static(self.network, st, plan.n_iterations,
                                          order=order,
                                          specialize=plan.specialize))
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
        return ProgramStats(
            mode=self.plan.mode,
            n_actors=len(net.actors),
            n_fifos=len(net.fifos),
            buffer_bytes=net.buffer_bytes(),
            register_fifos=tuple(sorted(net.register_fifos)),
            last_sweeps=last.sweeps if last is not None else None,
            last_fire_counts=(dict(last.fire_counts) if last is not None
                              and last.fire_counts is not None else None))
