"""The model of computation: Eq. 1 FIFOs, actors, networks, the builder,
the host executors and ``Program``."""
from repro_torch.core.actor import (ActorSpec, DeviceOp, apply_rate_gate,
                                    dynamic_actor, static_actor)
from repro_torch.core.builder import NetworkBuilder
from repro_torch.core.executor import collect_sink, fire_actor, run_dynamic, run_static
from repro_torch.core.fifo import FifoSpec, FifoState, total_buffer_bytes
from repro_torch.core.network import Edge, Network, NetworkState
from repro_torch.core.program import ExecutionPlan, Program, ProgramStats, RunResult

__all__ = [
    "ActorSpec", "DeviceOp", "Edge", "ExecutionPlan", "FifoSpec", "FifoState", "Network",
    "NetworkBuilder", "NetworkState", "Program", "ProgramStats", "RunResult",
    "apply_rate_gate", "collect_sink", "dynamic_actor", "fire_actor",
    "run_dynamic", "run_static", "static_actor", "total_buffer_bytes",
]
