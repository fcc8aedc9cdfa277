"""The model of computation: Eq. 1 FIFOs, actors, networks, the builder,
the host executors, ``Program``, the health layer (guards, the firing
trace and fault injection), heterogeneous mapping and pipelines."""
from repro_torch.core.actor import (ActorSpec, DeviceOp, apply_rate_gate,
                                    dynamic_actor, static_actor)
from repro_torch.core.builder import BoundsReport, ChannelBounds, NetworkBuilder
from repro_torch.core.executor import (RuntimeMode, assert_mode_allows, collect_sink,
                                       fire_actor, run_dynamic, run_static)
from repro_torch.core.faultinject import (corrupt_cursor, expire_deadline,
                                          inject_overflow, inject_underflow,
                                          poison_request, poison_tokens,
                                          truncate_feed)
from repro_torch.core.fifo import FifoSpec, FifoState, total_buffer_bytes
from repro_torch.core.mapping import (Placement, boundary_fifos, heterogeneous_split,
                                      partition_actors, stage_feed)
from repro_torch.core.health import (CURSOR_INVALID, DOMAIN, NONFINITE, OVERFLOW,
                                     STALL, UNDERFLOW, ChannelFault, Diagnostics,
                                     HealthState, NetworkFaultError, StallReport,
                                     decode_health, diagnose_stall, fault_names,
                                     init_health)
from repro_torch.core.network import (Edge, Network, NetworkState, iteration_token_flops,
                                      repetition_vector)
from repro_torch.core.pipeline import pipeline_reference, pipeline_spmd
from repro_torch.core.program import ExecutionPlan, Program, ProgramStats, RunResult
from repro_torch.core.trace import (TRACE_CAPACITY_DEFAULT, Profile, Trace,
                                    TraceState, decode_trace, init_trace,
                                    merge_device_traces, merge_traces,
                                    validate_chrome_trace)

__all__ = [
    "ActorSpec", "DeviceOp", "Edge", "ExecutionPlan", "FifoSpec", "FifoState", "Network",
    "NetworkBuilder", "NetworkState", "Program", "ProgramStats", "RunResult",
    "apply_rate_gate", "collect_sink", "dynamic_actor", "fire_actor",
    "run_dynamic", "run_static", "static_actor", "total_buffer_bytes",
    "BoundsReport", "ChannelBounds", "RuntimeMode", "assert_mode_allows",
    "iteration_token_flops", "repetition_vector",
    "OVERFLOW", "UNDERFLOW", "CURSOR_INVALID", "NONFINITE", "STALL", "DOMAIN",
    "ChannelFault", "Diagnostics", "HealthState", "NetworkFaultError",
    "StallReport", "decode_health", "diagnose_stall", "fault_names", "init_health",
    "corrupt_cursor", "inject_overflow", "inject_underflow", "poison_tokens",
    "poison_request", "expire_deadline", "truncate_feed",
    "TRACE_CAPACITY_DEFAULT", "Profile", "Trace", "TraceState", "decode_trace",
    "init_trace", "merge_device_traces", "merge_traces", "validate_chrome_trace",
    "Placement", "boundary_fifos", "heterogeneous_split", "partition_actors",
    "stage_feed", "pipeline_reference", "pipeline_spmd",
]
