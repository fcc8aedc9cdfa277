"""Actor networks ℵ = (A, F) — paper §2.2.

A network is a set of actors joined by FIFO channels; each channel joins
exactly one output port to exactly one input port, and both ports inherit
its rate.  Construction validates the MoC's structural rules and builds the
port -> spec tables the executors index.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.actor import ActorSpec
from repro_torch.core.fifo import FifoSpec, FifoState, total_buffer_bytes
from repro_torch.device import DeviceLike, resolve_device

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (program -> network)
    from repro_torch.core.program import ExecutionPlan, Program


def tree_leaves(x: Any) -> Iterator[Any]:
    if isinstance(x, (tuple, list)):
        for y in x:
            yield from tree_leaves(y)
    elif isinstance(x, dict):
        for k in sorted(x):             # the reference's pytree order
            yield from tree_leaves(x[k])
    else:
        yield x


def tree_map(fn: Callable[[Any], Any], x: Any) -> Any:
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, y) for y in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, x[k]) for k in sorted(x)}
    return fn(x)


@dataclasses.dataclass
class NetworkState:
    """State of a whole network: channel states and actor states in network
    declaration order.

    Actor states are tuples, lists and dicts of tensors (on the network's
    device) and host ints.  :meth:`leaves` flattens everything in the reference's pytree
    leaf order — per channel ``buf, rd, wr, occ``, then each actor's state
    depth first — which is what :mod:`repro_torch.convert` and the parity
    tests rely on.
    """

    fifos: List[FifoState]
    actors: List[Any]
    fifo_names: Tuple[str, ...]
    actor_names: Tuple[str, ...]

    def fifo(self, name: str) -> FifoState:
        return self.fifos[self.fifo_names.index(name)]

    def actor(self, name: str) -> Any:
        return self.actors[self.actor_names.index(name)]

    def leaves(self) -> List[Any]:
        out: List[Any] = []
        for f in self.fifos:
            out += [f.buf, f.rd, f.wr, f.occ]
        for a in self.actors:
            out += list(tree_leaves(a))
        return out

    def map_leaves(self, fn: Callable[[Any], Any]) -> "NetworkState":
        """A new state with ``fn`` applied to every leaf, in :meth:`leaves`
        order."""
        fifos = [FifoState(fn(f.buf), fn(f.rd), fn(f.wr), fn(f.occ))
                 for f in self.fifos]
        actors = [tree_map(fn, a) for a in self.actors]
        return NetworkState(fifos, actors, self.fifo_names, self.actor_names)

    def clone(self) -> "NetworkState":
        """A deep copy: every tensor cloned, host ints copied."""
        return self.map_leaves(
            lambda v: v.clone() if isinstance(v, torch.Tensor) else v)


@dataclasses.dataclass(frozen=True)
class Edge:
    """One channel binding: (src actor, src port) --fifo--> (dst actor, dst port)."""

    fifo: str
    src_actor: str
    src_port: str
    dst_actor: str
    dst_port: str


class Network:
    """Validated actor network (immutable after construction), bound to the
    device its data rings and actor states live on."""

    def __init__(self, actors: List[ActorSpec], fifos: List[FifoSpec],
                 edges: List[Edge],
                 initial_tokens: Optional[Mapping[str, Any]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.actors: Dict[str, ActorSpec] = {a.name: a for a in actors}
        self.fifos: Dict[str, FifoSpec] = {f.name: f for f in fifos}
        self.edges: Tuple[Edge, ...] = tuple(edges)
        self.initial_tokens: Dict[str, Any] = dict(initial_tokens or {})
        if len(self.actors) != len(actors):
            raise ValueError("duplicate actor names")
        if len(self.fifos) != len(fifos):
            raise ValueError("duplicate fifo names")
        self._edge_by_fifo: Dict[str, Edge] = {}
        for e in self.edges:
            if e.fifo in self._edge_by_fifo:
                raise ValueError(f"fifo {e.fifo} bound to more than one edge "
                                 "(channels connect exactly one output to one input)")
            self._edge_by_fifo[e.fifo] = e
        self._validate()
        self.in_fifo: Dict[Tuple[str, str], str] = {
            (e.dst_actor, e.dst_port): e.fifo for e in self.edges}
        self.out_fifo: Dict[Tuple[str, str], str] = {
            (e.src_actor, e.src_port): e.fifo for e in self.edges}
        # Port -> (port, spec, fifo index) tables, built once so the
        # executors never re-resolve names per firing.
        self.fifo_index: Dict[str, int] = {n: i for i, n in enumerate(self.fifos)}
        self.actor_index: Dict[str, int] = {n: i for i, n in enumerate(self.actors)}
        self.in_port_specs: Dict[str, Tuple[Tuple[str, FifoSpec, int], ...]] = {}
        self.out_port_specs: Dict[str, Tuple[Tuple[str, FifoSpec, int], ...]] = {}
        self.control_specs: Dict[str, Optional[Tuple[FifoSpec, int]]] = {}
        for name, a in self.actors.items():
            self.in_port_specs[name] = tuple(
                (p, self.fifos[self.in_fifo[(name, p)]],
                 self.fifo_index[self.in_fifo[(name, p)]])
                for p in a.in_ports)
            self.out_port_specs[name] = tuple(
                (p, self.fifos[self.out_fifo[(name, p)]],
                 self.fifo_index[self.out_fifo[(name, p)]])
                for p in a.out_ports)
            if a.control_port is not None:
                cf = self.in_fifo[(name, a.control_port)]
                self.control_specs[name] = (self.fifos[cf], self.fifo_index[cf])
            else:
                self.control_specs[name] = None
        # Transient (register-allocatable) channels of the specialized
        # static schedule: delay-free channels whose ports are provably
        # enabled together (matched_rates), and control channels with a
        # static producer.  Their occupancy returns to 0 every iteration,
        # so the window is forwarded producer -> consumer without touching
        # the ring.
        reg = set()
        for e in self.edges:
            f = self.fifos[e.fifo]
            if f.delay:
                continue
            src_static = not self.actors[e.src_actor].is_dynamic
            if f.matched_rates or (f.is_control and src_static):
                reg.add(e.fifo)
        self.register_fifos: frozenset = frozenset(reg)

    def _validate(self) -> None:
        for e in self.edges:
            if e.fifo not in self.fifos:
                raise ValueError(f"edge references unknown fifo {e.fifo}")
            if e.src_actor not in self.actors:
                raise ValueError(f"edge references unknown actor {e.src_actor}")
            if e.dst_actor not in self.actors:
                raise ValueError(f"edge references unknown actor {e.dst_actor}")
            src = self.actors[e.src_actor]
            dst = self.actors[e.dst_actor]
            if e.src_port not in src.out_ports:
                raise ValueError(f"{e.src_actor} has no output port {e.src_port}")
            if e.dst_port not in dst.all_in_ports():
                raise ValueError(f"{e.dst_actor} has no input port {e.dst_port}")
            if e.dst_port == dst.control_port and not self.fifos[e.fifo].is_control:
                raise ValueError(
                    f"fifo {e.fifo} feeds control port {e.dst_actor}.{e.dst_port} "
                    "but is not marked is_control (rate-1 rule, paper §2.2)")
        seen_src, seen_dst = set(), set()
        for e in self.edges:
            k_src, k_dst = (e.src_actor, e.src_port), (e.dst_actor, e.dst_port)
            if k_src in seen_src:
                raise ValueError(f"output port {k_src} connected twice")
            if k_dst in seen_dst:
                raise ValueError(f"input port {k_dst} connected twice")
            seen_src.add(k_src)
            seen_dst.add(k_dst)
        for a in self.actors.values():
            for p in a.all_in_ports():
                if (a.name, p) not in seen_dst:
                    raise ValueError(f"input port {a.name}.{p} not connected")
            for p in a.out_ports:
                if (a.name, p) not in seen_src:
                    raise ValueError(f"output port {a.name}.{p} not connected")
        for f in self.fifos.values():
            if f.name not in self._edge_by_fifo:
                raise ValueError(f"fifo {f.name} not bound to any edge")
        for name in self.initial_tokens:
            if name not in self.fifos:
                raise ValueError(f"initial token for unknown fifo {name}")
            if not self.fifos[name].delay:
                raise ValueError(f"initial token for delay-free fifo {name}")

    # ------------------------------------------------------------------ #
    def edge_of(self, fifo_name: str) -> Edge:
        return self._edge_by_fifo[fifo_name]

    def fifo_for_in_port(self, actor: str, port: str) -> FifoSpec:
        return self.fifos[self.in_fifo[(actor, port)]]

    def fifo_for_out_port(self, actor: str, port: str) -> FifoSpec:
        return self.fifos[self.out_fifo[(actor, port)]]

    def sources(self) -> List[str]:
        return [a.name for a in self.actors.values() if a.is_source]

    def sinks(self) -> List[str]:
        return [a.name for a in self.actors.values() if a.is_sink]

    def buffer_bytes(self) -> int:
        """Total communication-buffer memory — paper Table 1 accounting."""
        return total_buffer_bytes(self.fifos.values())

    def compile(self, plan: Optional["ExecutionPlan"] = None,
                **overrides: Any) -> "Program":
        """Compile under an :class:`ExecutionPlan`; keyword ``overrides``
        apply on top of ``plan`` (or of a default plan)."""
        from repro_torch.core.program import ExecutionPlan, Program
        if plan is None:
            plan = ExecutionPlan(**overrides)
        elif overrides:
            plan = dataclasses.replace(plan, **overrides)
        return Program(self, plan)

    def to_dot(self, partition: Optional[Any] = None) -> str:
        """The network as a Graphviz ``digraph``, string for string the
        reference's.

        Actors are nodes (dynamic actors double-bordered, sources and sinks
        tinted); every channel is an edge labelled with its name, ports,
        rate, Eq. 1 capacity and delay; control channels are dashed.  With
        a ``partition`` (a megakernel ``GridPartition`` of this network)
        each core's actors form one ``cluster`` subgraph, channels that
        cross partitions are red with a ``[shared]`` marker and forwarded
        transients carry ``[fwd]``.
        """
        def q(s: str) -> str:
            return '"' + s.replace('"', '\\"') + '"'

        names = list(self.actors)
        lines = [
            "digraph network {",
            "  rankdir=LR;",
            '  node [shape=box, style=rounded, fontname="Helvetica"];',
        ]

        def node_lines(subset, indent="  "):
            out = []
            for name in subset:
                a = self.actors[name]
                attrs = []
                if a.is_dynamic:
                    attrs.append("peripheries=2")
                    label = f"{name}\\n(dynamic, ctrl={a.control_port})"
                else:
                    label = name
                if a.is_source or a.is_sink:
                    attrs.append('style="rounded,filled"')
                    attrs.append('fillcolor="lightgrey"')
                attrs.insert(0, f"label={q(label)}")
                out.append(f"{indent}{q(name)} [{', '.join(attrs)}];")
            return out

        if partition is None:
            lines += node_lines(names)
        else:
            if (len(partition.assignment) != len(names)
                    or len(partition.fifo_cores) != len(self.fifos)):
                raise ValueError(
                    f"to_dot: partition covers {len(partition.assignment)} "
                    f"actors / {len(partition.fifo_cores)} channels but the "
                    f"network has {len(names)} / {len(self.fifos)}; pass "
                    "the GridPartition built from this network")
            for core, rows in enumerate(partition.core_rows):
                lines.append(f"  subgraph cluster_core{core} {{")
                lines.append(f'    label="core {core}"; style=dashed;')
                lines += node_lines([names[i] for i in rows], indent="    ")
                lines.append("  }")
        forwarded = set(partition.forwarded_fifos) if partition is not None else set()
        for e in self.edges:
            f = self.fifos[e.fifo]
            label = (f"{f.name}\\n{e.src_port}->{e.dst_port} "
                     f"r={f.rate} cap={f.capacity_tokens}")
            if f.delay:
                label += f" delay={f.delay}"
            attrs = []
            if f.is_control:
                attrs.append("style=dashed")
            if partition is not None:
                fi = self.fifo_index[e.fifo]
                if partition.fifo_cores[fi] < 0:      # shared (crossing)
                    label += " [shared]"
                    attrs += ["color=red", "penwidth=2.0"]
                elif fi in forwarded:
                    label += " [fwd]"
            attrs.insert(0, f"label={q(label)}")
            lines.append(f"  {q(e.src_actor)} -> {q(e.dst_actor)} "
                         f"[{', '.join(attrs)}];")
        lines.append("}")
        return "\n".join(lines)

    def init_state(self) -> NetworkState:
        """Fresh state: data rings on the network's device, control rings
        in host memory, actor states from each actor's ``init``."""
        fifo_states = [spec.init_state(self.device, self.initial_tokens.get(name))
                       for name, spec in self.fifos.items()]
        actor_states = [a.init_state() for a in self.actors.values()]
        return NetworkState(fifo_states, actor_states, tuple(self.fifos),
                            tuple(self.actors))

    def state_from_dict(self, state: Mapping[str, Any]) -> NetworkState:
        """A legacy ``{"fifos": {name: ...}, "actors": {name: ...}}`` dict
        state as a :class:`NetworkState` (one is returned as it is)."""
        if isinstance(state, NetworkState):
            return state
        return NetworkState([state["fifos"][n] for n in self.fifos],
                            [state["actors"][n] for n in self.actors],
                            tuple(self.fifos), tuple(self.actors))

    # ------------------------------------------------------------------ #
    def precedence_edges(self, ignore_delay: bool = True) -> List[Tuple[str, str]]:
        """(producer, consumer) pairs for one-iteration scheduling; a delay
        breaks precedence only when it covers a whole read window."""
        out = []
        for e in self.edges:
            f = self.fifos[e.fifo]
            if ignore_delay and f.delay >= f.rate:
                continue
            out.append((e.src_actor, e.dst_actor))
        return out

    def topological_order(self) -> List[str]:
        """Topological sort with delay edges broken (the reference's exact
        stack order); raises on a cycle without a delay token."""
        names = list(self.actors)
        idx = {n: i for i, n in enumerate(names)}
        n = len(names)
        adj: List[List[int]] = [[] for _ in range(n)]
        indeg = [0] * n
        for u, v in self.precedence_edges(ignore_delay=True):
            adj[idx[u]].append(idx[v])
            indeg[idx[v]] += 1
        order, stack = [], [i for i in range(n) if indeg[i] == 0]
        while stack:
            u = stack.pop()
            order.append(u)
            for v in adj[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        if len(order) != n:
            stuck = [names[i] for i in range(n) if indeg[i] > 0]
            raise ValueError(
                "network deadlock: cycle without an initial (delay) token "
                f"through actors {stuck} — paper §2.2 requires a delay token "
                "on feedback loops")
        return [names[i] for i in order]

    def check_schedule_feasible(self, order: Optional[List[str]] = None) -> None:
        """Simulate one iteration of the single-appearance schedule on
        occupancy counters: no read underflows, no write exceeds the Eq. 1
        blocking bound, every channel returns to its initial occupancy."""
        occ = {name: spec.delay for name, spec in self.fifos.items()}
        for actor in (order if order is not None else self.topological_order()):
            a = self.actors[actor]
            for p in a.all_in_ports():
                f = self.fifo_for_in_port(actor, p)
                need = 1 if p == a.control_port else f.rate
                if occ[f.name] < need:
                    raise ValueError(
                        f"schedule infeasible: {actor}.{p} reads {need} from "
                        f"{f.name} holding {occ[f.name]}")
                occ[f.name] -= need
            for p in a.out_ports:
                f = self.fifo_for_out_port(actor, p)
                if occ[f.name] + f.rate > f.writable_occupancy_bound:
                    raise ValueError(
                        f"schedule infeasible: {actor}.{p} writes {f.rate} to "
                        f"{f.name} at {occ[f.name]}/{f.writable_occupancy_bound} "
                        "— blocking bound violated (Eq. 1 phase pattern)")
                occ[f.name] += f.rate
        for name, spec in self.fifos.items():
            if occ[name] != spec.delay:
                raise ValueError(
                    f"unbalanced iteration: fifo {name} ends at occupancy "
                    f"{occ[name]} != initial {spec.delay}")

    # ------------------------------------------------------------------ #
    # Grid partitioning (megakernel multi-core sweeps, paper §3.3).        #
    # ------------------------------------------------------------------ #
    def delay_partition_constraints(self) -> List[Tuple[str, str, str]]:
        """Delay channels whose endpoints must share a grid partition.

        Returns ``(fifo, src_actor, dst_actor)`` for every delay channel
        whose initial tokens do NOT cover a whole read window
        (``delay < rate``): its Fig. 2 copy-back lands while the reader may
        hold a window overlapping slot 0, which only one core's sequential
        sweep orders.
        """
        out = []
        for e in self.edges:
            f = self.fifos[e.fifo]
            if f.delay and f.delay < f.rate:
                out.append((e.fifo, e.src_actor, e.dst_actor))
        return out

    def validate_partition(self, assignment: Mapping[str, int],
                           cores: int, unit: str = "core") -> None:
        """Check an actor -> core map against the grid-partition rules: it
        covers every actor exactly, uses cores in ``[0, cores)``, and keeps
        both endpoints of every :meth:`delay_partition_constraints` channel
        on one core.  Raises ``ValueError`` naming the offenders."""
        unknown = set(assignment) - set(self.actors)
        if unknown:
            raise ValueError(
                f"partition assignment names unknown actors "
                f"{sorted(unknown)}; known: {sorted(self.actors)}")
        missing = set(self.actors) - set(assignment)
        if missing:
            raise ValueError(
                f"partition assignment must map every actor to a {unit} "
                f"(the firing table is partitioned, not filtered); "
                f"missing {sorted(missing)}")
        bad = {n: c for n, c in assignment.items()
               if not isinstance(c, int) or not 0 <= c < cores}
        if bad:
            raise ValueError(
                f"partition assignment maps actors to {unit}s outside "
                f"[0, {cores}): {dict(sorted(bad.items()))}")
        for fifo, src, dst in self.delay_partition_constraints():
            if assignment[src] != assignment[dst]:
                spec = self.fifos[fifo]
                raise ValueError(
                    f"delay channel {fifo!r} ({src} -> {dst}, rate "
                    f"{spec.rate}, delay {spec.delay}) may not cross "
                    f"partitions ({unit}s {assignment[src]} vs "
                    f"{assignment[dst]}): its initial tokens do not "
                    "cover a whole read window (delay < rate), so the "
                    "Fig. 2 copy-back races the remote reader's phase-0 "
                    f"window; assign both endpoints to one {unit}")


def repetition_vector(network: Network) -> Dict[str, int]:
    """The SDF repetition vector (Lee & Messerschmitt) of this MoC: both
    ports of a channel carry its rate, so production equals consumption on
    every edge and the minimal vector is all ones, for every connected
    component alike."""
    return {name: 1 for name in network.actors}


def iteration_token_flops(network: Network) -> int:
    """Static FLOP estimate of one iteration, from the actors' annotations."""
    return int(sum(a.cost_flops for a in network.actors.values()))
