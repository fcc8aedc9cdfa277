"""Lowering pass: Network -> megakernel layout, firing table and grid cut.

The port of ``src/repro/core/megakernel/lower.py``: pure build-time layout
math, with the reference's tables, byte counts and cut heuristics.

Outputs of :func:`lower_network`:

  * **scratch layout** — one Eq. 1 ring per channel,
    ``(capacity_tokens, *token_shape)``, plus one packed ``(n_fifos, 3)``
    int32 cursor block (rd / wr / occ per channel);
  * **firing table** — one :class:`FiringRow` per actor in declaration
    order (the host dynamic scheduler's visit order), each port resolved to
    its flat channel index;
  * ``Network.register_fifos`` as the transient set (the core-private
    subset is forwarded, see :func:`partition_layout`) and the phase-unroll
    period (recorded, not acted on).

:func:`partition_layout` classifies each channel as core-private or
:data:`SHARED` and picks the actor-to-core cut: by default the contiguous
cut of the visit order that minimizes the ring bytes of crossing channels
among cuts whose ``cost_flops`` bottleneck stays within
:data:`_CUT_BALANCE_SLACK` of the optimum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.fifo import FifoSpec
from repro_torch.core.network import Network
from repro_torch.core.schedule import phase_unroll_period

# One packed cursor row per channel: (rd, wr, occ) int32.
CURSOR_FIELDS = 3
_CURSOR_ITEMSIZE = 4

#: ``GridPartition.fifo_cores`` value for a partition-crossing channel.
SHARED = -1

#: Partition-cut objectives.  ``"crossing"`` (default) minimizes crossing
#: ring bytes within the balance slack, ``"flops"`` balances ``cost_flops``
#: alone, ``"profile"`` is the crossing cut over measured weights from a
#: traced run (``Profile.as_cut_weights()``).
CUT_OBJECTIVES = ("crossing", "flops", "profile")

#: How far above the flops-only optimal bottleneck the crossing cut may
#: trade load balance for locality.
_CUT_BALANCE_SLACK = 1.25


@dataclasses.dataclass(frozen=True)
class PortBinding:
    """One regular port resolved to its flat channel index."""

    port: str
    fifo: int


@dataclasses.dataclass(frozen=True)
class FiringRow:
    """One actor's row in the firing table: ``control`` is the flat index
    of the control channel (None for static actors); ``inputs`` /
    ``outputs`` are the regular ports in declaration order."""

    name: str
    index: int
    control: Optional[int]
    inputs: Tuple[PortBinding, ...]
    outputs: Tuple[PortBinding, ...]
    is_dynamic: bool
    has_ready: bool


@dataclasses.dataclass(frozen=True)
class MegakernelLayout:
    """Static layout of one lowered network."""

    fifo_names: Tuple[str, ...]
    fifo_specs: Tuple[FifoSpec, ...]
    firing_table: Tuple[FiringRow, ...]
    transient_fifos: frozenset
    unroll_period: int

    @property
    def ring_scratch_bytes(self) -> int:
        """Eq. 1 capacities summed."""
        return sum(s.capacity_bytes for s in self.fifo_specs)

    @property
    def cursor_bytes(self) -> int:
        return len(self.fifo_specs) * CURSOR_FIELDS * _CURSOR_ITEMSIZE

    @property
    def scratch_bytes(self) -> int:
        return self.ring_scratch_bytes + self.cursor_bytes

    @property
    def transient_scratch_bytes(self) -> int:
        """Ring bytes of the transient channels: the most forwarding can
        reclaim."""
        return sum(s.capacity_bytes for s in self.fifo_specs
                   if s.name in self.transient_fifos)

    def scratch_shape(self, fifo_index: int) -> Tuple[int, ...]:
        spec = self.fifo_specs[fifo_index]
        return (spec.capacity_tokens,) + tuple(spec.token_shape)


def lower_network(network: Network) -> MegakernelLayout:
    """Flatten a validated network into the megakernel's static tables."""
    fifo_names = tuple(network.fifos)
    fifo_specs = tuple(network.fifos[n] for n in fifo_names)
    rows = []
    for index, (name, actor) in enumerate(network.actors.items()):
        ctl = network.control_specs[name]
        rows.append(FiringRow(
            name=name,
            index=index,
            control=None if ctl is None else ctl[1],
            inputs=tuple(PortBinding(p, fi)
                         for p, _, fi in network.in_port_specs[name]),
            outputs=tuple(PortBinding(p, fi)
                          for p, _, fi in network.out_port_specs[name]),
            is_dynamic=actor.is_dynamic,
            has_ready=actor.ready is not None,
        ))
    period = phase_unroll_period(
        [spec.n_write_phases for name, spec in network.fifos.items()
         if name not in network.register_fifos])
    return MegakernelLayout(
        fifo_names=fifo_names,
        fifo_specs=fifo_specs,
        firing_table=tuple(rows),
        transient_fifos=frozenset(network.register_fifos),
        unroll_period=period,
    )


# --------------------------------------------------------------------------- #
# Grid partitioning: actors -> cores (paper §3.3 actor-to-core mapping).
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GridPartition:
    """Actor-to-core mapping of one lowered network.

    ``assignment[i]`` is the core owning actor ``i``; ``core_rows[c]`` are
    core ``c``'s firing-table indices in visit order; ``fifo_cores[f]`` is
    the core whose private block holds channel ``f``, or :data:`SHARED`.
    ``forwarded_fifos`` are the core-private transient channels, which hold
    no ring scratch and start every run from zeros.
    """

    n_cores: int
    assignment: Tuple[int, ...]
    core_rows: Tuple[Tuple[int, ...], ...]
    fifo_cores: Tuple[int, ...]
    forwarded_fifos: Tuple[int, ...] = ()
    objective: str = "crossing"

    @property
    def shared_fifos(self) -> Tuple[int, ...]:
        return tuple(i for i, c in enumerate(self.fifo_cores) if c == SHARED)

    def private_fifos(self, core: int) -> Tuple[int, ...]:
        return tuple(i for i, c in enumerate(self.fifo_cores) if c == core)

    @property
    def cursor_rows(self) -> Tuple[Tuple[int, ...], ...]:
        """Channel indices per cursor block: one private block per core,
        then the shared (semaphore) block."""
        return tuple(self.private_fifos(core)
                     for core in range(self.n_cores)) + (self.shared_fifos,)

    @property
    def core_cursor_rows(self) -> Tuple[int, ...]:
        return tuple(len(self.private_fifos(c)) for c in range(self.n_cores))

    def private_ring_bytes(self, layout: MegakernelLayout) -> Tuple[int, ...]:
        fwd = set(self.forwarded_fifos)
        return tuple(
            sum(layout.fifo_specs[i].capacity_bytes
                for i in self.private_fifos(core) if i not in fwd)
            for core in range(self.n_cores))

    def shared_ring_bytes(self, layout: MegakernelLayout) -> int:
        return sum(layout.fifo_specs[i].capacity_bytes
                   for i in self.shared_fifos)

    def reclaimed_ring_bytes(self, layout: MegakernelLayout) -> int:
        return sum(layout.fifo_specs[i].capacity_bytes
                   for i in self.forwarded_fifos)

    def scratch_bytes(self, layout: MegakernelLayout) -> int:
        return layout.scratch_bytes - self.reclaimed_ring_bytes(layout)

    def semaphore_bytes(self) -> int:
        return len(self.shared_fifos) * CURSOR_FIELDS * _CURSOR_ITEMSIZE


def _glued_units(network: Network) -> List[List[int]]:
    """Actor indices grouped into partition units (union-find over
    :meth:`Network.delay_partition_constraints`), in first-member order."""
    names = list(network.actors)
    idx = {n: i for i, n in enumerate(names)}
    parent = list(range(len(names)))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for _, src, dst in network.delay_partition_constraints():
        a, b = find(idx[src]), find(idx[dst])
        if a != b:
            parent[max(a, b)] = min(a, b)
    units: List[List[int]] = []
    unit_of_root: dict = {}
    for i in range(len(names)):
        r = find(i)
        if r not in unit_of_root:
            unit_of_root[r] = len(units)
            units.append([])
        units[unit_of_root[r]].append(i)
    return units


def _balanced_cut(weights: List[int], cores: int) -> Tuple[List[int], int]:
    """Contiguous cut of ``weights`` into ``cores`` groups minimizing the
    largest group (linear-partition DP; ties toward earlier cuts).
    Returns ``(group per unit, optimal bottleneck)``."""
    n = len(weights)
    prefix = [0]
    for w in weights:
        prefix.append(prefix[-1] + w)
    INF = float("inf")
    best = [[INF] * (n + 1) for _ in range(cores + 1)]
    cut = [[0] * (n + 1) for _ in range(cores + 1)]
    best[0][0] = 0
    for c in range(1, cores + 1):
        for j in range(c, n + 1):
            for i in range(c - 1, j):
                cand = max(best[c - 1][i], prefix[j] - prefix[i])
                if cand < best[c][j]:
                    best[c][j] = cand
                    cut[c][j] = i
    groups = [0] * n
    j = n
    for c in range(cores, 0, -1):
        i = cut[c][j]
        for u in range(i, j):
            groups[u] = c - 1
        j = i
    return groups, int(best[cores][n])


def _crossing_cut(weights: List[int], spans: List[Tuple[int, int, int]],
                  cores: int, bottleneck_cap: int) -> List[int]:
    """Contiguous cut minimizing ``(crossing bytes, bottleneck)``
    lexicographically over cuts whose groups stay within
    ``bottleneck_cap``.  ``spans`` lists each channel as ``(umin, umax,
    bytes)``; a channel is counted once, in the group holding its left
    endpoint.  Ties break toward earlier cuts."""
    n = len(weights)
    prefix = [0]
    for w in weights:
        prefix.append(prefix[-1] + w)

    def span_w(i: int, j: int) -> int:
        return prefix[j] - prefix[i]

    cross = [[0] * (n + 1) for _ in range(n + 1)]
    for i in range(n):
        for j in range(i + 1, n + 1):
            cross[i][j] = sum(b for a, z, b in spans if i <= a < j <= z)

    INF = (float("inf"), float("inf"))
    best = [[INF] * (n + 1) for _ in range(cores + 1)]
    cut = [[0] * (n + 1) for _ in range(cores + 1)]
    best[0][0] = (0, 0)
    for c in range(1, cores + 1):
        for j in range(c, n + 1):
            for i in range(c - 1, j):
                if best[c - 1][i] == INF or span_w(i, j) > bottleneck_cap:
                    continue
                cand = (best[c - 1][i][0] + cross[i][j],
                        max(best[c - 1][i][1], span_w(i, j)))
                if cand < best[c][j]:
                    best[c][j] = cand
                    cut[c][j] = i
    assert best[cores][n] != INF, "bottleneck_cap below the flops optimum"
    groups = [0] * n
    j = n
    for c in range(cores, 0, -1):
        i = cut[c][j]
        for u in range(i, j):
            groups[u] = c - 1
        j = i
    return groups


def _check_objective(objective: str) -> None:
    if objective not in CUT_OBJECTIVES:
        raise ValueError(
            f"partition cut objective must be one of {CUT_OBJECTIVES}, "
            f"got {objective!r}")


def default_assignment(network: Network, cores: int,
                       layout: Optional[MegakernelLayout] = None,
                       objective: str = "crossing",
                       profile: Optional[Mapping[str, Mapping[str, int]]]
                       = None) -> dict:
    """Default actor -> core map: a contiguous cut of the visit order with
    window-uncovered delay-channel endpoints glued into one unit.

    ``"flops"`` balances ``cost_flops`` (floor 1 per actor);
    ``"crossing"`` (needs ``layout``, else it is the flops cut) picks,
    within the balance slack, the cut with the fewest crossing ring bytes;
    ``"profile"`` is the crossing cut over measured weights,
    ``profile={"actors": {...}, "channels": {...}}``
    (``Profile.as_cut_weights()``): per-actor load and per-channel churn
    bytes.
    """
    _check_objective(objective)
    if objective == "profile" and profile is None:
        raise ValueError(
            "cut_objective='profile' needs measured weights: run once "
            "with ExecutionPlan(trace=True), then pass "
            "RunResult.trace.profile().as_cut_weights()")
    names = list(network.actors)
    units = _glued_units(network)
    if cores > len(units):
        raise ValueError(
            f"cores={cores} exceeds the {len(units)} partition units of "
            f"this network ({len(names)} actors after gluing delay-channel "
            "endpoints); pass fewer cores or an explicit assign= that "
            "leaves no core empty")
    if objective == "profile":
        actor_w = dict(profile.get("actors", {}))
        weights = [sum(max(1, int(actor_w.get(names[i], 1))) for i in u)
                   for u in units]
    else:
        weights = [sum(max(1, int(network.actors[names[i]].cost_flops))
                       for i in u) for u in units]
    groups, bottleneck = _balanced_cut(weights, cores)
    if (objective == "profile" or
            (objective == "crossing" and layout is not None)) and cores > 1:
        unit_of = {}
        for ui, unit in enumerate(units):
            for i in unit:
                unit_of[i] = ui
        idx = {n: i for i, n in enumerate(names)}
        chan_w = (dict(profile.get("channels", {}))
                  if objective == "profile" else None)
        spans = []
        for fname in network.fifos:
            if objective == "crossing" and fname not in layout.fifo_names:
                continue
            e = network.edge_of(fname)
            a, b = unit_of[idx[e.src_actor]], unit_of[idx[e.dst_actor]]
            if a != b:
                spans.append((min(a, b), max(a, b),
                              max(0, int(chan_w.get(fname, 0)))
                              if chan_w is not None
                              else network.fifos[fname].capacity_bytes))
        cap = max(bottleneck, int(bottleneck * _CUT_BALANCE_SLACK))
        groups = _crossing_cut(weights, spans, cores, cap)
    out = {}
    for ui, unit in enumerate(units):
        for i in unit:
            out[names[i]] = groups[ui]
    return out


def partition_layout(network: Network, layout: MegakernelLayout,
                     cores: int = 1,
                     assign: Optional[Mapping[str, int]] = None,
                     objective: str = "crossing",
                     forward_transients: bool = True,
                     profile: Optional[Mapping[str, Mapping[str, int]]]
                     = None) -> GridPartition:
    """Partition the firing table across ``cores`` grid partitions.

    ``assign`` (actor -> core) overrides the default cut and must pass
    ``Network.validate_partition``; the partition then records
    ``objective="assign"``.  ``profile`` carries the measured weights of
    the ``"profile"`` objective.  With ``forward_transients`` the
    core-private subset of ``layout.transient_fifos`` is forwarded.
    """
    if cores < 1:
        raise ValueError(f"cores must be >= 1, got {cores}")
    _check_objective(objective)
    if assign is None:
        assign = default_assignment(network, cores, layout=layout,
                                    objective=objective, profile=profile)
    else:
        objective = "assign"
    network.validate_partition(assign, cores)
    names = list(network.actors)
    assignment = tuple(int(assign[n]) for n in names)
    core_rows = tuple(
        tuple(i for i, n in enumerate(names) if assignment[i] == core)
        for core in range(cores))
    fifo_cores = []
    for fname in layout.fifo_names:
        e = network.edge_of(fname)
        src = assignment[names.index(e.src_actor)]
        dst = assignment[names.index(e.dst_actor)]
        fifo_cores.append(src if src == dst else SHARED)
    forwarded = ()
    if forward_transients:
        forwarded = tuple(
            i for i, fname in enumerate(layout.fifo_names)
            if fname in layout.transient_fifos and fifo_cores[i] != SHARED)
        delayed = [layout.fifo_names[i] for i in forwarded
                   if layout.fifo_specs[i].delay]
        if delayed:
            raise ValueError(
                f"transient channels {delayed} carry delay tokens; "
                "register_fifos must never admit delayed channels "
                "(forwarding has no Fig. 2 copy-back)")
    return GridPartition(n_cores=cores, assignment=assignment,
                         core_rows=core_rows,
                         fifo_cores=tuple(fifo_cores),
                         forwarded_fifos=forwarded,
                         objective=objective)


def entry_staging_bytes(layout: MegakernelLayout,
                        partition: Optional[GridPartition] = None) -> int:
    """Ring + cursor bytes staged on every kernel entry (forwarded
    transients excluded under ``partition``)."""
    if partition is not None:
        return partition.scratch_bytes(layout)
    return layout.scratch_bytes


def state_hbm_bytes(state: Any) -> int:
    """Bytes of a :class:`NetworkState` as the kernel's operands: every
    tensor leaf, and every host-int leaf (cursors, indices) as the int32
    it is on the device."""
    total = 0
    for leaf in state.leaves():
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += 4
    return total
