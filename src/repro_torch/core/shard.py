"""Multi-device sharded actor networks — the paper's multi-processor
mapping (§3.3: one network split across processors joined by FIFO
channels) on a ``torch.distributed`` process group.

The reference runs one process over a 1-D JAX mesh (``shard_map``); the
port takes PyTorch's SPMD idiom instead: one process per device, rank
``r`` of the group being device ``r``.  Every rank builds the same
network (on ``cuda:(rank % device_count)`` on the card, or the device the
caller names) and runs the same :class:`~repro_torch.core.program.Program`;
``ExecutionPlan(devices=k)`` reuses the megakernel grid's partition
machinery (``partition_layout`` with ``cores=k``: the crossing-bytes cut,
delay-channel endpoints glued, crossing channels classified ``SHARED``)
and synchronises by messages:

* every rank holds a full replica of the :class:`NetworkState` but sweeps
  ONLY its partition's actors, in the partition's visit order, with the
  single-device executor's visit body
  (:func:`repro_torch.core.executor.visit_actors`);
* at each sweep barrier every SHARED crossing channel sends its ring and
  write cursor producer -> consumer and its read cursor consumer ->
  producer (point-to-point, all of a round's transfers posted together in
  one order on every rank, so two channels flowing opposite ways between
  one pair of ranks cannot deadlock), then every replica recomputes the
  channel's occupancy from the invariant ``occ = delay + (wr - rd) *
  rate``;
* quiescence is an ``all_reduce`` (SUM) of the ranks' fired flags, once a
  round; ``sweeps`` counts these barrier rounds.

Correctness rests on the reference's two properties.  *Conservative
staleness*: between barriers a producer sees a low read cursor (its
occupancy view is >= the truth, so it never overflows) and a consumer a
low write cursor (<= the truth, so it never underflows).  *Kahn
determinism*: blocking reads and one writer per channel make the
quiescent state independent of the firing order, so states, rings,
cursors and fire counts equal the single-device dynamic executor's bit
for bit at every device count; only the round count differs.  After a
barrier every rank's view of what it reads is the true state, so a round
is a function of the true state: a run cut at round boundaries
(``run_checkpointed``) resumes to the same rounds.

On exit each leaf is taken whole from its static owner (an actor's from
its device, a private channel's from its device, a crossing channel's
from its producer) by one object broadcast and one byte broadcast per
rank; fire counts are summed, fault words OR-ed, high-water marks maxed
and trace rings gathered, so every rank returns the same replicated
result.  Delay channels with ``delay < rate`` may not cross devices
(``Network.validate_partition(..., unit="device")``): their Fig. 2
copy-back runs on the producer, whose ring is what the barrier ships.

Transfers: a gloo group moves CPU tensors only, so rings and flags on
the card are staged through host buffers (each rank's bodies still run
their kernels on the card); under NCCL the CUDA tensors go directly.
Gloo is the backend the tests and the one-card chip run exercise; k ranks
then share one card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import (DynamicResult, RuntimeMode,
                                       assert_mode_allows, visit_actors)
from repro_torch.core.health import HealthState, init_health
from repro_torch.core.megakernel.lower import (_CURSOR_ITEMSIZE, GridPartition,
                                               MegakernelLayout, lower_network,
                                               partition_layout)
from repro_torch.core.network import Network, NetworkState, tree_map
from repro_torch.core.trace import (Trace, TraceState, decode_trace, init_trace,
                                    merge_device_traces)

#: The name of the 1-D device axis (the reference's mesh axis).
AXIS = "dev"

#: Byte alignment of each leaf in a merge buffer (any dtype views cleanly).
_ALIGN = 16


def build_device_partition(network: Network, devices: int,
                           device_assign: Optional[Mapping[str, int]] = None,
                           cut_objective: str = "crossing",
                           profile: Optional[Mapping[str, Any]] = None
                           ) -> Tuple[MegakernelLayout, GridPartition]:
    """Partition the firing table across ``devices`` ranks: the grid's
    ``lower_network`` and ``partition_layout`` with ``cores=devices``.
    ``forward_transients`` stays off: forwarding is a megakernel lowering,
    while each rank runs the host dynamic executor over real rings."""
    layout = lower_network(network)
    part = partition_layout(network, layout, cores=devices,
                            assign=(dict(device_assign)
                                    if device_assign is not None else None),
                            objective=cut_objective, forward_transients=False,
                            profile=profile)
    return layout, part


def collective_bytes_per_sweep(layout: MegakernelLayout,
                               partition: GridPartition) -> int:
    """Bytes one barrier round moves: per crossing channel its Eq. 1 ring
    (producer -> consumer) and the rd/wr cursor pair (one int each way),
    plus the 4-byte fired flag every round all-reduces (the reference's
    count; the port ships cursors as int64)."""
    total = _CURSOR_ITEMSIZE
    for fi in partition.shared_fifos:
        total += layout.fifo_specs[fi].capacity_bytes + 2 * _CURSOR_ITEMSIZE
    return total


def _crossing_edges(network: Network, layout: MegakernelLayout,
                    partition: GridPartition) -> List[Tuple[int, int, int]]:
    """``(fifo_index, producer_device, consumer_device)`` per SHARED
    channel, in layout order."""
    names = list(network.actors)
    out = []
    for fi in partition.shared_fifos:
        e = network.edge_of(layout.fifo_names[fi])
        out.append((fi, partition.assignment[names.index(e.src_actor)],
                    partition.assignment[names.index(e.dst_actor)]))
    return out


def check_group(devices: int, what: str = "ExecutionPlan") -> Tuple[int, Any]:
    """``(rank, group)`` of the default process group, which must join
    exactly ``devices`` ranks; raises ``RuntimeError`` naming how to start
    one otherwise."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what}(devices={devices}): no torch.distributed process group "
            f"is initialised; start {devices} processes (torchrun "
            f"--nproc-per-node {devices}, or repro_torch.launch.group."
            "spawn_group) that each call torch.distributed."
            "init_process_group('gloo', ...) before compiling")
    world = dist.get_world_size()
    if world != devices:
        raise RuntimeError(
            f"{what}(devices={devices}): the process group has {world} "
            f"rank(s); a sharded plan runs one rank per device, so start "
            f"exactly {devices} (torch.distributed.init_process_group with "
            f"world_size={devices})")
    return dist.get_rank(), dist.group.WORLD


# --------------------------------------------------------------------------- #
# Transfers.
# --------------------------------------------------------------------------- #
class _Wire:
    """Where a group's messages live: host buffers under gloo (CPU tensors
    only), the rank's card under NCCL."""

    def __init__(self, group: Any) -> None:
        import torch.distributed as dist
        self.dist = dist
        self.group = group
        if dist.get_backend(group) == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")

    def bytes_of(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s bytes as a flat uint8 tensor on the wire's device."""
        return t.detach().contiguous().reshape(-1).view(torch.uint8).to(self.device)

    def ints(self, values: List[int]) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int64, device=self.device)

    def broadcast_object(self, obj: Any, src: int) -> Any:
        box = [obj]
        self.dist.broadcast_object_list(box, src=src, group=self.group,
                                        device=self.device)
        return box[0]


def _tensor_from(flat: torch.Tensor, off: int, nbytes: int, dtype: torch.dtype,
                 shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return flat[off:off + nbytes].view(dtype).reshape(shape).to(device, copy=True)


@dataclasses.dataclass(frozen=True)
class _Slot:
    """A tensor leaf's place in a merge buffer."""

    offset: int
    nbytes: int
    dtype: torch.dtype
    shape: Tuple[int, ...]


class _Packer:
    """Collects tensors into one aligned uint8 buffer on the wire."""

    def __init__(self, wire: _Wire) -> None:
        self.wire = wire
        self.parts: List[torch.Tensor] = []
        self.size = 0

    def add(self, t: torch.Tensor) -> _Slot:
        b = self.wire.bytes_of(t)
        slot = _Slot(self.size, int(b.numel()), t.dtype, tuple(t.shape))
        pad = -int(b.numel()) % _ALIGN
        self.parts.append(b)
        if pad:
            self.parts.append(torch.zeros(pad, dtype=torch.uint8, device=self.wire.device))
        self.size += int(b.numel()) + pad
        return slot

    def buffer(self) -> torch.Tensor:
        if not self.parts:
            return torch.empty(0, dtype=torch.uint8, device=self.wire.device)
        return torch.cat(self.parts)


# --------------------------------------------------------------------------- #
# The sharded executor.
# --------------------------------------------------------------------------- #
def compile_sharded(network: Network, layout: MegakernelLayout,
                    partition: GridPartition, max_sweeps: int = 1_000_000,
                    mode: RuntimeMode = RuntimeMode.PROPOSED,
                    multi_firing: bool = True, guards: bool = False,
                    trace_capacity: Optional[int] = None):
    """The sharded dynamic executor of this rank.

    Returns ``run(state) -> DynamicResult``, :func:`run_dynamic`'s record
    ``(state, counts, sweeps, stalled)`` with ``.health`` (fault words
    OR-ed and high-water marks maxed across ranks) and ``.trace`` (the
    gathered ``(rings (k, cap, 3+F), counts (k,))`` pair for
    :func:`decode_device_trace`), ``sweeps`` counting barrier rounds.  The
    state is updated in place and, on return, replicated: equal on every
    rank.  Every rank calls it with its replica of the same state.

    As in the reference, a traced event's occupancy sample is the
    recording rank's local view, and a guarded run's high-water marks may
    exceed the single-device run's (a producer's view is an upper bound);
    both observe and schedule nothing.

    ``run.last_split`` holds the last run's host seconds on this rank by
    part: ``visit`` (the sweeps, kernel launches included), ``exchange``
    (the barrier transfers, which wait for the device under gloo),
    ``flag`` (the quiescence all-reduce, where a rank waits for the
    slowest) and ``merge``.
    """
    assert_mode_allows(network, mode)
    k = partition.n_cores
    rank, group = check_group(k)
    wire = _Wire(group)
    dist = wire.dist
    names = list(network.actors)
    n_fifos = len(network.fifos)
    crossing = _crossing_edges(network, layout, partition)
    mine = [names[i] for i in partition.core_rows[rank]]
    # Static merge owners: crossing channels merge from their producer,
    # whose rd the exit barrier synchronised and whose ring and wr are the
    # single writer's truth.
    fifo_owner = list(partition.fifo_cores)
    for fi, src, _ in crossing:
        fifo_owner[fi] = src

    def exchange(state: NetworkState) -> None:
        ops, apply = [], []
        for j, (fi, src, dst) in enumerate(crossing):
            fs = state.fifos[fi]
            if rank == src:
                rd = wire.ints([0])
                ops += [dist.P2POp(dist.isend, wire.bytes_of(fs.buf), dst, group, 3 * j),
                        dist.P2POp(dist.isend, wire.ints([fs.wr]), dst, group, 3 * j + 1),
                        dist.P2POp(dist.irecv, rd, dst, group, 3 * j + 2)]
                apply.append((fi, None, None, rd))
            elif rank == dst:
                ring = torch.empty(fs.buf.numel() * fs.buf.element_size(),
                                   dtype=torch.uint8, device=wire.device)
                wr = wire.ints([0])
                ops += [dist.P2POp(dist.irecv, ring, src, group, 3 * j),
                        dist.P2POp(dist.irecv, wr, src, group, 3 * j + 1),
                        dist.P2POp(dist.isend, wire.ints([fs.rd]), src, group, 3 * j + 2)]
                apply.append((fi, ring, wr, None))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for fi, ring, wr, rd in apply:
            fs = state.fifos[fi]
            if ring is not None:
                fs.buf.copy_(ring.view(fs.buf.dtype).reshape(fs.buf.shape))
                fs.wr = int(wr.item())
            else:
                fs.rd = int(rd.item())
        for fi, _, _ in crossing:
            spec, fs = layout.fifo_specs[fi], state.fifos[fi]
            fs.occ = spec.delay + (fs.wr - fs.rd) * spec.rate

    def merge(state: NetworkState, counts: Dict[str, int],
              health: Optional[HealthState], trace: Optional[TraceState]):
        all_counts: Dict[str, int] = {}
        faults, highs, rings, ring_counts = [], [], [], []
        for d in range(k):
            meta, flat = None, None
            if rank == d:
                pack = _Packer(wire)
                meta = {"fifos": {}, "actors": {}, "counts": {}}
                for fi in range(n_fifos):
                    if fifo_owner[fi] == d:
                        fs = state.fifos[fi]
                        meta["fifos"][fi] = (pack.add(fs.buf), fs.rd, fs.wr, fs.occ)
                for i in partition.core_rows[d]:
                    meta["actors"][i] = tree_map(
                        lambda x: pack.add(x) if isinstance(x, torch.Tensor) else x,
                        state.actors[i])
                    meta["counts"][names[i]] = counts[names[i]]
                if health is not None:
                    meta["health"] = ([int(w) for w in health.fault_words()],
                                      list(health.high_water))
                if trace is not None:
                    meta["trace"] = (np.asarray(trace.ring), int(trace.count))
                flat = pack.buffer()
                meta["nbytes"] = int(flat.numel())
            meta = wire.broadcast_object(meta, d)
            if meta["nbytes"]:
                if flat is None:
                    flat = torch.empty(meta["nbytes"], dtype=torch.uint8,
                                       device=wire.device)
                dist.broadcast(flat, src=d, group=group)
            if rank != d:
                for fi, (slot, rd, wr, occ) in meta["fifos"].items():
                    fs = state.fifos[fi]
                    fs.buf.copy_(flat[slot.offset:slot.offset + slot.nbytes]
                                 .view(slot.dtype).reshape(slot.shape))
                    fs.rd, fs.wr, fs.occ = rd, wr, occ
                dev = network.device
                for i, skel in meta["actors"].items():
                    state.actors[i] = tree_map(
                        lambda x: (_tensor_from(flat, x.offset, x.nbytes, x.dtype,
                                                x.shape, dev)
                                   if isinstance(x, _Slot) else x), skel)
            all_counts.update(meta["counts"])
            if "health" in meta:
                faults.append(meta["health"][0])
                highs.append(meta["health"][1])
            if "trace" in meta:
                rings.append(meta["trace"][0])
                ring_counts.append(meta["trace"][1])
        merged_health = None
        if health is not None:
            fault = [0] * n_fifos
            for words in faults:
                fault = [a | b for a, b in zip(fault, words)]
            merged_health = HealthState(n_fifos, fault=fault,
                                        high_water=np.max(highs, axis=0).tolist())
        merged_trace = None
        if trace is not None:
            merged_trace = (np.stack(rings), np.asarray(ring_counts, np.int64))
        return {nm: all_counts[nm] for nm in names}, merged_health, merged_trace

    def run(state: NetworkState) -> DynamicResult:
        if not isinstance(state, NetworkState):
            state = network.state_from_dict(state)
        counts = {nm: 0 for nm in names}
        health = init_health(n_fifos, network.device) if guards else None
        trace = init_trace(n_fifos, trace_capacity) if trace_capacity else None
        split = dict.fromkeys(("visit", "exchange", "flag", "merge"), 0.0)
        sweeps = 0
        fired_any = True
        while fired_any and sweeps < max_sweeps:
            t0 = time.perf_counter()
            fired = visit_actors(network, mine, state, counts, sweeps,
                                 multi_firing, health, trace)
            # The barrier and the flag are issued every round on every
            # rank, whatever the rank fired.
            t1 = time.perf_counter()
            exchange(state)
            t2 = time.perf_counter()
            flag = torch.tensor([int(fired)], dtype=torch.int32, device=wire.device)
            dist.all_reduce(flag, group=group)
            fired_any = int(flag.item()) > 0
            t3 = time.perf_counter()
            split["visit"] += t1 - t0
            split["exchange"] += t2 - t1
            split["flag"] += t3 - t2
            sweeps += 1
        stalled = fired_any and sweeps >= max_sweeps
        t0 = time.perf_counter()
        counts, health, trace = merge(state, counts, health, trace)
        split["merge"] = time.perf_counter() - t0
        run.last_split = split
        return DynamicResult(state, counts, sweeps, stalled, health, trace)

    run.last_split = None
    return run


def decode_device_trace(network: Network, trc: Optional[Tuple],
                        partition: GridPartition,
                        wall_time_s: Optional[float] = None) -> Optional[Trace]:
    """Decode a sharded run's gathered ``(rings (k, cap, 3+F), counts
    (k,))`` into ONE :class:`~repro_torch.core.trace.Trace`: each rank's
    ring decoded alone, then interleaved by barrier round (stable by
    rank), ``actor_cores`` recording each actor's device."""
    if trc is None:
        return None
    rings, counts = trc
    names = tuple(network.actors)
    devmap = {names[i]: d for d, rows in enumerate(partition.core_rows) for i in rows}
    per_dev = [
        decode_trace(network, TraceState(ring=rings[d], count=int(counts[d])),
                     wall_time_s=wall_time_s if d == 0 else None,
                     actor_cores=devmap)
        for d in range(partition.n_cores)]
    return merge_device_traces(per_dev)
