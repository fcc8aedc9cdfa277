"""Actor-to-device mapping — paper §3.3.

The paper maps each actor to a GPP core or to the OpenCL device.  Here:

* :func:`heterogeneous_split` cuts a network into its host-resident part
  (sources and sinks doing I/O) and the accelerated part, which becomes a
  network of its own.  Each boundary channel becomes a feed actor (a
  source serving pre-staged windows) or a fetch actor (a sink storing
  them), so Eq. 1 window semantics hold across the cut and every executor
  runs the result.  Feed and fetch declare B2's ``"source"`` and
  ``"sink"`` device functions on a window-major slab ``(n_iterations, r,
  *token_shape)`` (one plane: window ``idx`` is the contiguous run at
  ``idx * r * token_size``), so the megakernel runs them too.
* :class:`Placement` pins an actor to a mesh axis slice in the reference;
  the port has one device, and placement on a mesh is ROADMAP A12.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core.actor import ActorSpec, DeviceOp, static_actor
from repro_torch.core.fifo import FifoSpec
from repro_torch.core.network import Edge, Network, NetworkState


@dataclasses.dataclass(frozen=True)
class Placement:
    """Actor placement: mesh axis name + index (None = free mapping).  A
    record only: the port runs no mesh yet (ROADMAP A12)."""

    axis: Optional[str] = None
    index: Optional[int] = None


def partition_actors(network: Network, accelerated: List[str]
                     ) -> Tuple[List[str], List[str]]:
    """Split actor names into (host, accelerated) sets, validating coverage."""
    accel = set(accelerated)
    unknown = accel - set(network.actors)
    if unknown:
        raise ValueError(f"unknown actors in accelerated set: {sorted(unknown)}")
    host = [n for n in network.actors if n not in accel]
    return host, list(accelerated)


def boundary_fifos(network: Network, accelerated: List[str]
                   ) -> Tuple[List[str], List[str]]:
    """(into_accel, out_of_accel): the channels crossing the host/accelerator
    boundary, whose windows the feed and fetch actors carry."""
    accel = set(accelerated)
    into, out = [], []
    for e in network.edges:
        src_in = e.src_actor in accel
        dst_in = e.dst_actor in accel
        if not src_in and dst_in:
            into.append(e.fifo)
        elif src_in and not dst_in:
            out.append(e.fifo)
    return into, out


def _slab(n_iterations: int, spec: FifoSpec, device: torch.device) -> torch.Tensor:
    return torch.zeros((n_iterations, spec.rate) + tuple(spec.token_shape),
                       dtype=spec.dtype, device=device)


def heterogeneous_split(network: Network, accelerated: List[str],
                        n_iterations: int) -> Tuple[Network, List[str], List[str]]:
    """The accelerated subnetwork with boundary feed and fetch actors.

    Each inbound boundary channel gets ``__feed_<fifo>``, a source whose
    state ``(slab, idx)`` holds ``(n_iterations, r, *token_shape)`` staged
    windows and which serves window ``idx`` while ``idx < n_iterations``;
    each outbound one gets ``__fetch_<fifo>``, a sink storing window ``idx``
    into its slab (its ``finish`` returns the slab).  The result is a plain
    :class:`Network` on the source network's device.  Returns ``(sub,
    feed actor names, fetch actor names)``.
    """
    accel = set(accelerated)
    into, out = boundary_fifos(network, accelerated)
    dev = network.device

    actors: List[ActorSpec] = [network.actors[n] for n in accelerated]
    fifos: List[FifoSpec] = []
    edges: List[Edge] = []
    initial = {}
    for e in network.edges:
        if e.src_actor in accel and e.dst_actor in accel:
            fifos.append(network.fifos[e.fifo])
            edges.append(e)
            if e.fifo in network.initial_tokens:
                initial[e.fifo] = network.initial_tokens[e.fifo]

    def make_feed(fifo_name: str) -> Tuple[ActorSpec, FifoSpec, Edge]:
        spec = network.fifos[fifo_name]
        e = network.edge_of(fifo_name)

        def fire(state, inputs, rates):
            data, idx = state
            return (data, idx + 1), {"out": data[idx]}

        feed = static_actor(
            f"__feed_{fifo_name}", (), ("out",), fire,
            init=lambda: (_slab(n_iterations, spec, dev), 0),
            ready=lambda st: st[1] < n_iterations,
            device_op=DeviceOp("source", {"n_firings": n_iterations, "planes": 1}))
        return feed, spec, Edge(fifo_name, feed.name, "out", e.dst_actor, e.dst_port)

    def make_fetch(fifo_name: str) -> Tuple[ActorSpec, FifoSpec, Edge]:
        spec = network.fifos[fifo_name]
        e = network.edge_of(fifo_name)

        def fire(state, inputs, rates):
            data, idx = state
            data[idx] = inputs["in"]
            return (data, idx + 1), {}

        fetch = static_actor(
            f"__fetch_{fifo_name}", ("in",), (), fire,
            init=lambda: (_slab(n_iterations, spec, dev), 0),
            finish=lambda st: st[0],
            device_op=DeviceOp("sink", {"planes": 1}))
        return fetch, spec, Edge(fifo_name, e.src_actor, e.src_port, fetch.name, "in")

    feed_names, fetch_names = [], []
    for f in into:
        a, spec, edge = make_feed(f)
        actors.append(a)
        fifos.append(spec)
        edges.append(edge)
        if f in network.initial_tokens:
            initial[f] = network.initial_tokens[f]
        feed_names.append(a.name)
    for f in out:
        a, spec, edge = make_fetch(f)
        actors.append(a)
        fifos.append(spec)
        edges.append(edge)
        fetch_names.append(a.name)

    sub = Network(actors, fifos, edges, initial_tokens=initial, device=dev)
    return sub, feed_names, fetch_names


def stage_feed(state: Any, feed_actor: str, data: Any) -> Any:
    """A state with ``data`` (windows ``(n, r, *token_shape)``) staged in
    ``feed_actor``'s slab, its index kept.  ``state`` is left as it was: the
    result shares every other leaf with it.  Legacy ``{"fifos": ...,
    "actors": ...}`` dict states are staged in kind."""
    if not isinstance(state, NetworkState):
        st = dict(state)
        actors = dict(st["actors"])
        _, cursor = actors[feed_actor]
        actors[feed_actor] = (torch.as_tensor(data), cursor)
        st["actors"] = actors
        return st
    idx = state.actor_names.index(feed_actor)
    slab, cursor = state.actors[idx]
    actors = list(state.actors)
    actors[idx] = (torch.as_tensor(data).to(slab.device), cursor)
    return NetworkState(list(state.fifos), actors, state.fifo_names, state.actor_names)
