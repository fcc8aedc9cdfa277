"""LM blocks as pipeline stages — the paper's actor-to-processor mapping
applied to a language model.

A *stage* is a run of the model's layer groups and becomes one static
actor; microbatch activations flow source -> stage0 -> ... -> sink over
rate-1 channels whose tokens are whole ``(S, D)`` activation windows
(Eq. 1's double buffer is the send/receive pair of a mesh pipeline).  The
network runs under any :class:`~repro_torch.core.program.ExecutionPlan`
of the host executors, including ``accelerated=[stages...]`` with
:meth:`Program.stream`; each stage fires on one microbatch at batch 1, so
it launches the kernels :func:`pipeline_forward_reference` launches, at
the same shapes (B6 once a layer for mamba2).

:func:`pipeline_forward` runs the same stages one per rank of a mesh
dimension through :func:`~repro_torch.core.pipeline.pipeline_spmd`, the
embedding and the unembedding replicated on every rank.

In megakernel mode the source and the sink are kernel B2's ``"source"``
and ``"sink"`` bodies (a window of the staged ``(n_micro, S, D)`` slab
each), and each stage is a ``"step"``: B2 stops at each stage firing and
the runner calls the stage's ``fire`` on the card between launches, one
launch a stage firing plus one.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import DeviceOp, NetworkBuilder, static_actor
from repro_torch.core.network import Network
from repro_torch.core.pipeline import pipeline_reference, pipeline_spmd
from repro_torch.models.lm import LM, layer_plan


def stack_stage_params(model: LM, cfg: ArchConfig, n_stages: int) -> List[List[Any]]:
    """The model's layer groups cut into ``n_stages`` pipeline stages: one
    list of layers (``Block`` modules, in order) per stage.  The plan must
    have no remainder and its groups must divide by ``n_stages``, as in the
    reference."""
    cycle, n_groups, rest = layer_plan(cfg)
    if rest:
        raise ValueError("pipeline stages need rest-free layer plans")
    if n_groups % n_stages:
        raise ValueError(f"{n_groups} groups not divisible into {n_stages} stages")
    per = (n_groups // n_stages) * len(cycle)
    layers = list(model.layers)
    return [layers[s * per:(s + 1) * per] for s in range(n_stages)]


def make_stage_fn(model: LM) -> Callable[[List[Any], torch.Tensor], torch.Tensor]:
    """``(stage layers, x (S, D)) -> x``: the stage's blocks in training
    mode (no caches) at batch 1."""

    def stage_fn(stage_layers: List[Any], x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            x = x[None]
            for blk in stage_layers:
                x, _, _ = model._block(blk, x, mode="train")
            return x[0]

    return stage_fn


def pipeline_forward(model: LM, cfg: ArchConfig, tokens: torch.Tensor, mesh: Any,
                     n_stages: int, axis: str = "stage") -> torch.Tensor:
    """Logits ``(n_micro, S, V)`` with the block stack as pipeline stages,
    one per rank of ``mesh``'s dimension ``axis`` (its size must be
    ``n_stages``).

    ``tokens`` is ``(n_micro, S)``, one sequence per microbatch, the same
    on every rank; each rank holds the whole model and runs its stage's
    layers on its own device.  The embedding and the unembedding (the
    network's source and sink) run replicated on every rank, and every
    rank returns the logits.
    """
    x = _embedded(model, tokens)
    y = pipeline_spmd(make_stage_fn(model), stack_stage_params(model, cfg, n_stages),
                      x, mesh, axis=axis)
    with torch.no_grad():
        return model._logits(y)


def _embedded(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return model._embed(torch.as_tensor(tokens).to(model.device))


def build_lm_stage_network(model: LM, cfg: ArchConfig, tokens: torch.Tensor,
                           n_stages: int) -> Network:
    """The pipeline as an actor network on the model's device.

    ``tokens`` is ``(n_micro, S)``, one sequence per microbatch; their
    embeddings are staged in the source at build time and the sink
    collects the last stage's ``(n_micro, S, D)`` activations (its
    ``finish`` returns them); :func:`lm_stage_network_forward` applies the
    final norm and the unembedding.
    """
    x = _embedded(model, tokens)
    stages = stack_stage_params(model, cfg, n_stages)
    stage_fn = make_stage_fn(model)
    n_micro, S, D = x.shape

    def src_fire(state, inputs, rates):
        data, idx = state
        return (data, idx + 1), {"out": data[idx][None]}

    source = static_actor("source", (), ("out",), src_fire,
                          init=lambda: (x, 0), ready=lambda st: st[1] < n_micro,
                          device_op=DeviceOp("source", dict(n_firings=n_micro, planes=1)))

    def sink_fire(state, inputs, rates):
        data, idx = state
        data[idx] = inputs["in"][0]
        return (data, idx + 1), {}

    sink = static_actor("sink", ("in",), (), sink_fire,
                        init=lambda: (torch.zeros((n_micro, S, D), dtype=x.dtype,
                                                  device=x.device), 0),
                        finish=lambda st: st[0],
                        device_op=DeviceOp("sink", dict(planes=1)))

    b = NetworkBuilder()
    b.actor(source)
    prev = "source.out"
    for s, layers in enumerate(stages):
        n_params = sum(p.numel() for blk in layers for p in blk.parameters())

        def fire(state, inputs, rates, layers=layers):
            return state, {"out": stage_fn(layers, inputs["in"][0])[None]}

        b.actor(static_actor(f"stage{s}", ("in",), ("out",), fire,
                             cost_flops=2 * S * n_params, device_op=DeviceOp("step")))
        b.connect(prev, f"stage{s}.in", token_shape=(S, D), dtype=x.dtype,
                  name=f"f_s{s}")
        prev = f"stage{s}.out"
    b.actor(sink)
    b.connect(prev, "sink.in", token_shape=(S, D), dtype=x.dtype, name="f_out")
    return b.build(device=model.device)


def lm_stage_network_forward(model: LM, cfg: ArchConfig, tokens: torch.Tensor,
                             n_stages: int, plan: Optional[Any] = None) -> torch.Tensor:
    """Logits ``(n_micro, S, V)`` through the stage actor network, run under
    ``plan`` (default: the static schedule over the microbatches)."""
    net = build_lm_stage_network(model, cfg, tokens, n_stages)
    n_micro = int(tokens.shape[0])
    if plan is None:
        prog = net.compile(mode="static", n_iterations=n_micro)
    else:
        if plan.accelerated is not None:
            # A feed actor would stream zeros into the stages; streaming
            # callers drive build_lm_stage_network(...).compile(plan).stream.
            raise ValueError(
                "lm_stage_network_forward: plans with accelerated=[...] "
                "need explicit feeds; use build_lm_stage_network(...)"
                ".compile(plan).stream(...) instead")
        prog = net.compile(plan, n_iterations=n_micro)
    y = prog.collect("sink", prog.run().state)
    with torch.no_grad():
        return model._logits(y)


def pipeline_forward_reference(model: LM, cfg: ArchConfig, tokens: torch.Tensor,
                               n_stages: int) -> torch.Tensor:
    """Oracle: the same stages run in order on each microbatch, no mesh and
    no network."""
    x = _embedded(model, tokens)
    y = pipeline_reference(make_stage_fn(model), stack_stage_params(model, cfg, n_stages), x)
    with torch.no_grad():
        return model._logits(y)
