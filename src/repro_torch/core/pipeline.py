"""Pipelines of actor stages — the reference's ``core/pipeline.py``.

The paper's runtime streams tokens between processors through Eq. 1
double buffers; across devices the same structure is the double-buffered
microbatch pipeline.  :func:`pipeline_spmd` runs the GPipe schedule (B
microbatches over S stages in B + S - 1 ticks) with one stage per rank of
a ``DeviceMesh`` dimension: each rank owns one stage, the stage-to-stage
channel is a point-to-point send and receive (the send buffer and the next
tick's receive are the ``2r`` double buffer), and the last stage's outputs
reach every rank by a broadcast.  :func:`pipeline_reference` runs the
stages one after another on one device: the oracle that
:func:`pipeline_spmd` and the stage actor network
(``graphs/lm_pipeline.py``) are held to.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.network import tree_map


def stage_slice(stage_params: Any, s: int) -> Any:
    """Stage ``s``'s parameters: entry ``s`` of a list (one entry per
    stage, as the port's LM stages), else slice ``s`` of every leaf of a
    stacked tree (a tensor, dict or tuple with a leading stage axis, as the
    reference's)."""
    if isinstance(stage_params, list):
        return stage_params[s]
    return tree_map(lambda leaf: leaf[s], stage_params)


def _n_stages(stage_params: Any) -> int:
    if isinstance(stage_params, list):
        return len(stage_params)
    leaf = stage_params
    while isinstance(leaf, (tuple, list, dict)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return int(leaf.shape[0])


def pipeline_spmd(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any, microbatches: torch.Tensor, mesh: Any,
                  axis: str = "stage") -> torch.Tensor:
    """Run ``microbatches`` through a pipeline of same-signature stages,
    one stage per rank of ``mesh``'s dimension ``axis``.

    Args:
      stage_fn: ``(params_of_stage, x) -> y`` with ``y.shape == x.shape``.
      stage_params: one entry per stage (see :func:`stage_slice`); rank
        ``s`` of the dimension runs stage ``s``.
      microbatches: ``(n_micro, *x_shape)``, the same on every rank, on the
        device the rank computes on.
      mesh: a ``torch.distributed.device_mesh.DeviceMesh`` with a dimension
        named ``axis`` of size n_stages, e.g. ``init_device_mesh("cpu",
        (4,), mesh_dim_names=("stage",))``; every rank of that dimension
        calls this function.
      axis: the mesh dimension carrying the pipeline.

    Returns the final stage's ``(n_micro, *x_shape)`` outputs on every
    rank.  Tick ``t`` runs microbatch ``t - s`` on stage ``s`` when it is in
    range, then sends the result to stage ``s + 1``, which runs it at tick
    ``t + 1``; a rank's send and receive of one tick are posted together.
    Under gloo the activations are staged through host buffers.
    """
    import torch.distributed as dist
    if mesh is None or not hasattr(mesh, "get_group"):
        raise ValueError(
            "pipeline_spmd: pass a torch.distributed.device_mesh.DeviceMesh "
            f"with a dimension named {axis!r} (one stage per rank), got {mesh!r}")
    group = mesh.get_group(axis)
    n_stages = group.size()
    if _n_stages(stage_params) != n_stages:
        raise ValueError(
            f"pipeline_spmd: {_n_stages(stage_params)} stages of parameters "
            f"for a mesh dimension {axis!r} of {n_stages} ranks")
    stage = dist.get_rank(group)
    nxt = dist.get_global_rank(group, stage + 1) if stage + 1 < n_stages else None
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    wire = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    params = stage_slice(stage_params, stage)
    n_micro = int(microbatches.shape[0])
    x_shape, dtype, dev = tuple(microbatches.shape[1:]), microbatches.dtype, microbatches.device
    nbytes = microbatches[0].numel() * microbatches.element_size()

    def active(s: int, t: int) -> bool:
        return 0 <= t - s < n_micro

    outs = torch.empty_like(microbatches)
    recv = None
    for t in range(n_micro + n_stages - 1):
        x = microbatches[t] if stage == 0 and t < n_micro else recv
        y = stage_fn(params, x) if active(stage, t) else None
        if stage == n_stages - 1 and active(stage, t):
            outs[t - stage] = y
        ops, recv_buf = [], None
        if nxt is not None and active(stage, t):
            ops.append(dist.P2POp(dist.isend, y.detach().contiguous().reshape(-1)
                                  .view(torch.uint8).to(wire), nxt, group))
        if prv is not None and active(stage, t + 1):
            recv_buf = torch.empty(nbytes, dtype=torch.uint8, device=wire)
            ops.append(dist.P2POp(dist.irecv, recv_buf, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        recv = (recv_buf.view(dtype).reshape(x_shape).to(dev)
                if recv_buf is not None else None)
    # The last stage's outputs to every rank: a broadcast of its bytes,
    # exact for every dtype.
    flat = outs.detach().contiguous().reshape(-1).view(torch.uint8).to(wire)
    dist.broadcast(flat, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return flat.view(dtype).reshape(outs.shape).to(dev)


def pipeline_reference(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                       stage_params: Any,
                       microbatches: torch.Tensor) -> torch.Tensor:
    """Oracle: every microbatch through the stages in order, no mesh.

    ``stage_fn(params_of_stage, x) -> y`` with ``y.shape == x.shape``;
    ``stage_params`` holds one entry per stage as :func:`stage_slice`
    reads it (the port's LM stages are module lists, which do not stack).
    Returns ``(n_micro, *x_shape)``.
    """
    n = _n_stages(stage_params)
    outs = []
    for x in microbatches:
        for s in range(n):
            x = stage_fn(stage_slice(stage_params, s), x)
        outs.append(x)
    return torch.stack(outs)

