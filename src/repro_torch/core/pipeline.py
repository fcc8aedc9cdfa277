"""Pipelines of actor stages — the reference's ``core/pipeline.py``.

:func:`pipeline_reference` runs microbatches through a chain of stages
one after another on one device: the oracle the stage actor network
(``graphs/lm_pipeline.py``) is held to.  :func:`pipeline_spmd`, the GPipe
schedule over a mesh axis with stage-to-stage transfers, needs a mesh and
collectives: ROADMAP A12.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def pipeline_spmd(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any, microbatches: torch.Tensor, mesh: Any,
                  axis: str = "stage") -> torch.Tensor:
    """The reference's mesh pipeline; not ported yet (ROADMAP A12)."""
    raise NotImplementedError(
        "pipeline_spmd runs one stage per device of a mesh axis, with "
        "stage-to-stage transfers as collectives; multi-device is not ported "
        "yet: ROADMAP A12")


def pipeline_reference(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                       stage_params: Sequence[Any],
                       microbatches: torch.Tensor) -> torch.Tensor:
    """Oracle: every microbatch through the stages in order, no mesh.

    ``stage_fn(params_of_stage, x) -> y`` with ``y.shape == x.shape``;
    ``stage_params`` holds one entry per stage (the reference stacks them
    on a leading axis of each leaf; the port's LM stages are module lists,
    which do not stack).  Returns ``(n_micro, *x_shape)``.
    """
    outs = []
    for x in microbatches:
        for p in stage_params:
            x = stage_fn(p, x)
        outs.append(x)
    return torch.stack(outs)
