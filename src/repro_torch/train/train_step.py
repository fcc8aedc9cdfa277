"""The training step on one device: microbatched gradient accumulation,
remat, bf16 gradients with optional error feedback, then AdamW (the port of
``src/repro/train/train_step.py`` without its mesh).

The step's two parts run under ``torch.profiler.record_function`` spans,
``train_step.loss_and_grad`` (forward and backward, every microbatch) and
``train_step.adamw``, so a profile splits its device time between them.

Parameters are a dict of tensors named as the ``LM``'s state dict (what
:func:`init_params` and ``convert.lm_params_from_numpy`` give).  The step
runs the model's :meth:`~repro_torch.models.LM.train_loss` through
``torch.func.functional_call`` on one ``LM`` skeleton built on the
``meta`` device, so the model holds no weights of its own; it
differentiates detached copies of the params and returns new tensors, so
the same initial params can be fed to two steps.  The sharded step
(``zero1``, ``train_shardings``) is ROADMAP A13b.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_update

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """``unroll`` is accepted and has no effect: the port's model has no
    layer scan to unroll.  ``zero1`` (moments sharded over the data axis)
    needs a mesh and is refused (ROADMAP A13b)."""
    microbatches: int = 1
    remat: bool = True
    grad_dtype: str = "bf16"       # "bf16" | "f32"
    error_feedback: bool = False   # residual accumulation for bf16 grads
    zero1: bool = False
    kernel_impl: Optional[str] = "xla"
    aux_weight: float = 0.01
    unroll: bool = False


class _LossAndGrad(nn.Module):
    """``LM.train_loss`` and its gradient as a module's forward, for
    ``functional_call``: the backward runs inside the call, while the
    params are the model's, since remat recomputes blocks there."""

    def __init__(self, lm: LM):
        super().__init__()
        self.lm = lm

    def forward(self, leaves: Params, tokens, labels, **kw):
        total, parts = self.lm.train_loss(tokens, labels, **kw)
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        return total, parts, grads


def init_params(cfg: ArchConfig, *, device: DeviceLike = None, seed: int = 0) -> Params:
    """The seeded weights of ``LM(cfg, device=device, seed=seed)`` as a
    params dict (the card by default)."""
    return {k: v.detach() for k, v in LM(cfg, device=device, seed=seed).state_dict().items()}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    opts: TrainOptions = TrainOptions()):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` holds ``tokens`` and ``labels`` (B, S) on the
    params' device (and ``frames`` or ``vision_embeds`` for the audio and
    vision families); ``metrics`` holds ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr`` as 0-d tensors.  Microbatches split the batch
    in row order; their gradients add up in ``grad_dtype`` and are divided
    by their count, the loss is their mean and ``ce`` / ``aux`` the last
    one's.  ``error_feedback`` (bf16 grads) applies when ``opt_state`` has
    a ``"feedback"`` dict of float32 residuals."""
    if opts.zero1:
        raise ValueError("TrainOptions(zero1=True) shards the moments over a mesh's "
                         "data axis; the sharded train step is ROADMAP A13b")
    if opts.grad_dtype not in ("bf16", "f32"):
        raise ValueError(f"grad_dtype {opts.grad_dtype!r} is 'bf16' or 'f32'")
    gdt = torch.bfloat16 if opts.grad_dtype == "bf16" else torch.float32
    loss_mod = _LossAndGrad(LM(cfg, device="meta", seed=None))
    extras = ("frames", "vision_embeds")

    def value_and_grad(params: Mapping[str, torch.Tensor], mb: Mapping[str, torch.Tensor]):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            total, parts, grads = torch.func.functional_call(
                loss_mod, {f"lm.{k}": v for k, v in leaves.items()},
                (leaves, mb["tokens"], mb["labels"]),
                dict(kernel_impl=opts.kernel_impl, remat=opts.remat,
                     aux_weight=opts.aux_weight, **{k: mb[k] for k in extras if k in mb}))
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        return total.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def train_step(params: Params, opt_state: Dict, batch: Mapping[str, torch.Tensor]):
        with record_function("train_step.loss_and_grad"):
            loss, parts, grads = accumulate(params, batch)
        if opts.error_feedback and opts.grad_dtype == "bf16":
            fb = opt_state.get("feedback")
            if fb is not None:
                corrected = {k: g.to(torch.float32) + fb[k] for k, g in grads.items()}
                grads = {k: c.to(torch.bfloat16) for k, c in corrected.items()}
                opt_state = dict(opt_state, feedback={
                    k: c - grads[k].to(torch.float32) for k, c in corrected.items()})
        core = {k: v for k, v in opt_state.items() if k != "feedback"}
        with record_function("train_step.adamw"):
            new_params, new_core, om = adamw_update(opt_cfg, params, grads, core)
        new_opt = dict(new_core)
        if "feedback" in opt_state:
            new_opt["feedback"] = opt_state["feedback"]
        return new_params, new_opt, {"loss": loss, **parts, **om}

    def accumulate(params: Params, batch: Mapping[str, torch.Tensor]):
        """(mean loss, the last microbatch's parts, grads in grad_dtype)."""
        n_mb = opts.microbatches
        if n_mb > 1:
            acc = {k: torch.zeros(p.shape, dtype=gdt, device=p.device)
                   for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            for i in range(n_mb):
                mb = {k: v.reshape((n_mb, v.shape[0] // n_mb) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                mb_loss, parts, g = value_and_grad(params, mb)
                acc = {k: acc[k] + g[k].to(gdt) for k in acc}
                loss = loss + mb_loss
            grads = {k: (a / n_mb).to(gdt) for k, a in acc.items()}
            loss = loss / n_mb
        else:
            loss, parts, g = value_and_grad(params, batch)
            grads = {k: v.to(gdt) for k, v in g.items()}
        return loss, parts, grads

    return train_step
