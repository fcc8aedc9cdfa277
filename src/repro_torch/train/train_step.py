"""The training step: microbatched gradient accumulation, remat, bf16
gradients with optional error feedback, then AdamW (the port of
``src/repro/train/train_step.py``), on one device or over a mesh.

The step's parts run under ``torch.profiler.record_function`` spans,
``train_step.loss_and_grad`` (forward and backward, every microbatch) and
``train_step.adamw`` (and, over a mesh, ``train_step.gather`` and
``train_step.reduce``), so a profile splits its device time between them.

Parameters are a dict of tensors named as the ``LM``'s state dict (what
:func:`init_params` and ``convert.lm_params_from_numpy`` give).  The step
runs the model's :meth:`~repro_torch.models.LM.train_loss` through
``torch.func.functional_call`` on one ``LM`` skeleton built on the
``meta`` device, so the model holds no weights of its own; it
differentiates detached copies of the params and returns new tensors, so
the same initial params can be fed to two steps.

Over a mesh (``make_train_step(..., mesh=)``) the state is DTensors at the
placements :func:`train_shardings` gives (:func:`shard_train_state`), and
the step is GSPMD's FSDP/ZeRO-1 layout written by hand on the mesh's
process groups: every rank all-gathers the params, runs the step's
forward and backward on its rows of the batch (ranks along ``model`` see
the same rows and repeat the same work), all-gathers the gradient sums
over the data-parallel axes and adds them in rank order (the
single-process microbatch order), takes the global norm of that whole
mean gradient, and runs AdamW on the region of each leaf its moments
cover; under ``zero1`` that region is gathered back over ``data`` into the
param's placement.  With one microbatch a rank, the result is the
single-process step's with ``microbatches`` = the data-parallel size, bit
for bit (two or more per rank add their sums in another order).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm
from repro_torch.train import sharding as shd

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """``unroll`` is accepted and has no effect: the port's model has no
    layer scan to unroll.  ``zero1`` shards the moments over the mesh's
    ``data`` axis (:func:`train_shardings`); on one device it changes
    nothing.  ``donate`` (one device only) lets the step write its AdamW
    update into the params and optimizer state it is given, which it then
    returns: the same values, and one copy of the moments instead of two
    (a full-depth h2o-danube-3-4b step on one 80 GB card needs it)."""
    microbatches: int = 1
    remat: bool = True
    grad_dtype: str = "bf16"       # "bf16" | "f32"
    error_feedback: bool = False   # residual accumulation for bf16 grads
    zero1: bool = False
    kernel_impl: Optional[str] = "xla"
    aux_weight: float = 0.01
    unroll: bool = False
    donate: bool = False           # AdamW writes into the given params and state


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
                    opts: TrainOptions = TrainOptions(), mesh: Any = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; with ``mesh`` (a ``DeviceMesh``) the sharded step
    (:func:`_sharded_step`).  ``batch`` holds ``tokens`` and ``labels`` (B, S) on the
    params' device (and ``frames`` or ``vision_embeds`` for the audio and
    vision families); ``metrics`` holds ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr`` as 0-d tensors.  Microbatches split the batch
    in row order; their gradients add up in ``grad_dtype`` and are divided
    by their count, the loss is their mean and ``ce`` / ``aux`` the last
    one's.  ``error_feedback`` (bf16 grads) applies when ``opt_state`` has
    a ``"feedback"`` dict of float32 residuals."""
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
            new_params, new_core, om = adamw_update(opt_cfg, params, grads, core,
                                                    in_place=opts.donate)
        new_opt = dict(new_core)
        if "feedback" in opt_state:
            new_opt["feedback"] = opt_state["feedback"]
        return new_params, new_opt, {"loss": loss, **parts, **om}

    def sums(params: Params, batch: Mapping[str, torch.Tensor]):
        """(loss sum, the last microbatch's parts, gradient sum in
        grad_dtype, microbatch count): over one microbatch the loss and the
        gradient themselves, over several sums that start from zeros."""
        n_mb = opts.microbatches
        if n_mb == 1:
            loss, parts, g = value_and_grad(params, batch)
            return loss, parts, {k: v.to(gdt) for k, v in g.items()}, 1
        acc = {k: torch.zeros(p.shape, dtype=gdt, device=p.device) for k, p in params.items()}
        loss = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
        for i in range(n_mb):
            mb = {k: v.reshape((n_mb, v.shape[0] // n_mb) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            mb_loss, parts, g = value_and_grad(params, mb)
            acc = {k: acc[k] + g[k].to(gdt) for k in acc}
            loss = loss + mb_loss
        return loss, parts, acc, n_mb

    def accumulate(params: Params, batch: Mapping[str, torch.Tensor]):
        """(mean loss, the last microbatch's parts, grads in grad_dtype)."""
        loss, parts, acc, n = sums(params, batch)
        if n > 1:
            return loss / n, parts, {k: (a / n).to(gdt) for k, a in acc.items()}
        return loss, parts, acc

    if mesh is not None:
        if opts.donate:
            raise ValueError("TrainOptions.donate is for the one-device step")
        return _sharded_step(opt_cfg, opts, mesh, sums, gdt)
    return train_step


# --------------------------------------------------------------------------- #
# Over a mesh.
# --------------------------------------------------------------------------- #
def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _local_batch(x: Any, mesh) -> torch.Tensor:
    """A DTensor's local rows; a plain tensor is the global batch and gives
    this rank's rows by :func:`sharding.batch_specs`."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.to_local()
    pl = shd.placements(shd.batch_specs({"x": x}, mesh)["x"], mesh)
    return x[shd.local_region(x.shape, pl, tuple(mesh.mesh.shape), shd.mesh_coordinate(mesh))]


def _sharded_step(opt_cfg: AdamWConfig, opts: TrainOptions, mesh, sums, gdt):
    """The step over ``mesh`` on DTensor params and optimizer state (see the
    module's docstring).  ``train_step.stats`` holds the last call's host
    seconds by part (``gather_s``, ``compute_s``, ``reduce_s``,
    ``adamw_s``), the bytes this rank sent by collective (``bytes_sent``)
    and the bytes of the gathered params (``full_param_bytes``)."""
    from torch.distributed.tensor import DTensor
    names = list(shd.mesh_axes(mesh))
    sizes = tuple(mesh.mesh.shape)
    dp_dims = [names.index(a) for a in shd.dp_axes(mesh)]
    n_dp = 1
    for i in dp_dims:
        n_dp *= sizes[i]
    coord = shd.mesh_coordinate(mesh)

    def over_dp(x: torch.Tensor, account: Dict[str, float], kind: str) -> list:
        """Every data-parallel rank's ``x`` (this rank's model coordinate),
        in the order of the batch's rows."""
        xs = [x]
        for i in reversed(dp_dims):
            got = shd.gather_list(torch.stack(xs), mesh.get_group(i), account, kind)
            xs = [t for g in got for t in g.unbind(0)]
        return xs

    def region(x: DTensor) -> Tuple[slice, ...]:
        return shd.local_region(x.shape, x.placements, sizes, coord)

    def train_step(params: Dict[str, Any], opt_state: Dict, batch: Mapping[str, Any]):
        account: Dict[str, float] = {}
        t0 = time.perf_counter()
        with record_function("train_step.gather"):
            full = {k: shd.gather_full(p, account, "all_gather_params")
                    for k, p in params.items()}
            local = {k: _local_batch(v, mesh) for k, v in batch.items()}
        probe = next(iter(full.values()))
        _sync(probe)
        t1 = time.perf_counter()
        with record_function("train_step.loss_and_grad"):
            loss_s, parts, gsum, n = sums(full, local)
        _sync(probe)
        t2 = time.perf_counter()
        with record_function("train_step.reduce"):
            if n_dp == 1:
                grads = {k: (a / n).to(gdt) for k, a in gsum.items()} if n > 1 else gsum
                loss = loss_s / n if n > 1 else loss_s
            else:
                total = n_dp * n
                grads = {}
                for k in list(gsum):
                    acc = torch.zeros(gsum[k].shape, dtype=gdt, device=gsum[k].device)
                    for g in over_dp(gsum.pop(k), account, "all_gather_grads"):
                        acc = acc + g
                    grads[k] = (acc / total).to(gdt)
                acc = torch.zeros((), dtype=torch.float32, device=loss_s.device)
                for x in over_dp(loss_s, account, "all_gather_metrics"):
                    acc = acc + x
                loss = acc / total
                last = over_dp(torch.stack([parts[k] for k in sorted(parts)]), account,
                               "all_gather_metrics")[-1]
                parts = {k: last[i] for i, k in enumerate(sorted(parts))}
            new_fb = None
            if opts.error_feedback and opts.grad_dtype == "bf16" \
                    and opt_state.get("feedback") is not None:
                fb = opt_state["feedback"]
                corrected = {k: g.to(torch.float32)
                             + shd.gather_full(fb[k], account, "all_gather_feedback")
                             for k, g in grads.items()}
                grads = {k: c.to(torch.bfloat16) for k, c in corrected.items()}
                new_fb = {k: DTensor.from_local(
                    (c - grads[k].to(torch.float32))[region(fb[k])].contiguous(),
                    mesh, fb[k].placements, run_check=False) for k, c in corrected.items()}
            gnorm = global_norm(grads[k] for k in params)
        _sync(probe)
        t3 = time.perf_counter()
        with record_function("train_step.adamw"):
            m, v = opt_state["m"], opt_state["v"]
            regions = {k: region(m[k]) for k in params}
            count = opt_state["count"]
            core = {"m": {k: x.to_local() for k, x in m.items()},
                    "v": {k: x.to_local() for k, x in v.items()},
                    "count": count.to_local() if isinstance(count, DTensor) else count}
            sub_p, sub_core, om = adamw_update(
                opt_cfg, {k: full[k][regions[k]] for k in params},
                {k: grads[k][regions[k]] for k in params}, core, gnorm=gnorm)
            del full, grads
            new_params = {}
            for k, p in params.items():
                extra = _extra_dims(m[k].placements, p.placements)
                local_p = shd.gather_dims(sub_p.pop(k), mesh, [i for i, _ in extra],
                                          [d for _, d in extra], account, "all_gather_update")
                new_params[k] = DTensor.from_local(local_p, mesh, p.placements,
                                                   run_check=False)
            new_opt: Dict[str, Any] = {
                "m": {k: DTensor.from_local(x, mesh, m[k].placements, run_check=False)
                      for k, x in sub_core["m"].items()},
                "v": {k: DTensor.from_local(x, mesh, v[k].placements, run_check=False)
                      for k, x in sub_core["v"].items()},
                "count": (DTensor.from_local(sub_core["count"], mesh, count.placements,
                                             run_check=False)
                          if isinstance(count, DTensor) else sub_core["count"])}
            if "feedback" in opt_state:
                new_opt["feedback"] = new_fb if new_fb is not None else opt_state["feedback"]
        _sync(probe)
        t4 = time.perf_counter()
        train_step.stats = {"gather_s": t1 - t0, "compute_s": t2 - t1, "reduce_s": t3 - t2,
                            "adamw_s": t4 - t3, "bytes_sent": account,
                            "full_param_bytes": sum(p.numel() * p.element_size()
                                                    for p in params.values())}
        return new_params, new_opt, {"loss": loss, **parts, **om}

    train_step.stats = {}
    return train_step


def _extra_dims(moment_pl, param_pl) -> list:
    """(mesh dim, tensor dim) where a moment is sharded and its param is
    not; every param split must be the moment's too."""
    extra = []
    for i, (a, b) in enumerate(zip(moment_pl, param_pl)):
        if b.is_shard():
            if not (a.is_shard() and a.dim == b.dim):
                raise ValueError(f"a param sharded on mesh dim {i} needs its moments "
                                 f"sharded the same way ({b} vs {a})")
        elif a.is_shard():
            extra.append((i, a.dim))
    return extra


def train_shardings(cfg: ArchConfig, mesh: Any, params_abs: Mapping, opt_abs: Mapping,
                    batch_abs: Mapping, opts: TrainOptions = TrainOptions()):
    """``((p_specs, o_specs, b_specs), dropped)``: the params at
    :func:`sharding.param_specs`, ``m`` and ``v`` there too (under
    ``zero1`` at :func:`sharding.zero1_specs`), ``count`` replicated,
    ``feedback`` at the params' specs under error feedback, the batch at
    :func:`sharding.batch_specs`."""
    p_specs, dropped = shd.param_specs(params_abs, mesh)
    o_specs: Dict[str, Any] = {"m": dict(p_specs), "v": dict(p_specs), "count": ()}
    if opts.zero1:
        o_specs["m"] = shd.zero1_specs(o_specs["m"], params_abs, mesh, cfg=cfg)
        o_specs["v"] = shd.zero1_specs(o_specs["v"], params_abs, mesh, cfg=cfg)
    if opts.error_feedback:
        o_specs["feedback"] = dict(p_specs)
    return (p_specs, o_specs, shd.batch_specs(batch_abs, mesh)), dropped


def shard_train_state(params: Mapping[str, torch.Tensor], opt_state: Mapping[str, Any],
                      specs: tuple, mesh) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Params and optimizer state (the same full tensors on every rank) as
    DTensors at ``specs`` (``(p_specs, o_specs, ...)``, as
    :func:`train_shardings` gives them); no collective."""
    p_specs, o_specs = specs[0], specs[1]
    p = {k: shd.distribute(x, mesh, p_specs[k]) for k, x in params.items()}
    o: Dict[str, Any] = {}
    for key, val in opt_state.items():
        if isinstance(val, Mapping):
            o[key] = {k: shd.distribute(x, mesh, o_specs[key][k]) for k, x in val.items()}
        else:
            o[key] = shd.distribute(val, mesh, o_specs.get(key, ()))
    return p, o


def shard_batch(batch: Mapping[str, Any], mesh, device=None) -> Dict[str, Any]:
    """A global batch (numpy arrays or tensors, the same on every rank) as
    DTensors at :func:`sharding.batch_specs`; integer arrays become int64,
    on ``device`` (the mesh's device type by default)."""
    import numpy as np
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
        else torch.device(mesh.device_type))
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v, np.int64) if np.asarray(v).dtype.kind in "iu"
                                 else np.asarray(v))
        out[k] = v
    specs = shd.batch_specs(out, mesh)
    return {k: shd.distribute(v.to(dev), mesh, specs[k]) for k, v in out.items()}
