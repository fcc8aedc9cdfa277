"""AdamW with a linear-warmup cosine schedule and global-norm clipping, as
explicit math over a params dict (the port of ``src/repro/optim/adamw.py``).

Parameters are a dict of tensors named as the ``LM``'s state dict.  The
optimizer state mirrors it: ``m`` and ``v`` are float32 whatever the
parameter's type (bf16 parameters keep float32 moments), ``count`` is an
int32 scalar.  The update is written as the reference writes it, leaf by
leaf, in float32 and in its order of operations; no ``torch.optim``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

F32 = torch.float32
Params = Dict[str, torch.Tensor]
# An update in place runs over each leaf in slices of at most this many
# elements: the float32 temporaries of the update (about nine of a slice's
# size) then stay small beside the leaf itself (a 152 064 x 8192 table
# would need 45 GB of them at once).
IN_PLACE_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr``, in float32."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """Zero moments beside each parameter, on its device; count 0."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=F32, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=F32, device=p.device) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_opt_state(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """The optimizer state's shapes and types as ``meta`` tensors."""
    meta = {k: torch.empty(p.shape, dtype=F32, device="meta") for k, p in params.items()}
    return {"m": meta, "v": dict(meta),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all the tensors together, summed in float32."""
    sq = [torch.sum(torch.square(x.to(F32))) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Mapping[str, object],
                 gnorm: Optional[torch.Tensor] = None, in_place: bool = False
                 ) -> Tuple[Params, Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step: clip by the global norm, update the float32 moments,
    bias-correct, decoupled weight decay.  Grads may be bf16.  Returns new
    tensors (params in their own type, the state, and the metrics
    ``grad_norm`` and ``lr``); the inputs are not changed.  ``gnorm``, when
    given, is the global norm to clip by (a sharded step updates slices of
    the leaves and takes the norm of the whole gradient).  ``in_place``
    writes the new params, moments and count into the given tensors, leaf
    by leaf, and returns those: the same values, bit for bit, without a
    second copy of the moments alive at once (the JAX package's donated
    buffers).  In place, each leaf is updated in slices of at most
    ``IN_PLACE_SLICE`` elements; every operation is elementwise, so the
    values are the same."""
    count = state["count"] + 1
    b1, b2 = cfg.betas
    lr = schedule(cfg, count)
    if gnorm is None:
        gnorm = global_norm(grads[k] for k in params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    cf = count.to(F32)

    def update(p, g, m, v):
        g = g.to(F32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** cf)
        vhat = v / (1 - b2 ** cf)
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * step_).to(p.dtype), m, v

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        if not in_place:
            new_p[k], new_m[k], new_v[k] = update(p, grads[k], m, v)
            continue
        for piece in zip(*(t.view(-1).split(IN_PLACE_SLICE)
                           for t in (p, grads[k].reshape(-1), m, v))):
            for dst, val in zip(piece[:1] + piece[2:], update(*piece)):
                dst.copy_(val)
        new_p[k], new_m[k], new_v[k] = p, m, v
    if in_place:
        count = state["count"].copy_(count)
    return new_p, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gnorm, "lr": lr}
