"""Common model layers: RMSNorm, RoPE, MLPs, embedding and unembedding,
and the seeded initialisers the blocks draw their weights with.

The arithmetic is plain functions on tensors, rounded where the JAX
package's ``models/layers.py`` rounds: activations and weights are bf16,
norms and the unembedding are computed in float32.  Weights keep the JAX
layout, ``(in, out)``, applied as ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

DTYPE = torch.bfloat16    # activation and weight type
F32 = torch.float32


# ---------------------------------------------------------------------- #
# Seeded initialisers.  ``gen`` is None for a module built only to load a
# state dict: its parameters are left uninitialised.  Parameters do not
# require grad: serving never differentiates, and training differentiates
# its own params dict (``repro_torch.train.train_step``), which it hands
# to the model through ``torch.func.functional_call``.
# ---------------------------------------------------------------------- #
def param(shape, dtype=DTYPE, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def init_normal_(p: nn.Parameter, gen: Optional[torch.Generator], std: float) -> None:
    """``p`` <- N(0, 1) * std drawn in float32, rounded to ``p``'s type."""
    if gen is None:
        return
    with torch.no_grad():
        p.copy_((torch.randn(p.shape, generator=gen, dtype=F32, device=p.device)
                 * std).to(p.dtype))


def dense(in_dim: int, out_dim: int, gen, device) -> nn.Parameter:
    p = param((in_dim, out_dim), device=device)
    init_normal_(p, gen, 1.0 / math.sqrt(in_dim))
    return p


def filled(shape, value: float, dtype=DTYPE, device=None) -> nn.Parameter:
    p = param(shape, dtype, device)
    with torch.no_grad():
        p.fill_(value)
    return p


# ---------------------------------------------------------------------- #
# RMSNorm (gemma-style 1 + scale, computed in float32, cast back).
# ---------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = filled((dim,), 0.0, device=device)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps)


# ---------------------------------------------------------------------- #
# Rotary position embeddings.
# ---------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=device) / half))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); pos: broadcastable to (..., S), integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    ang = pos[..., :, None].to(F32) * freqs                # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# MLPs.  ``jax.nn.gelu`` is the tanh approximation by default.
# ---------------------------------------------------------------------- #
def swiglu(x, w_gate, w_up, w_down):
    g = F.silu((x @ w_gate).to(F32)).to(x.dtype)
    return (g * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    h = F.gelu((x @ w_in + b_in).to(F32), approximate="tanh").to(x.dtype)
    return h @ w_out + b_out


class SwiGLU(nn.Module):
    def __init__(self, d: int, f: int, gen=None, device=None):
        super().__init__()
        self.w_gate = dense(d, f, gen, device)
        self.w_up = dense(d, f, gen, device)
        self.w_down = dense(f, d, gen, device)

    def forward(self, x):
        return swiglu(x, self.w_gate, self.w_up, self.w_down)


class GeluMLP(nn.Module):
    """The GELU MLP of the whisper encoder and decoder, named as the JAX
    package's ``gelu_mlp_init`` names it (biases start at zero)."""

    def __init__(self, d: int, f: int, gen=None, device=None):
        super().__init__()
        self.w_in = dense(d, f, gen, device)
        self.b_in = filled((f,), 0.0, device=device)
        self.w_out = dense(f, d, gen, device)
        self.b_out = filled((d,), 0.0, device=device)

    def forward(self, x):
        return gelu_mlp(x, self.w_in, self.b_in, self.w_out, self.b_out)


# ---------------------------------------------------------------------- #
# Embedding / unembedding.
# ---------------------------------------------------------------------- #
def embed_lookup(embed_w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``embed_w`` (V, D) for ``tokens``, as ``jnp.take``'s default
    ``"fill"`` mode gives them: ids in ``[-V, V)`` index the table (negative
    ones from the end), any other id gives a row of NaN.  Plain tensor ops,
    so an id out of range costs no host sync and trips no device assert."""
    V = embed_w.shape[0]
    t = tokens.long()
    inside = (t >= -V) & (t < V)
    rows = embed_w[torch.where(inside, t.remainder(V), 0)]
    return rows.masked_fill_(~inside[..., None], float("nan"))


def unembed(x: torch.Tensor, w_f32: torch.Tensor) -> torch.Tensor:
    """x: (..., D); w_f32: (V, D) float32 -> logits (..., V) in float32.

    The product is a float32 matmul: on the card it must not run in TF32,
    which is PyTorch's default (``torch.backends.cuda.matmul.allow_tf32``
    is False); the model never turns it on."""
    return x.to(F32) @ w_f32.T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not
    ``ignore_id``; logits float32 (..., V).  The gold logit is taken by the
    reference's masked sum (its ``models/layers.py``), not a gather."""
    logz = torch.logsumexp(logits, dim=-1)
    col = torch.arange(logits.shape[-1], device=logits.device)
    sel = col == labels[..., None].clamp(min=0)
    gold = torch.where(sel, logits, 0.0).sum(-1)
    mask = (labels != ignore_id).to(F32)
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
