"""RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427).

    r_t = sigmoid(W_a x_t + b_a)                  (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                  (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block: two input linears (recurrent branch and gate branch), a short
causal depthwise conv on the recurrent branch, the RG-LRU and a gated
output projection.  Prefill runs the recurrence through kernel B7
(:func:`repro_torch.kernels.rglru.rglru`); at ``kernel_impl="xla"`` its
entry runs the JAX package's log-space associative scan
(:func:`~repro_torch.kernels.rglru.rglru_scan`), as the reference's block
does, which training differentiates.  The one-step decode is plain.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RGLRUConfig
from repro_torch.kernels.rglru import rglru
from repro_torch.models.layers import DTYPE, F32, dense, filled, init_normal_, param

_C = 8.0


class RGLRUBlock(nn.Module):
    """Parameters of one recurrent block, named as the JAX package's
    ``rglru_block_init`` names them."""

    def __init__(self, d_model: int, cfg: RGLRUConfig, gen=None, device=None):
        super().__init__()
        w = cfg.lru_width or d_model
        self.in_x = dense(d_model, w, gen, device)
        self.in_gate = dense(d_model, w, gen, device)
        self.conv_w = param((cfg.conv_width, w), device=device)
        init_normal_(self.conv_w, gen, 1.0 / math.sqrt(cfg.conv_width))
        self.conv_b = filled((w,), 0.0, device=device)
        self.w_a = dense(w, w, gen, device)
        self.b_a = filled((w,), 0.0, device=device)
        self.w_x = dense(w, w, gen, device)
        self.b_x = filled((w,), 0.0, device=device)
        self.lam = param((w,), F32, device)
        with torch.no_grad():
            self.lam.copy_(torch.linspace(0.5, 4.0, w, dtype=F32))
        self.out = dense(w, d_model, gen, device)

    def forward(self, x, *, mode: str = "train", state=None,
                kernel_impl: Optional[str] = None):
        return rglru_block(self, x, mode=mode, state=state, kernel_impl=kernel_impl)


def rglru_gates(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, W) -> (log_a, gated_x), both (B, L, W) float32."""
    r = torch.sigmoid((x @ p.w_a + p.b_a).to(F32))
    i = torch.sigmoid((x @ p.w_x + p.b_x).to(F32))
    log_a = -_C * F.softplus(p.lam.to(F32)) * r
    gx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x.to(F32))
    return log_a, gx


def _conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Causal depthwise conv: x (B, L, C), w (K, C); ``state`` the
    (B, K-1, C) history or None (zeros).  Returns (y, new history)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    L = x.shape[1]
    y = torch.zeros(x.shape, dtype=F32, device=x.device)
    for t in range(K):
        y = y + w[t].to(F32) * xp[:, t:t + L].to(F32)
    return (y + b.to(F32)).to(x.dtype), xp[:, -(K - 1):]


def rglru_block(p, x: torch.Tensor, *, mode: str = "train",
                state: Optional[Dict[str, torch.Tensor]] = None,
                kernel_impl: Optional[str] = None):
    """x: (B, L, D).  ``mode`` "train" or "prefill" runs the whole sequence
    through B7's entry (``kernel_impl`` its ``impl``: None the device rule,
    "xla" the associative scan ``rglru_scan``); "decode" takes L == 1 and
    ``state`` {'conv', 'h'}.
    Returns (y, new state); the new state is None in "train"."""
    gate = F.gelu((x @ p.in_gate).to(F32), approximate="tanh").to(x.dtype)
    u = x @ p.in_x
    u, new_conv = _conv(u, p.conv_w, p.conv_b, state["conv"] if mode == "decode" else None)
    log_a, gx = rglru_gates(p, u)
    if mode == "decode":
        h = torch.exp(log_a[:, 0]) * state["h"] + gx[:, 0]
        hs = h[:, None]
        new_state = {"conv": new_conv, "h": h}
    else:
        hs, hT = rglru(log_a, gx, impl=kernel_impl)
        new_state = {"conv": new_conv, "h": hT} if mode == "prefill" else None
    y = hs.to(x.dtype) * gate
    return y @ p.out, new_state


def rglru_state_init(batch: int, d_model: int, cfg: RGLRUConfig, device=None):
    w = cfg.lru_width or d_model
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=DTYPE, device=device),
            "h": torch.zeros((batch, w), dtype=F32, device=device)}
