"""Mamba2 block (arXiv:2405.21060): in_proj -> causal conv -> SSD ->
gated RMSNorm -> out_proj.

State per head: h in R^{P x N} (P = head_dim, N = state_dim) with a scalar
decay per head.  Prefill runs the SSD scan through kernel B6
(:func:`repro_torch.kernels.ssd.ssd`); the one-step decode is plain.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd import ssd
from repro_torch.models.layers import (DTYPE, F32, RMSNorm, dense, filled,
                                       init_normal_, param, rmsnorm)


class Mamba2Block(nn.Module):
    """Parameters of one Mamba2 mixer, named as the JAX package's
    ``mamba2_init`` names them."""

    def __init__(self, d_model: int, s: SSMConfig, gen=None, device=None):
        super().__init__()
        di = s.d_inner(d_model)
        nh = s.n_heads(d_model)
        conv_dim = di + 2 * s.state_dim
        self.in_proj = dense(d_model, 2 * di + 2 * s.state_dim + nh, gen, device)
        self.conv_w = param((s.conv_width, conv_dim), device=device)
        init_normal_(self.conv_w, gen, 1.0 / math.sqrt(s.conv_width))
        self.conv_b = filled((conv_dim,), 0.0, device=device)
        self.dt_bias = filled((nh,), 0.0, F32, device)
        self.A_log = param((nh,), F32, device)
        with torch.no_grad():
            self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, dtype=F32)))
        self.D = filled((nh,), 1.0, F32, device)
        self.gate_norm = RMSNorm(di, device)
        self.out_proj = dense(di, d_model, gen, device)


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """x: (B, L, C); w: (K, C) depthwise; state: (B, K-1, C) history or
    None.  Returns (silu(conv + b) in x's type, new history)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    L = x.shape[1]
    y = torch.zeros(x.shape, dtype=F32, device=x.device)
    for t in range(K):
        y = y + w[t].to(F32) * xp[:, t:t + L].to(F32)
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return F.silu(y + b.to(F32)).to(x.dtype), new_state


def _split_proj(z, di, nstate, nh):
    zx = z[..., :di]
    gate = z[..., di:2 * di]
    B_ = z[..., 2 * di:2 * di + nstate]
    C_ = z[..., 2 * di + nstate:2 * di + 2 * nstate]
    dt = z[..., 2 * di + 2 * nstate:]
    return zx, gate, B_, C_, dt


def mamba2_block(p, x: torch.Tensor, s: SSMConfig, *, mode: str = "train",
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 kernel_impl: Optional[str] = None):
    """x: (B, L, D).  "train"/"prefill": the whole sequence through B6
    (``kernel_impl`` is its entry's ``impl``: None the device rule, "xla"
    the plain chunked scan, which training differentiates);
    "decode": L == 1 with ``state`` {'conv', 'ssm'}.  Returns (y, new state);
    the new state is None in "train"."""
    B, L, D = x.shape
    di = s.d_inner(D)
    nh = s.n_heads(D)
    N = s.state_dim

    z = x @ p.in_proj
    zx, gate, B_, C_, dtr = _split_proj(z, di, N, nh)
    conv_in = torch.cat([zx, B_, C_], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p.conv_w, p.conv_b,
                                        state["conv"] if mode == "decode" else None)
    zx = conv_out[..., :di]
    B_ = conv_out[..., di:di + N]
    C_ = conv_out[..., di + N:]

    dt = F.softplus(dtr.to(F32) + p.dt_bias)                      # (B, L, nh)
    A = -torch.exp(p.A_log)                                       # (nh,)
    xh = zx.reshape(B, L, nh, s.head_dim)

    if mode == "decode":
        decay = torch.exp(dt[:, 0] * A)                           # (B, nh)
        upd = (dt[:, 0][..., None, None] * xh[:, 0].to(F32)[..., :, None]
               * B_[:, 0].to(F32)[:, None, None, :])
        h_new = state["ssm"] * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", h_new, C_[:, 0].to(F32))[:, None]
        y = y.reshape(B, 1, nh, s.head_dim).to(x.dtype)
        new_state = {"conv": conv_state, "ssm": h_new}
    else:
        y, hT = ssd(xh, dt, A, B_, C_, chunk=s.chunk, impl=kernel_impl)
        new_state = {"conv": conv_state, "ssm": hT} if mode == "prefill" else None

    y = y + p.D.to(F32)[None, None, :, None] * xh.to(F32)
    y = y.reshape(B, L, di).to(x.dtype)
    y = rmsnorm(y * F.silu(gate.to(F32)).to(x.dtype), p.gate_norm.scale)
    return y @ p.out_proj, new_state


def mamba2_state_init(batch: int, d_model: int, s: SSMConfig, device=None):
    di = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, di + 2 * s.state_dim),
                            dtype=DTYPE, device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.state_dim), dtype=F32, device=device),
    }
