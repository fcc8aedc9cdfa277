"""Plain PyTorch versions of the Mamba2 SSD scan (B6's oracle and CPU
path).

:func:`ssd_ref` is the chunked SSD algorithm of the JAX package's
``ssd_chunked`` (``models/ssm.py``): the intra-chunk attention form
(C B^T * L)(dt x), the chunk-final states, a scan over chunks, and the
inter-chunk term C exp(cum) h.  Products are written as explicit matmuls
so no multi-operand einsum builds a large intermediate.  :func:`ssd_naive`
is the step-by-step recurrence, the tests' second oracle.

Shapes: x (B, L, H, P); dt (B, L, H) float32; A (H,); B_, C_ (B, L, N).
Both return (y (B, L, H, P) in x's type, hT (B, H, P, N) float32).
"""
from __future__ import annotations

import torch

F32 = torch.float32


def ssd_naive(x, dt, A, B_, C_):
    """h_t = exp(A dt_t) h_{t-1} + dt_t (x_t outer B_t); y_t = h_t C_t."""
    Bsz, L, H, P = x.shape
    N = B_.shape[-1]
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t].to(F32) * A.to(F32))                 # (B, H)
        upd = (dt[:, t].to(F32)[..., None, None] * x[:, t].to(F32)[..., :, None]
               * B_[:, t].to(F32)[:, None, None, :])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_[:, t].to(F32)))
    return torch.stack(ys, dim=1).to(x.dtype), h


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < u <= i} a[..., u]; -inf above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return torch.where(keep, diff, torch.tensor(float("-inf"), dtype=a.dtype,
                                                device=a.device))


def ssd_ref(x, dt, A, B_, C_, chunk: int):
    """The chunked SSD scan from a zero state; L is padded to a chunk multiple with dt = 0
    steps (decay 1, no update), which change neither state nor outputs."""
    Bsz, L, H, P = x.shape
    N = B_.shape[-1]
    L0 = L
    if L % chunk:
        pad = chunk - L % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B_ = torch.nn.functional.pad(B_, (0, 0, 0, pad))
        C_ = torch.nn.functional.pad(C_, (0, 0, 0, pad))
        L += pad
    nc = L // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P).to(F32).permute(0, 1, 3, 2, 4)  # (B,z,H,c,P)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(F32).permute(0, 1, 3, 2)      # (B,z,H,c)
    Bc = B_.reshape(Bsz, nc, chunk, N).to(F32)                            # (B,z,c,N)
    Cc = C_.reshape(Bsz, nc, chunk, N).to(F32)

    dA = dtc * A.to(F32)[:, None]                                         # (B,z,H,c)
    Lmat = torch.exp(_segsum(dA))                                         # (B,z,H,c,c)

    # Intra-chunk: Y1[t] = sum_{s<=t} (C_t . B_s) L[t, s] dt_s x_s.
    G = Cc @ Bc.transpose(-1, -2)                                         # (B,z,c,c)
    M = G[:, :, None] * Lmat
    Y1 = (M * dtc[:, :, :, None, :]) @ xc                                 # (B,z,H,c,P)

    # Chunk-final states: S_z = sum_s exp(cum_T - cum_s) dt_s x_s B_s^T.
    dA_cum = torch.cumsum(dA, dim=-1)
    total = dA_cum[..., -1:]
    w = torch.exp(total - dA_cum) * dtc                                   # (B,z,H,c)
    S = (w[..., None] * xc).transpose(-1, -2) @ Bc[:, :, None]            # (B,z,H,P,N)

    # Inter-chunk scan over states (the state entering each chunk).
    chunk_decay = torch.exp(total[..., 0])                                # (B,z,H)
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, z, :, None, None] + S[:, z]
    h_in = torch.stack(h_in, dim=1)                                       # (B,z,H,P,N)

    # Inter-chunk: Y2[t] = exp(cum_t) C_t h_in^T.
    Y2 = torch.exp(dA_cum)[..., None] * (Cc[:, :, None] @ h_in.transpose(-1, -2))
    y = (Y1 + Y2).permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P)[:, :L0]
    return y.to(x.dtype), h
