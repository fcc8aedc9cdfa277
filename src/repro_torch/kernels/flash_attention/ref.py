"""Plain PyTorch version of forward attention with GQA, causal and
sliding-window masks (B5's oracle and CPU path): the dense masked softmax
of the JAX package's ``kernels/flash_attention/ref.py``, in float32, cast
to q's type at the end."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(S: int, causal: bool, window: Optional[int], device=None) -> torch.Tensor:
    """(S, S) bool, True where query i may attend key j."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= (i - j) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, Hkv, hd).  Returns (B, S, H, hd)."""
    return masked_attention_ref(q, k, v, attention_mask(q.shape[1], causal, window, q.device))


def masked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """:func:`flash_attention_ref` under any (S, S) boolean ``mask``."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, hd).to(torch.float32)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(torch.float32))
    scores = scores / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, dtype=torch.float32,
                                                    device=q.device))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.to(torch.float32))
    return o.reshape(B, S, H, hd).to(q.dtype)
