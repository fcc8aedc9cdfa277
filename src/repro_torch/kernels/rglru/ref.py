"""Plain PyTorch version of the RG-LRU recurrence (B7's oracle and CPU
path): the step-by-step recurrence of the JAX package's ``rglru_naive``,
which is also the TPU kernel's own order (exp, product, sum)."""
from __future__ import annotations

from typing import Tuple

import torch


def rglru_ref(log_a: torch.Tensor, gx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, gx: (B, L, W) float32 -> (h_seq (B, L, W), hT (B, W)), from
    h_0 = 0."""
    B, L, W = gx.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=gx.device)
    a = torch.exp(log_a)
    hs = torch.empty_like(gx)
    for t in range(L):
        h = a[:, t] * h + gx[:, t]
        hs[:, t] = h
    return hs, h
