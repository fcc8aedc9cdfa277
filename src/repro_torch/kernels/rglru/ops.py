"""Entry point of the RG-LRU recurrence: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.  There is no fallback:
a CUDA operand launches the kernel or raises."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rglru.kernel import rglru_cuda
from repro_torch.kernels.rglru.ref import rglru_ref


def rglru(log_a: torch.Tensor, gx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(log_a_t) * h_{t-1} + gx_t from h_0 = 0, over (B, L, W);
    returns ``(h_seq, hT)`` in float32.  Operands of any float type are
    cast to float32 first, as the reference's kernel casts them."""
    log_a = log_a.to(torch.float32)
    gx = gx.to(torch.float32)
    if gx.is_cuda:
        return rglru_cuda(log_a.contiguous(), gx.contiguous())
    return rglru_ref(log_a, gx)
