"""Entry point of the Mamba2 SSD scan: the Hopper kernel for CUDA tensors,
the plain PyTorch version for CPU tensors.  There is no fallback: a CUDA
operand launches the kernel or raises."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd.kernel import ssd_cuda
from repro_torch.kernels.ssd.ref import ssd_ref


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
        C_: torch.Tensor, *, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan from a zero state; returns (y in x's type, hT float32).
    ``chunk`` is the plain version's chunk length."""
    if x.is_cuda:
        return ssd_cuda(x.contiguous(), dt.contiguous(), A.contiguous(),
                        B_.contiguous(), C_.contiguous())
    return ssd_ref(x, dt, A, B_, C_, chunk)
