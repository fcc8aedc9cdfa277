"""Entry point of the RG-LRU recurrence: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.  There is no fallback:
a CUDA operand launches the kernel or raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._entry import kernel_route
from repro_torch.kernels.rglru.kernel import rglru_cuda
from repro_torch.kernels.rglru.ref import rglru_ref, rglru_scan


def rglru(log_a: torch.Tensor, gx: torch.Tensor, *, chunk: int = 128,
          impl: Optional[str] = None, interpret: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(log_a_t) * h_{t-1} + gx_t from h_0 = 0, over (B, L, W);
    returns ``(h_seq, hT)`` in float32.  Operands of any float type are
    cast to float32 first, as the reference's kernel casts them.

    ``impl`` as ``kernels._entry`` sets out (the reference's default is
    ``"pallas"``).  The kernel route gives the step-by-step recurrence bit
    for bit (``rglru_ref``, the CPU path); ``impl="xla"`` gives the
    reference's XLA route, the log-space associative scan ``rglru_scan``,
    whose sums run in another order.  ``chunk`` (a positive int, as the
    reference's kernel pads L to a multiple of it) does not change the
    answer.  ``interpret`` has no effect."""
    if not (isinstance(chunk, int) and chunk > 0):
        raise ValueError(f"rglru: chunk must be a positive int, got {chunk!r}")
    use_kernel = kernel_route("rglru", impl, interpret, (log_a, gx))
    log_a = log_a.to(torch.float32)
    gx = gx.to(torch.float32)
    if impl == "xla":
        return rglru_scan(log_a, gx)
    if use_kernel:
        return rglru_cuda(log_a.contiguous(), gx.contiguous())
    return rglru_ref(log_a, gx)
