"""Entry point of the Mamba2 SSD scan: the Hopper kernel for CUDA tensors,
the plain PyTorch version for CPU tensors.  There is no fallback: a CUDA
operand launches the kernel or raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._entry import kernel_route
from repro_torch.kernels.ssd.kernel import HEAD_DIM, STATE_DIM, ssd_cuda
from repro_torch.kernels.ssd.ref import ssd_ref


#: Types y comes back in: x's, where the reference keeps it (its float32
#: mode holds bf16, f16 and float32); anything else computes to float32.
_Y_TYPES = (torch.bfloat16, torch.float16, torch.float32)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
        C_: torch.Tensor, *, chunk: int = 256, impl: Optional[str] = None,
        interpret: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan from a zero state; returns (y in x's type, hT float32).
    As the reference's kernel does, dt and A are cast to float32, and x, B_
    and C_ are taken in float32, except that all-bf16 operands at mamba2's
    (P, N) = (64, 128) stay bf16 (the card's tensor-core route reads them
    as they are; bf16 converts to float32 exactly).  ``chunk`` is the
    plain version's chunk length; the kernel's is its own, and the answer
    does not depend on it.

    ``impl`` as ``kernels._entry`` sets out (the reference's default is
    ``"pallas"``; on the card ``None`` and ``"pallas"`` launch the kernel,
    ``"xla"`` runs the plain chunked scan, the reference's XLA route).
    ``interpret`` has no effect."""
    use_kernel = kernel_route("ssd", impl, interpret, (x, dt, A, B_, C_))
    y_type = x.dtype if x.dtype in _Y_TYPES else torch.float32
    dt, A = dt.to(torch.float32), A.to(torch.float32)
    if not (x.dtype == B_.dtype == C_.dtype == torch.bfloat16
            and (x.shape[-1], B_.shape[-1]) == (HEAD_DIM, STATE_DIM)):
        x, B_, C_ = (t.to(torch.float32) for t in (x, B_, C_))
    if use_kernel:
        y, h = ssd_cuda(x.contiguous(), dt.contiguous(), A.contiguous(),
                        B_.contiguous(), C_.contiguous())
    else:
        y, h = ssd_ref(x, dt, A, B_, C_, chunk)
    return y.to(y_type), h
