"""Entry point of forward attention: the Hopper kernel for CUDA tensors,
the plain PyTorch version for CPU tensors.  There is no fallback: a CUDA
operand launches the kernel or raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._entry import kernel_route
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: Optional[str] = None, bq: int = 128, bk: int = 128,
                    interpret: bool = True) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, Hkv, hd) -> (B, S, H, hd) in q's type.
    On the card bf16 runs the wgmma kernel, float32 and f16 the FFMA
    kernel; k and v are taken in q's type.

    ``impl`` as ``kernels._entry`` sets out (the reference's default is
    ``"pallas"``; ``None`` and ``"pallas"`` give the same function on the
    card).  At ``impl="pallas"``, ``bq`` and ``bk`` are checked as the
    reference's kernel checks them (S a multiple of each, after clipping
    to S); the port's kernel picks its own tiles, so the answer does not
    depend on them.  ``interpret`` has no effect."""
    if impl == "pallas":
        S = q.shape[1]
        if S % min(bq, S) or S % min(bk, S):
            raise ValueError(f"S={S} must divide block sizes ({min(bq, S)}, {min(bk, S)})")
    if kernel_route("flash_attention", impl, interpret, (q, k, v)):
        k, v = k.to(q.dtype), v.to(q.dtype)
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
