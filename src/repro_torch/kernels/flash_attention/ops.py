"""Entry point of forward attention: the Hopper kernel for CUDA tensors,
the plain PyTorch version for CPU tensors.  There is no fallback: a CUDA
operand launches the kernel or raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, Hkv, hd) -> (B, S, H, hd) in q's type.
    On the card bf16 runs the wgmma kernel, float32 and f16 the FFMA
    kernel; k and v are taken in q's type."""
    if q.is_cuda:
        k, v = k.to(q.dtype), v.to(q.dtype)
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
