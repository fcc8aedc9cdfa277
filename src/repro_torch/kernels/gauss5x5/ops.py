"""Entry point of the Gauss actor's blur: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.  There is no fallback:
a CUDA operand launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.gauss5x5.kernel import gauss5x5_cuda
from repro_torch.kernels.gauss5x5.ref import gauss5x5_ref, gauss5x5_u8_ref


def gauss5x5(frames: torch.Tensor) -> torch.Tensor:
    """The 5x5 binomial blur of (H, W) or (N, H, W) frames, 2-pixel border
    passed through.  float32 in gives float32 out (the TPU kernel's
    function); uint8 in gives uint8 out, rounded half to even and clamped
    (the Gauss actor's body), so on the card one Gauss firing is one
    launch."""
    if frames.is_cuda:
        return gauss5x5_cuda(frames)
    if frames.dtype == torch.uint8:
        return gauss5x5_u8_ref(frames)
    return gauss5x5_ref(frames)
