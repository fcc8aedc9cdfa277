"""Entry points of the Gauss blur: the Hopper kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.  There is no fallback: a CUDA
operand launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.gauss5x5.kernel import gauss5x5_cuda
from repro_torch.kernels.gauss5x5.ref import gauss5x5_ref, gauss5x5_u8_ref


def gauss5x5(frames: torch.Tensor) -> torch.Tensor:
    """The 5x5 binomial blur of (H, W) or (N, H, W) frames of any dtype,
    2-pixel border passed through, as float32 (the reference's contract:
    the frames are cast to float32 first)."""
    if frames.dtype != torch.float32:
        frames = frames.to(torch.float32)
    if frames.is_cuda:
        return gauss5x5_cuda(frames)
    return gauss5x5_ref(frames)


def gauss5x5_u8(frames: torch.Tensor) -> torch.Tensor:
    """The Gauss actor's body: uint8 (H, W) or (N, H, W) frames in, the
    blur rounded half to even and clamped to uint8 out, so on the card one
    Gauss firing is one launch."""
    if frames.dtype != torch.uint8:
        raise ValueError(f"gauss5x5_u8: frames must be uint8, got {frames.dtype}")
    if frames.is_cuda:
        return gauss5x5_cuda(frames)
    return gauss5x5_u8_ref(frames)
