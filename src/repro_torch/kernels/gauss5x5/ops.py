"""Entry points of the Gauss blur: the Hopper kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.  There is no fallback: a CUDA
operand launches the kernel or raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._entry import kernel_route
from repro_torch.kernels.gauss5x5.kernel import gauss5x5_cuda
from repro_torch.kernels.gauss5x5.ref import gauss5x5_ref, gauss5x5_u8_ref


def gauss5x5(frames: torch.Tensor, *, impl: Optional[str] = None, block_h: int = 60,
             interpret: bool = True) -> torch.Tensor:
    """The 5x5 binomial blur of (H, W) or (N, H, W) frames of any dtype,
    2-pixel border passed through, as float32 (the reference's contract:
    the frames are cast to float32 first).

    ``impl`` as ``kernels._entry`` sets out (the reference's default is
    ``"xla"``; on the card B3 on float32 frames is bit-identical to the
    plain version, so either default gives the same function).
    At ``impl="pallas"``, ``block_h`` is checked as the reference's kernel
    checks it (H a multiple of it); the port's kernel picks its own tiles,
    so the answer does not depend on it.  ``interpret`` has no effect."""
    if impl == "pallas" and frames.shape[-2] % block_h:
        raise ValueError(f"H={frames.shape[-2]} not divisible by block_h={block_h}")
    use_kernel = kernel_route("gauss5x5", impl, interpret, (frames,))
    if frames.dtype != torch.float32:
        frames = frames.to(torch.float32)
    if use_kernel:
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
