"""Entry point of the fused Thres + Med tail: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.  There is no fallback:
a CUDA operand launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.motion_post.kernel import motion_post_cuda
from repro_torch.kernels.motion_post.ref import DEFAULT_THRESHOLD, motion_post_ref


def motion_post(cur: torch.Tensor, prev: torch.Tensor,
                threshold: float = DEFAULT_THRESHOLD) -> torch.Tensor:
    """The motion map of (H, W) or (N, H, W) float32 frame pairs: threshold
    ``|cur - prev|``, then the plus-shaped median."""
    if cur.is_cuda:
        return motion_post_cuda(cur, prev, threshold)
    return motion_post_ref(cur, prev, threshold)
