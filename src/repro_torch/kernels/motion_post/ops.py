"""Entry point of the fused Thres + Med tail: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.  There is no fallback:
a CUDA operand launches the kernel or raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._entry import kernel_route
from repro_torch.kernels.motion_post.kernel import motion_post_cuda
from repro_torch.kernels.motion_post.ref import DEFAULT_THRESHOLD, motion_post_ref


def motion_post(cur: torch.Tensor, prev: torch.Tensor,
                threshold: float = DEFAULT_THRESHOLD, *, impl: Optional[str] = None,
                block_h: int = 60, interpret: bool = True) -> torch.Tensor:
    """The float32 motion map of (H, W) or (N, H, W) frame pairs of any
    dtype, as float32 values (the reference's contract): threshold
    ``|cur - prev|``, then the plus-shaped median.  On the card a pair of
    uint8 or of float32 frames goes into the kernel as it is (u8 -> f32 is
    exact, and so is the difference of two such values); other pairs are
    cast to float32 first.

    ``impl`` as ``kernels._entry`` sets out (the reference's default is
    ``"xla"``; B4 is bit-identical to the plain version, so either default
    gives the same function).  At ``impl="pallas"``, ``block_h`` is
    checked as the reference's kernel checks it (H a multiple of it); the
    port's kernel picks its own tiles, so the answer does not depend on it.
    ``interpret`` has no effect."""
    if impl == "pallas" and cur.shape[-2] % block_h:
        raise ValueError(f"H={cur.shape[-2]} not divisible by block_h={block_h}")
    if kernel_route("motion_post", impl, interpret, (cur, prev)):
        if not (cur.dtype == prev.dtype
                and (cur.dtype == torch.uint8 or cur.dtype == torch.float32)):
            cur, prev = cur.to(torch.float32), prev.to(torch.float32)
        return motion_post_cuda(cur, prev, threshold)
    return motion_post_ref(cur.to(torch.float32), prev.to(torch.float32), threshold)
