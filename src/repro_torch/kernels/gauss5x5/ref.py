"""Plain PyTorch version of the Gauss actor's blur (paper §4.1).

A 5x5 binomial blur, ``[1,4,6,4,1]^T [1,4,6,4,1] / 256``, over edge-padded
(clamped) neighbours; the 2-pixel border, rows and columns, passes the
original pixel through.  The taps are summed from 0 in row-major order,
the order of the Hopper kernel (``csrc/gauss5x5.cu``), which therefore
agrees with this version to the bit.  On integer-valued frames (the
graph's u8 case) every partial sum is a multiple of 1/256 below 256, exact
in float32, so this version also equals the JAX reference's 25-tap and
separable routes exactly.
"""
from __future__ import annotations

import numpy as np
import torch

KERNEL_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
KERNEL_2D = np.outer(KERNEL_1D, KERNEL_1D)  # sums to 1


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x), 0, 255)`` as uint8, rounding half to even as
    ``jnp.round`` does (the actors' u8 port contract)."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def edge_pad(frames: torch.Tensor, k: int) -> torch.Tensor:
    """``frames`` (..., H, W) padded by ``k`` on both spatial axes with
    its edge pixels (``jnp.pad(mode="edge")``)."""
    H, W = frames.shape[-2:]
    dev = frames.device
    rows = torch.arange(-k, H + k, device=dev).clamp_(0, H - 1)
    cols = torch.arange(-k, W + k, device=dev).clamp_(0, W - 1)
    return frames.index_select(-2, rows).index_select(-1, cols)


def border_mask(H: int, W: int, k: int, device) -> torch.Tensor:
    """True on the ``k``-pixel border of an (H, W) frame."""
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys < k) | (ys >= H - k) | (xs < k) | (xs >= W - k)


def gauss5x5_ref(frames: torch.Tensor) -> torch.Tensor:
    """``frames`` (..., H, W) float32 -> the blurred frames, border kept."""
    H, W = frames.shape[-2:]
    pad = edge_pad(frames, 2)
    acc = torch.zeros_like(frames)
    for dy in range(5):
        for dx in range(5):
            acc = acc + float(KERNEL_2D[dy, dx]) * pad[..., dy:dy + H, dx:dx + W]
    return torch.where(border_mask(H, W, 2, frames.device), frames, acc)


def gauss5x5_u8_ref(frames: torch.Tensor) -> torch.Tensor:
    """The Gauss actor's body: uint8 frames in, blurred and rounded uint8
    frames out."""
    return to_u8(gauss5x5_ref(frames.to(torch.float32)))
