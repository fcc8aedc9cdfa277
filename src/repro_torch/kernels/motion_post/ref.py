"""Plain PyTorch version of the motion detection tail (paper §4.1).

Thres: ``|cur - prev| > T -> 255, else 0``.  Med: a plus-shaped 5-point
median over the edge-padded map, through the reference's min/max network.
Only compares, ``abs``, one subtraction and min/max, so this version, the
Hopper kernel (``csrc/motion_post.cu``) and the JAX reference agree
exactly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gauss5x5.ref import edge_pad

DEFAULT_THRESHOLD = 40.0


def thres_ref(cur: torch.Tensor, prev: torch.Tensor,
              threshold: float = DEFAULT_THRESHOLD) -> torch.Tensor:
    """The motion map of two float32 frames: 255 where they differ by more
    than ``threshold``, else 0."""
    return torch.where(torch.abs(cur - prev) > threshold, 255.0, 0.0).to(cur.dtype)


def median5(a, b, c, d, e):
    """Median of 5 via min/max network:
    med5(a..e) = med3(e, max(min(a,b), min(c,d)), min(max(a,b), max(c,d)))."""
    mn, mx = torch.minimum, torch.maximum
    f = mx(mn(a, b), mn(c, d))
    g = mn(mx(a, b), mx(c, d))
    return mx(mn(f, g), mn(e, mx(f, g)))


def med_ref(m: torch.Tensor) -> torch.Tensor:
    """Plus-shaped 5-point median of (..., H, W) frames, edge-padded."""
    H, W = m.shape[-2:]
    p = edge_pad(m, 1)
    c = p[..., 1:H + 1, 1:W + 1]
    u = p[..., 0:H, 1:W + 1]
    d = p[..., 2:H + 2, 1:W + 1]
    lt = p[..., 1:H + 1, 0:W]
    rt = p[..., 1:H + 1, 2:W + 2]
    return median5(u, d, lt, rt, c)


def motion_post_ref(cur: torch.Tensor, prev: torch.Tensor,
                    threshold: float = DEFAULT_THRESHOLD) -> torch.Tensor:
    return med_ref(thres_ref(cur, prev, threshold))
