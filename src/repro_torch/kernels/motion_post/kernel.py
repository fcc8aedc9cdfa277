"""ctypes wrapper of the Hopper Thres + Med kernel (``csrc/motion_post.cu``).

Replaces ``src/repro/kernels/motion_post/kernel.py::motion_post_pallas``.
The library is built and loaded at the first launch, never at import.
:func:`motion_post_cuda` checks its operands, launches on PyTorch's current
stream without synchronising, raises on a refused launch, and adds one to
``motion_post_cuda.launches`` per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gauss5x5.kernel import MAX_FRAMES


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("motion_post")
    fn = lib.motion_post_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.motion_post_error_string.argtypes = [ctypes.c_int]
    lib.motion_post_error_string.restype = ctypes.c_char_p
    return lib


def motion_post_cuda(cur: torch.Tensor, prev: torch.Tensor,
                     threshold: float) -> torch.Tensor:
    """One launch over a pair of contiguous float32 (H, W) or (N, H, W)
    CUDA tensors of one shape on one device; returns the new float32
    motion map of that shape."""
    for t, what in ((cur, "cur"), (prev, "prev")):
        if not t.is_cuda:
            raise ValueError(f"motion_post_cuda: {what} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or t.dim() not in (2, 3) or not t.is_contiguous():
            raise ValueError(f"motion_post_cuda: {what} must be contiguous "
                             f"float32 (H, W) or (N, H, W), got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if cur.shape != prev.shape or cur.device != prev.device:
        raise ValueError(f"motion_post_cuda: cur {tuple(cur.shape)} on "
                         f"{cur.device} and prev {tuple(prev.shape)} on "
                         f"{prev.device} differ")
    n = cur.shape[0] if cur.dim() == 3 else 1
    H, W = cur.shape[-2:]
    if not 1 <= n <= MAX_FRAMES or H < 1 or W < 1:
        raise ValueError(f"motion_post_cuda: shape {tuple(cur.shape)} outside "
                         f"1..{MAX_FRAMES} frames of at least 1 x 1")
    out = torch.empty_like(cur)
    lib = _library()
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    err = lib.motion_post_run(cur.data_ptr(), prev.data_ptr(), out.data_ptr(),
                              n, H, W, float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"motion_post launch failed: CUDA error {err} "
                           f"({lib.motion_post_error_string(err).decode()})")
    motion_post_cuda.launches += 1
    return out


#: Launches of the kernel since the count was last set to 0.
motion_post_cuda.launches = 0
