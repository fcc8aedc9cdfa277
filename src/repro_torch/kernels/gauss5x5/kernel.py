"""ctypes wrapper of the Hopper Gauss kernel (``csrc/gauss5x5.cu``).

Replaces ``src/repro/kernels/gauss5x5/kernel.py::gauss5x5_pallas``.  The
library is built and loaded at the first launch, never at import.
:func:`gauss5x5_cuda` checks its operand, launches on PyTorch's current
stream without synchronising, raises on a refused launch, and adds one to
``gauss5x5_cuda.launches`` per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: Frames one launch takes (the grid's z extent).
MAX_FRAMES = 65535


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("gauss5x5")
    fn = lib.gauss5x5_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gauss5x5_error_string.argtypes = [ctypes.c_int]
    lib.gauss5x5_error_string.restype = ctypes.c_char_p
    return lib


def gauss5x5_cuda(frames: torch.Tensor) -> torch.Tensor:
    """One launch over ``frames``: a contiguous (H, W) or (N, H, W) CUDA
    tensor, float32 (blurred float32 out) or uint8 (blurred and rounded
    uint8 out).  Returns a new tensor of the same shape and type."""
    if not frames.is_cuda:
        raise ValueError(f"gauss5x5_cuda: frames must be a CUDA tensor, got "
                         f"{frames.device}")
    if (frames.dtype not in (torch.float32, torch.uint8)
            or frames.dim() not in (2, 3) or not frames.is_contiguous()):
        raise ValueError(f"gauss5x5_cuda: frames must be contiguous float32 or "
                         f"uint8 (H, W) or (N, H, W), got {frames.dtype} "
                         f"{tuple(frames.shape)} strides {frames.stride()}")
    n = frames.shape[0] if frames.dim() == 3 else 1
    H, W = frames.shape[-2:]
    if not 1 <= n <= MAX_FRAMES or H < 1 or W < 1:
        raise ValueError(f"gauss5x5_cuda: shape {tuple(frames.shape)} outside "
                         f"1..{MAX_FRAMES} frames of at least 1 x 1")
    out = torch.empty_like(frames)
    lib = _library()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = lib.gauss5x5_run(frames.data_ptr(), out.data_ptr(), n, H, W,
                           int(frames.dtype == torch.uint8), stream)
    if err != 0:
        raise RuntimeError(f"gauss5x5 launch failed: CUDA error {err} "
                           f"({lib.gauss5x5_error_string(err).decode()})")
    gauss5x5_cuda.launches += 1
    return out


#: Launches of the kernel since the count was last set to 0.
gauss5x5_cuda.launches = 0
