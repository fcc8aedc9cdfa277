"""ctypes wrapper of the Hopper Gauss kernel (``csrc/gauss5x5.cu``).

Replaces ``src/repro/kernels/gauss5x5/kernel.py::gauss5x5_pallas``.  The
library is built and loaded at the first launch, never at import.
:func:`gauss5x5_cuda` checks its operand, launches on PyTorch's current
stream without synchronising, raises on a refused launch, and adds one to
``gauss5x5_cuda.launches`` per launch.  The Gauss actor launches it once
per firing, so the host path is kept short: one combined check whose
diagnosis runs only on a refusal, and PyTorch's raw current stream.
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


def _refuse(frames: torch.Tensor) -> None:
    """Raise the ValueError that names what the kernel does not take."""
    if not frames.is_cuda:
        raise ValueError(f"gauss5x5_cuda: frames must be a CUDA tensor, got "
                         f"{frames.device}")
    if (frames.dtype not in (torch.float32, torch.uint8)
            or frames.dim() not in (2, 3) or not frames.is_contiguous()):
        raise ValueError(f"gauss5x5_cuda: frames must be contiguous float32 or "
                         f"uint8 (H, W) or (N, H, W), got {frames.dtype} "
                         f"{tuple(frames.shape)} strides {frames.stride()}")
    raise ValueError(f"gauss5x5_cuda: shape {tuple(frames.shape)} outside "
                     f"1..{MAX_FRAMES} frames of at least 1 x 1")


def gauss5x5_cuda(frames: torch.Tensor) -> torch.Tensor:
    """One launch over ``frames``: a contiguous (H, W) or (N, H, W) CUDA
    tensor, float32 (blurred float32 out) or uint8 (blurred and rounded
    uint8 out).  Returns a new tensor of the same shape and type."""
    shape = frames.shape
    dtype = frames.dtype
    n = shape[0] if len(shape) == 3 else 1
    if not (frames.is_cuda and (dtype == torch.uint8 or dtype == torch.float32)
            and 2 <= len(shape) <= 3 and 1 <= n <= MAX_FRAMES
            and shape[-2] >= 1 and shape[-1] >= 1 and frames.is_contiguous()):
        _refuse(frames)
    out = torch.empty_like(frames)
    lib = _library()
    err = lib.gauss5x5_run(frames.data_ptr(), out.data_ptr(), n, shape[-2], shape[-1],
                           dtype == torch.uint8,
                           torch._C._cuda_getCurrentRawStream(frames.device.index))
    if err != 0:
        raise RuntimeError(f"gauss5x5 launch failed: CUDA error {err} "
                           f"({lib.gauss5x5_error_string(err).decode()})")
    gauss5x5_cuda.launches += 1
    return out


#: Launches of the kernel since the count was last set to 0.
gauss5x5_cuda.launches = 0
