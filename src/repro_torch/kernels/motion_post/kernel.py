"""ctypes wrapper of the Hopper Thres + Med kernel (``csrc/motion_post.cu``).

Replaces ``src/repro/kernels/motion_post/kernel.py::motion_post_pallas``.
The library is built and loaded at the first launch, never at import.
:func:`motion_post_cuda` checks its operands, launches on PyTorch's current
stream without synchronising, raises on a refused launch, and adds one to
``motion_post_cuda.launches`` per launch.  The host path is kept short: one
combined check whose diagnosis runs only on a refusal, and PyTorch's raw
current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gauss5x5.kernel import MAX_FRAMES


@functools.lru_cache(maxsize=None)
def _library(defines: tuple = ()) -> ctypes.CDLL:
    """The built library (with the ``-D`` flags ``defines``: ``chip_smoke.py
    --b4`` builds other row counts R so) with its C signatures declared
    (once)."""
    lib = _build.load("motion_post", defines)
    fn = lib.motion_post_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.motion_post_error_string.argtypes = [ctypes.c_int]
    lib.motion_post_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(cur: torch.Tensor, prev: torch.Tensor) -> None:
    """Raise the ValueError that names what the kernel does not take."""
    for t, what in ((cur, "cur"), (prev, "prev")):
        if not t.is_cuda:
            raise ValueError(f"motion_post_cuda: {what} must be a CUDA tensor, "
                             f"got {t.device}")
        if (t.dtype not in (torch.float32, torch.uint8) or t.dim() not in (2, 3)
                or not t.is_contiguous()):
            raise ValueError(f"motion_post_cuda: {what} must be contiguous "
                             f"float32 or uint8 (H, W) or (N, H, W), got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if cur.shape != prev.shape or cur.dtype != prev.dtype or cur.device != prev.device:
        raise ValueError(f"motion_post_cuda: cur {cur.dtype} {tuple(cur.shape)} on "
                         f"{cur.device} and prev {prev.dtype} {tuple(prev.shape)} "
                         f"on {prev.device} differ")
    raise ValueError(f"motion_post_cuda: shape {tuple(cur.shape)} outside "
                     f"1..{MAX_FRAMES} frames of at least 1 x 1")


def motion_post_cuda(cur: torch.Tensor, prev: torch.Tensor,
                     threshold: float) -> torch.Tensor:
    """One launch over a pair of contiguous (H, W) or (N, H, W) CUDA tensors
    of one shape, dtype (float32 or uint8) and device; returns the new
    float32 motion map of that shape."""
    shape = cur.shape
    dtype = cur.dtype
    n = shape[0] if len(shape) == 3 else 1
    if not (cur.is_cuda and (dtype == torch.uint8 or dtype == torch.float32)
            and prev.dtype == dtype and prev.shape == shape
            and prev.device == cur.device and 2 <= len(shape) <= 3
            and 1 <= n <= MAX_FRAMES and shape[-2] >= 1 and shape[-1] >= 1
            and cur.is_contiguous() and prev.is_contiguous()):
        _refuse(cur, prev)
    out = torch.empty_like(cur, dtype=torch.float32)
    lib = _library()
    err = lib.motion_post_run(cur.data_ptr(), prev.data_ptr(), out.data_ptr(), n,
                              shape[-2], shape[-1], dtype == torch.uint8,
                              float(threshold),
                              torch._C._cuda_getCurrentRawStream(cur.get_device()))
    if err != 0:
        raise RuntimeError(f"motion_post launch failed: CUDA error {err} "
                           f"({lib.motion_post_error_string(err).decode()})")
    motion_post_cuda.launches += 1
    return out


#: Launches of the kernel since the count was last set to 0.
motion_post_cuda.launches = 0
