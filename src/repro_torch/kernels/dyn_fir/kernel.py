"""ctypes wrapper of the Hopper Poly kernel (``csrc/dyn_fir.cu``).

Replaces ``src/repro/kernels/dyn_fir/kernel.py::dpd_branch_pallas``.  The
library is built and loaded at the first launch, never at import.
:func:`dpd_branch_cuda` checks its operands, launches on PyTorch's current
stream without synchronising, raises on a refused launch, and adds one to
``dpd_branch_cuda.launches`` per launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dyn_fir.ref import N_TAPS


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("dyn_fir")
    fn = lib.dyn_fir_branch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dyn_fir_error_string.argtypes = [ctypes.c_int]
    lib.dyn_fir_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, what: str, n: int) -> None:
    """``t`` is a CUDA float32 ``(2, n)`` pair of planes, each contiguous."""
    if not t.is_cuda:
        raise ValueError(f"dpd_branch_cuda: {what} must be a CUDA tensor, got {t.device}")
    if (t.dtype != torch.float32 or tuple(t.shape) != (2, n)
            or (n > 1 and t.stride(1) != 1)):
        raise ValueError(f"dpd_branch_cuda: {what} must be float32 (2, {n}) with "
                         f"contiguous rows, got {t.dtype} {tuple(t.shape)} "
                         f"strides {t.stride()}")


def dpd_branch_cuda(hist: torch.Tensor, win: torch.Tensor, taps: torch.Tensor,
                    order: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Poly firing on the card.

    ``hist`` ``(2, 9)``: the history; ``win`` ``(2, L)``: the window;
    ``taps`` ``(2, 10)``; each a (re, im) pair of contiguous float32 rows
    on one CUDA device, ``order`` in 1..10.  Returns the ``(2, L)`` output
    and the next ``(2, 9)`` history (the last 9 samples of hist ++ win),
    both newly allocated.
    """
    L = win.shape[-1]
    for t, what, n in ((hist, "hist", N_TAPS - 1), (win, "win", L),
                       (taps, "taps", N_TAPS)):
        _check(t, what, n)
    if L < 1:
        raise ValueError("dpd_branch_cuda: the window is empty")
    if not 1 <= order <= N_TAPS:
        raise ValueError(f"dpd_branch_cuda: order must be in 1..{N_TAPS}, got {order}")
    devices = {t.device for t in (hist, win, taps)}
    if len(devices) != 1:
        raise ValueError(f"dpd_branch_cuda: operands span devices {devices}")
    y = torch.empty((2, L), dtype=torch.float32, device=win.device)
    next_hist = torch.empty((2, N_TAPS - 1), dtype=torch.float32, device=win.device)
    lib = _library()
    stream = torch.cuda.current_stream(win.device).cuda_stream
    err = lib.dyn_fir_branch(
        hist[0].data_ptr(), hist[1].data_ptr(), win[0].data_ptr(),
        win[1].data_ptr(), taps[0].data_ptr(), taps[1].data_ptr(),
        y[0].data_ptr(), y[1].data_ptr(), next_hist[0].data_ptr(),
        next_hist[1].data_ptr(), L, order, stream)
    if err != 0:
        raise RuntimeError(
            f"dyn_fir_branch launch failed: CUDA error {err} "
            f"({lib.dyn_fir_error_string(err).decode()})")
    dpd_branch_cuda.launches += 1
    return y, next_hist


#: Launches of the kernel since the count was last set to 0.
dpd_branch_cuda.launches = 0
