"""ctypes wrapper of the Hopper Poly kernel (``csrc/dyn_fir.cu``).

Replaces ``src/repro/kernels/dyn_fir/kernel.py::dpd_branch_pallas``.  The
library is built and loaded at the first launch, never at import.
:func:`dpd_branch_cuda` checks its operands, launches on PyTorch's current
stream without synchronising, raises on a refused launch, and adds one to
``dpd_branch_cuda.launches`` per launch.

The DPD graph launches it once per Poly firing (398 times in a full-width
dynamic run), so the host path is kept short: one combined check whose
diagnosis runs only on a refusal, plane pointers from each operand's base
pointer and row stride (no views), and PyTorch's raw current stream.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dyn_fir.ref import N_TAPS

_HIST = (2, N_TAPS - 1)
_TAPS = (2, N_TAPS)
_F32 = torch.float32


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("dyn_fir")
    fn = lib.dyn_fir_branch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dyn_fir_error_string.argtypes = [ctypes.c_int]
    lib.dyn_fir_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(hist: torch.Tensor, win: torch.Tensor, taps: torch.Tensor,
            order: int) -> None:
    """Raise the ValueError that names what the kernel does not take."""
    L = win.shape[-1]
    for t, what, n in ((hist, "hist", N_TAPS - 1), (win, "win", L),
                       (taps, "taps", N_TAPS)):
        if not t.is_cuda:
            raise ValueError(f"dpd_branch_cuda: {what} must be a CUDA tensor, got {t.device}")
        if (t.dtype != torch.float32 or tuple(t.shape) != (2, n)
                or (n > 1 and t.stride(1) != 1)):
            raise ValueError(f"dpd_branch_cuda: {what} must be float32 (2, {n}) with "
                             f"contiguous rows, got {t.dtype} {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if L < 1:
        raise ValueError("dpd_branch_cuda: the window is empty")
    if not 1 <= order <= N_TAPS:
        raise ValueError(f"dpd_branch_cuda: order must be in 1..{N_TAPS}, got {order}")
    devices = {t.device for t in (hist, win, taps)}
    raise ValueError(f"dpd_branch_cuda: operands span devices {devices}")


def dpd_branch_cuda(hist: torch.Tensor, win: torch.Tensor, taps: torch.Tensor,
                    order: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Poly firing on the card.

    ``hist`` ``(2, 9)``: the history; ``win`` ``(2, L)``: the window;
    ``taps`` ``(2, 10)``; each a (re, im) pair of contiguous float32 rows
    on one CUDA device, ``order`` in 1..10.  Returns the ``(2, L)`` output
    and the next ``(2, 9)`` history (the last 9 samples of hist ++ win),
    both newly allocated.
    """
    shape = win.shape
    L = shape[-1]
    ws, hs, ts = win.stride(), hist.stride(), taps.stride()
    dev = win.device
    if not (win.is_cuda and len(shape) == 2 and shape[0] == 2 and L >= 1
            and hist.shape == _HIST and taps.shape == _TAPS
            and win.dtype is _F32 and hist.dtype is _F32 and taps.dtype is _F32
            and (ws[1] == 1 or L == 1) and hs[1] == 1 and ts[1] == 1
            and hist.device == dev and taps.device == dev and 1 <= order <= N_TAPS):
        _refuse(hist, win, taps, order)
    # Both come out contiguous: an operand that passed the check is either
    # dense with unit row stride (whose layout empty_like keeps) or not
    # dense (and empty_like is contiguous).
    y = torch.empty_like(win)
    next_hist = torch.empty_like(hist)
    lib = _library()
    err = lib.dyn_fir_branch(
        hist.data_ptr(), hs[0], win.data_ptr(), ws[0], taps.data_ptr(), ts[0],
        y.data_ptr(), next_hist.data_ptr(),
        L, order, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(
            f"dyn_fir_branch launch failed: CUDA error {err} "
            f"({lib.dyn_fir_error_string(err).decode()})")
    dpd_branch_cuda.launches += 1
    return y, next_hist


#: Launches of the kernel since the count was last set to 0.
dpd_branch_cuda.launches = 0
