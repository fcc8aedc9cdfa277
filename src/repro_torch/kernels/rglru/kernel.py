"""ctypes wrapper of the Hopper RG-LRU kernel (``csrc/rglru.cu``: one
block per (batch, 32-channel tile), a producer warp streaming TMA or
cp.async loads into a three-stage ring, a consumer warp walking time in
order).

Replaces ``src/repro/kernels/rglru/kernel.py::rglru_pallas``.  The library
is built and loaded at the first launch, never at import.
:func:`rglru_cuda` checks its operands, launches on PyTorch's current
stream without synchronising, raises on a refused launch, and adds one to
``rglru_cuda.launches`` per launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("rglru")
    lib.rglru_run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rglru_run.restype = ctypes.c_int
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def rglru_cuda(log_a: torch.Tensor, gx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch: ``log_a``, ``gx`` contiguous (B, L, W) float32 CUDA
    tensors, B <= 65535 -> ``(h_seq (B, L, W), hT (B, W))`` float32.  Any
    L and W: the kernel moves its tiles by TMA when W is a multiple of 4
    and the operands are 16-byte aligned, else by cp.async."""
    for name, t in (("log_a", log_a), ("gx", gx)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 \
                or not t.is_contiguous():
            raise ValueError(f"rglru_cuda: {name} must be a contiguous (B, L, W) "
                             f"float32 CUDA tensor, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if log_a.shape != gx.shape or log_a.device != gx.device:
        raise ValueError(f"rglru_cuda: log_a {tuple(log_a.shape)} on {log_a.device} "
                         f"and gx {tuple(gx.shape)} on {gx.device} differ")
    B, L, W = gx.shape
    if B > 65535 or min(B, L, W) < 1:
        raise ValueError(f"rglru_cuda: shape {(B, L, W)} outside 1..65535 batches")
    h_seq = torch.empty_like(gx)
    h_last = torch.empty((B, W), dtype=torch.float32, device=gx.device)
    lib = _library()
    err = lib.rglru_run(log_a.data_ptr(), gx.data_ptr(), h_seq.data_ptr(),
                        h_last.data_ptr(), B, L, W,
                        torch.cuda.current_stream(gx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru launch failed: CUDA error {err} "
                           f"({lib.rglru_error_string(err).decode()})")
    rglru_cuda.launches += 1
    return h_seq, h_last


#: Launches of the kernel since the count was last set to 0.
rglru_cuda.launches = 0
