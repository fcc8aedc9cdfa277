"""ctypes wrapper of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``: ``flash_fwd_wgmma``, TMA loads into a
two-stage ring, a producer warpgroup and two wgmma consumer warpgroups).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
The library is built and loaded at the first launch, never at import.
:func:`flash_attention_cuda` checks its operands, launches on PyTorch's
current stream without synchronising, raises on a refused launch, and adds
one to ``flash_attention_cuda.launches`` per launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

#: Largest head dimension the kernel takes.
MAX_HEAD_DIM = 256


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_run.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_run.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """One launch: q (B, S, H, hd), k/v (B, S, Hkv, hd), contiguous bf16
    CUDA tensors on one device, H a multiple of Hkv, hd a multiple of 8 up
    to 256.  Returns the (B, S, H, hd) bf16 output."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 4 \
                or not t.is_contiguous() or t.data_ptr() % 16 or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be a contiguous, "
                             f"16-byte aligned bf16 (B, S, heads, hd) tensor on "
                             f"q's CUDA device, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, hd) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit GQA")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM or S < 1:
        raise ValueError(f"flash_attention_cuda: hd {hd} must be a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}, and S {S} at least 1")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window {window} must be positive")
    out = torch.empty_like(q)
    lib = _library()
    err = lib.flash_attention_run(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, Hkv, hd,
        int(causal), 0 if window is None else int(window), float(1.0 / (hd ** 0.5)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention_cuda.launches += 1
    return out


#: Launches of the kernel since the count was last set to 0.
flash_attention_cuda.launches = 0
