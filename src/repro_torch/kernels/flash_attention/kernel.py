"""ctypes wrapper of the Hopper flash-attention kernels
(``csrc/flash_attention.cu``): ``flash_fwd_wgmma`` for bf16 (TMA loads into
a two-stage ring, a producer warpgroup and two wgmma consumer warpgroups),
and ``flash_fwd_ffma`` for float32 and f16 (the same blocked online
softmax in float32 on the CUDA cores).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
The library is built and loaded at the first launch, never at import.
:func:`flash_attention_cuda` checks its operands, launches on PyTorch's
current stream without synchronising, raises on a refused launch, and adds
one to ``flash_attention_cuda.launches`` per launch, and to the route's
own count in ``flash_attention_cuda.route_launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

#: Largest head dimension the kernel takes.
MAX_HEAD_DIM = 256
#: ``flash_fwd_ffma``'s tiling (``FQ``, ``FN``, ``FR`` in the source): query
#: rows a block, keys a tile, query rows a warp.
FFMA_QUERY_ROWS, FFMA_KEYS, FFMA_WARP_ROWS = 64, 32, 8


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_run.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_run.restype = ctypes.c_int
    lib.flash_attention_ffma_run.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                             + [ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p])
    lib.flash_attention_ffma_run.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """One launch: q (B, S, H, hd), k/v (B, S, Hkv, hd), contiguous CUDA
    tensors of one type on one device, H a multiple of Hkv.  bf16 runs
    ``flash_fwd_wgmma`` (16-byte aligned, hd a multiple of 8 up to 256);
    float32 and f16 run ``flash_fwd_ffma`` (any hd up to 256).  Returns the
    (B, S, H, hd) output in q's type."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype not in ROUTES or t.dtype != q.dtype \
                or t.dim() != 4 or not t.is_contiguous() or t.device != q.device \
                or (q.dtype == torch.bfloat16 and t.data_ptr() % 16):
            raise ValueError(f"flash_attention_cuda: {name} must be a contiguous "
                             f"(B, S, heads, hd) tensor of q's type (bf16, 16-byte "
                             f"aligned; float32; f16) on q's CUDA device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, hd) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit GQA")
    route = ROUTES[q.dtype]
    if (route == "wgmma" and hd % 8) or not 0 < hd <= MAX_HEAD_DIM or S < 1:
        raise ValueError(f"flash_attention_cuda: hd {hd} must be at most "
                         f"{MAX_HEAD_DIM} (a multiple of 8 for bf16), and S {S} "
                         "at least 1")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window {window} must be positive")
    out = torch.empty_like(q)
    lib = _library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, Hkv, hd,
            int(causal), 0 if window is None else int(window), float(1.0 / (hd ** 0.5)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "wgmma":
        err = lib.flash_attention_run(*args, stream)
    else:
        err = lib.flash_attention_ffma_run(*args, int(q.dtype == torch.float16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[route] += 1
    return out


#: The kernel each input type runs.
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "ffma", torch.float16: "ffma"}

#: Launches of the kernels since the count was last set to 0, in all and by
#: route.
flash_attention_cuda.launches = 0
flash_attention_cuda.route_launches = {"wgmma": 0, "ffma": 0}
