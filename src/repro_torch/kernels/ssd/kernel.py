"""ctypes wrapper of the Hopper SSD kernels (``csrc/ssd.cu``).

Replaces ``src/repro/kernels/ssd/kernel.py::ssd_pallas``.  The library is
built and loaded at the first launch, never at import.  :func:`ssd_cuda`
checks its operands, allocates the chunk-state scratch, launches the three
kernels of one scan (chunk states, state passing, chunk outputs) on
PyTorch's current stream without synchronising, raises on a refused
launch, and adds one to ``ssd_cuda.launches`` per scan and to the route's
count in ``ssd_cuda.route_launches``.  mamba2's (P, N) = (64, 128) takes
the tensor-core route (bf16 or float32 inputs); every other (P, N) the
float32 SIMT route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: The (head_dim, state_dim) the kernel is built for (mamba2's).
HEAD_DIM, STATE_DIM = 64, 128
#: The kernels' own chunk length (``Q`` in ``csrc/ssd.cu``); it changes
#: only rounding, and sizes the scratch.
CHUNK = 256


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("ssd")
    lib.ssd_run.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.ssd_run.restype = ctypes.c_int
    lib.ssd_run_simt.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.ssd_run_simt.restype = ctypes.c_int
    lib.ssd_chunk_len.restype = ctypes.c_int
    if lib.ssd_chunk_len() != CHUNK:
        raise RuntimeError(f"ssd.cu's chunk {lib.ssd_chunk_len()} != CHUNK {CHUNK}")
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scan, ``kernels_per_call`` launches: x (B, L, H, P), B_/C_
    (B, L, N) contiguous, dt (B, L, H) and A (H,) float32, all on one CUDA
    device.  At (P, N) = (64, 128) x, B_, C_ are all bf16 or all float32
    and 16-byte aligned (the tensor-core route); at any other (P, N) they
    are float32 (the SIMT route).  Returns (y (B, L, H, P) in x's type, hT
    (B, H, P, N) float32).  The kernels use their own chunk length,
    ``CHUNK``, which changes only rounding."""
    Bsz, L, H, P = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    N = B_.shape[-1] if B_.dim() == 3 else 0
    tensor_cores = (P, N) == (HEAD_DIM, STATE_DIM)
    if not tensor_cores:
        return _ssd_simt(x, dt, A, B_, C_)
    want = {"x": (x, x.dtype, (Bsz, L, H, HEAD_DIM)),
            "dt": (dt, torch.float32, (Bsz, L, H)),
            "A": (A, torch.float32, (H,)),
            "B_": (B_, x.dtype, (Bsz, L, STATE_DIM)),
            "C_": (C_, x.dtype, (Bsz, L, STATE_DIM))}
    for name, (t, dtype, shape) in want.items():
        if not t.is_cuda or t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous() \
                or (name in ("x", "B_", "C_") and t.data_ptr() % 16):
            raise ValueError(f"ssd_cuda: {name} must be a contiguous {dtype} {shape} "
                             f"tensor on x's CUDA device (x, B_, C_ 16-byte aligned), "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or min(Bsz, L, H) < 1 \
            or Bsz > 65535:
        raise ValueError(f"ssd_cuda: x {x.dtype} {tuple(x.shape)}: bf16 or float32, "
                         "at most 65535 batches")
    y = torch.empty_like(x)
    h_last = torch.empty((Bsz, H, HEAD_DIM, STATE_DIM), dtype=torch.float32,
                         device=x.device)
    nc = -(-L // CHUNK)
    # Each chunk's own state, and the state entering it as bf16 hi and lo.
    states = torch.empty((Bsz, nc, H, HEAD_DIM, STATE_DIM), dtype=torch.float32,
                         device=x.device)
    entering = torch.empty((Bsz, nc, H, 2, HEAD_DIM, STATE_DIM), dtype=torch.bfloat16,
                           device=x.device)
    totals = torch.empty((Bsz, nc, H), dtype=torch.float32, device=x.device)
    lib = _library()
    err = lib.ssd_run(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                      C_.data_ptr(), y.data_ptr(), h_last.data_ptr(), states.data_ptr(),
                      entering.data_ptr(), totals.data_ptr(), Bsz, L, H,
                      int(x.dtype == torch.bfloat16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    ssd_cuda.launches += 1
    ssd_cuda.route_launches["tensor_cores"] += 1
    return y, h_last


def _ssd_simt(x, dt, A, B_, C_) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SIMT route (any P, N >= 1), float32 operands."""
    Bsz, L, H, P = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    N = B_.shape[-1] if B_.dim() == 3 else 0
    want = {"x": (x, (Bsz, L, H, P)), "dt": (dt, (Bsz, L, H)), "A": (A, (H,)),
            "B_": (B_, (Bsz, L, N)), "C_": (C_, (Bsz, L, N))}
    for name, (t, shape) in want.items():
        if not t.is_cuda or t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"ssd_cuda: {name} must be a contiguous float32 {shape} "
                             f"tensor on x's CUDA device (the SIMT route, (P, N) = "
                             f"({P}, {N})), got {t.dtype} {tuple(t.shape)} on {t.device}")
    if min(Bsz, L, H, P, N) < 1 or Bsz > 65535 or H > 65535:
        raise ValueError(f"ssd_cuda: x {tuple(x.shape)}, N {N}: every size at least 1, "
                         "at most 65535 batches and heads")
    nc = -(-L // CHUNK)
    y = torch.empty_like(x)
    h_last = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32, device=x.device)
    entering = torch.empty_like(states)
    totals = torch.empty((Bsz, nc, H), dtype=torch.float32, device=x.device)
    lib = _library()
    err = lib.ssd_run_simt(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                           C_.data_ptr(), y.data_ptr(), h_last.data_ptr(), states.data_ptr(),
                           entering.data_ptr(), totals.data_ptr(), Bsz, L, H, P, N,
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    ssd_cuda.launches += 1
    ssd_cuda.route_launches["simt"] += 1
    return y, h_last


#: Scans launched since the count was last set to 0 (one per call), in all
#: and by route.
ssd_cuda.launches = 0
ssd_cuda.route_launches = {"tensor_cores": 0, "simt": 0}
#: CUDA kernels launched per call.
ssd_cuda.kernels_per_call = 3
