"""Plain PyTorch version of the DPD Poly branch (paper §4.2).

A branch of order k computes the basis ``phi_k(x) = x * |x|^(2(k-1))``
followed by a causal 10-tap complex FIR.  Complex samples are (re, im)
float32 planes.  This is the oracle of the Hopper kernel in
``kernel.py`` and the path every CPU tensor takes; the operation order is
the JAX reference's, so the two agree to float32 rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch

N_TAPS = 10
N_BRANCHES = 10


def basis_ref(x_re: torch.Tensor, x_im: torch.Tensor, order: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """phi_k(x) = x * |x|^(2(k-1)); order k >= 1."""
    mag2 = x_re * x_re + x_im * x_im
    scale = mag2 ** (order - 1)
    return x_re * scale, x_im * scale


def fir_ref(x_re: torch.Tensor, x_im: torch.Tensor,
            h_re: torch.Tensor, h_im: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal complex FIR. x: (..., L + N_TAPS - 1) with history prefix;
    h: (N_TAPS,). Returns (..., L): y[n] = sum_t h[t] * x[n + T-1 - t]."""
    L = x_re.shape[-1] - (N_TAPS - 1)
    y_re = torch.zeros(x_re.shape[:-1] + (L,), dtype=torch.float32,
                       device=x_re.device)
    y_im = torch.zeros_like(y_re)
    for t in range(N_TAPS):
        xr = x_re[..., N_TAPS - 1 - t: N_TAPS - 1 - t + L]
        xi = x_im[..., N_TAPS - 1 - t: N_TAPS - 1 - t + L]
        y_re = y_re + h_re[t] * xr - h_im[t] * xi
        y_im = y_im + h_re[t] * xi + h_im[t] * xr
    return y_re, y_im


def branch_ref(x_re, x_im, h_re, h_im, order: int):
    """One Poly actor: basis then FIR."""
    b_re, b_im = basis_ref(x_re, x_im, order)
    return fir_ref(b_re, b_im, h_re, h_im)


def poly_ref(hist: torch.Tensor, win: torch.Tensor, taps: torch.Tensor,
             order: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Poly firing on (re, im) planes: ``hist`` ``(2, 9)``, ``win``
    ``(2, L)``, ``taps`` ``(2, 10)``.  Returns the ``(2, L)`` output and the
    next history, the last 9 samples of ``hist ++ win``."""
    x = torch.cat([hist, win], dim=1)
    y = torch.stack(branch_ref(x[0], x[1], taps[0], taps[1], order))
    return y, x[:, -(N_TAPS - 1):].clone()
