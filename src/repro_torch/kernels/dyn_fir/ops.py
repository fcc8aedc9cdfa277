"""Entry points of the DPD branch: the Hopper kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.  There is no fallback: a CUDA
operand launches the kernel or raises."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.dyn_fir.kernel import dpd_branch_cuda
from repro_torch.kernels.dyn_fir.ref import N_TAPS, poly_ref


def poly_branch(hist: torch.Tensor, win: torch.Tensor, taps: torch.Tensor,
                order: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Poly firing as the DPD graph calls it: ``hist`` ``(2, 9)``,
    ``win`` ``(2, L)`` and ``taps`` ``(2, 10)`` as (re, im) planes.  Returns
    the ``(2, L)`` output and the next history, the last 9 samples of
    ``hist ++ win``.  On the card one kernel launch computes both, with
    history and window reaching it through separate pointers."""
    if win.is_cuda:
        return dpd_branch_cuda(hist, win, taps, order)
    return poly_ref(hist, win, taps, order)


def dpd_branch(x_re: torch.Tensor, x_im: torch.Tensor, h_re: torch.Tensor,
               h_im: torch.Tensor, order: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`poly_branch` on a ``(L + 9,)`` stream whose first 9 samples
    are the history (the reference kernel's signature); returns
    ``(y_re, y_im)``, each ``(L,)``."""
    x = torch.stack([x_re, x_im])
    y, _ = poly_branch(x[:, :N_TAPS - 1], x[:, N_TAPS - 1:],
                       torch.stack([h_re, h_im]), order)
    return y[0], y[1]
