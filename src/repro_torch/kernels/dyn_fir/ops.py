"""Entry points of the DPD branch: the Hopper kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.  There is no fallback: a CUDA
operand launches the kernel or raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._entry import kernel_route
from repro_torch.kernels.dyn_fir.kernel import dpd_branch_cuda
from repro_torch.kernels.dyn_fir.ref import N_TAPS, branch_ref, poly_ref


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
               h_im: torch.Tensor, order: int, *, impl: Optional[str] = None,
               block: int = 1024, interpret: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Poly actor's computation (the reference kernel's signature):
    ``(..., L + 9)`` streams whose first 9 samples are the history, taps
    ``(10,)``; returns ``(y_re, y_im)``, each ``(..., L)`` float32.

    Operands of every float type are cast to float32 at the entry, on the
    CPU and on the card alike, and the answer is the reference's for those
    float32 values.  float64 is what the reference's 32-bit JAX casts too.
    A bf16 or f16 stream departs from the reference, which computes its
    basis in the stream's own type.  The result then differs from the
    reference's by that basis's rounding, and f16 does not overflow where
    the reference's f16 basis does.  The card's kernel computes orders
    1..10: there each row of the leading dims launches it once.  Orders
    outside 1..10 run the plain version on the card.  That is the entry's
    rule, not a fallback on a refused launch.

    ``impl`` as ``kernels._entry`` sets out (the reference's default is
    ``"xla"``; B1 is bit-identical to the plain version, so either default
    gives the same function).  At ``impl="pallas"``, ``block`` is checked
    as the reference's kernel checks it (L a multiple of it); the port's
    kernel picks its own tiles, so the answer does not depend on it.
    ``interpret`` has no effect."""
    x_re, x_im, h_re, h_im = (t.to(torch.float32) for t in (x_re, x_im, h_re, h_im))
    L = x_re.shape[-1] - (N_TAPS - 1)
    if impl == "pallas" and L % block:
        raise ValueError(f"L={L} not divisible by block={block}")
    use_kernel = kernel_route("dpd_branch", impl, interpret, (x_re, x_im, h_re, h_im))
    if not (use_kernel and 1 <= order <= N_TAPS):
        return branch_ref(x_re, x_im, h_re, h_im, order)
    lead = x_re.shape[:-1]
    x = torch.stack([x_re.reshape(-1, L + N_TAPS - 1), x_im.reshape(-1, L + N_TAPS - 1)])
    taps = torch.stack([h_re, h_im])
    ys = [poly_branch(x[:, r, :N_TAPS - 1], x[:, r, N_TAPS - 1:], taps, order)[0]
          for r in range(x.shape[1])]
    y = torch.stack(ys, dim=1) if ys else x.new_empty((2, 0, L))
    return y[0].reshape(*lead, L), y[1].reshape(*lead, L)
