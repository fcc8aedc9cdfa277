"""Plain PyTorch versions of the RG-LRU recurrence h_t = exp(log_a_t)
h_{t-1} + gx_t from h_0 = 0.

:func:`rglru_ref` (B7's oracle and CPU path) is the step-by-step
recurrence of the JAX package's ``rglru_naive``, which is also the TPU
kernel's own order (exp, product, sum).  :func:`rglru_scan` is the JAX
package's ``rglru_scan``, the log-space associative scan its models run at
``kernel_impl="xla"``: a Hillis-Steele scan in log L whole-tensor steps,
which autograd differentiates without a graph node per step.  Its sums run
in another order than ``lax.associative_scan``'s, so the two agree within
float32 rounding, not bit for bit."""
from __future__ import annotations

from typing import Tuple

import torch


def rglru_ref(log_a: torch.Tensor, gx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, gx: (B, L, W) float32 -> (h_seq (B, L, W), hT (B, W)), from
    h_0 = 0."""
    B, L, W = gx.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=gx.device)
    a = torch.exp(log_a)
    hs = torch.empty_like(gx)
    for t in range(L):
        h = a[:, t] * h + gx[:, t]
        hs[:, t] = h
    return hs, h


def rglru_scan(log_a: torch.Tensor, gx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same recurrence as an inclusive scan of the pairs (a, b), each
    the map h -> exp(a) h + b, composed as (a1, b1) then (a2, b2) ->
    (a1 + a2, exp(a2) b1 + b2).  Returns (h_seq, hT)."""
    a, b = log_a, gx
    L = a.shape[1]
    off = 1
    while off < L:
        b = torch.cat([b[:, :off], torch.exp(a[:, off:]) * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] + a[:, :-off]], dim=1)
        off *= 2
    return b, b[:, -1]
