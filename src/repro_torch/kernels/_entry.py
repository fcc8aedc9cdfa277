"""The rules every kernel entry shares: the reference's ``impl`` and
``interpret`` keywords, and the guard that refuses a kernel under autograd.

``impl`` picks the route:

* ``None`` (the port's default) is the device rule: the kernel on a CUDA
  operand, the plain version on a CPU one.  The models and graphs call
  with it.
* ``"xla"`` runs the plain version on the operand's device, the card
  included.  Training differentiates this route, as the reference trains
  with ``kernel_impl="xla"``.
* ``"pallas"`` launches the kernel on a CUDA operand; a CPU operand takes
  the port's CPU path, the plain version.
* ``"flash_scan"`` names one of attention's plain routes (the models'
  ``attention`` takes it before it reaches B5's entry); every other entry
  runs its plain version under it, as under ``"xla"``.

Any other value raises ``ValueError`` (the reference sends any value but
``"pallas"`` to XLA).  ``interpret`` is taken as a bool and has no effect:
the port has no interpreter.  The tiling keywords (``bq``/``bk``, ``chunk``,
``block_h``, ``block``) are checked as the reference's kernels check them
when ``impl="pallas"`` names the reference's kernel route; the port's
kernels pick their own tiles and take any shape, so under the device rule
they are not checked, and the answer never depends on them.

The kernels have no backward, and neither have the reference's Pallas
kernels.  Their outputs carry no ``grad_fn``, so a gradient through one
would silently count it as a constant.  So a kernel route (``None`` or
``"pallas"``) raises when grad mode is on and an operand requires grad.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

IMPLS = (None, "xla", "pallas", "flash_scan")


def kernel_route(entry: str, impl: Optional[str], interpret: bool,
                 operands: Sequence[torch.Tensor]) -> bool:
    """True when ``entry`` launches its kernel on ``operands``, False when
    it runs its plain version; raises on an unknown ``impl``, a
    non-bool ``interpret``, or a kernel route under autograd."""
    if impl not in IMPLS:
        raise ValueError(f"{entry}: impl {impl!r} is not one of {IMPLS}")
    if not isinstance(interpret, bool):
        raise ValueError(f"{entry}: interpret must be a bool, got {interpret!r}")
    if impl in ("xla", "flash_scan"):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise ValueError(
            f"{entry}: an operand requires grad, and the kernel has no backward "
            "(the reference's Pallas kernels have none either); differentiate "
            "the plain version: impl='xla', or kernel_impl='xla' in the models "
            "and the train step")
    return operands[0].is_cuda

