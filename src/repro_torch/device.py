"""Device resolution for the port's entry points.

Every entry point (``build_dpd``, ``make_dpd``, ``NetworkBuilder.build``,
``Network``) takes ``device=None`` and runs on the CUDA card unless the
caller names another device.  With no device given and no card present it
raises: the port never carries on silently on the CPU.  Tests ask for the
CPU explicitly with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means the CUDA card; it raises when none is visible.  An
    explicit CUDA device also raises when no card is visible.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on the card by "
                "default and never falls back to the CPU — pass "
                "device='cpu' to run the plain PyTorch path explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "visible")
    return dev
