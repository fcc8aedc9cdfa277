"""PyTorch/CUDA port of the dynamic-data-rate actor network runtime.

Laid out like the JAX package ``repro`` (the reference it is checked
against) and importing nothing of it: ``core`` holds the model of
computation (Eq. 1 FIFOs, actors, networks, the builder, the host
executors, ``Program``), ``kernels`` the hand-written Hopper kernels with
their plain PyTorch versions, ``graphs`` the paper's applications, and
``configs``, ``models``, ``serve`` and ``launch`` the LM serving stack.
Entry points run on the CUDA card unless the caller passes ``device=``
(see :mod:`repro_torch.device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
