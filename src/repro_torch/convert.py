"""Carry network state between the port and numpy.

A state flattens to a list of numpy arrays in the JAX reference's pytree
leaf order — per channel ``buf, rd, wr, occ``, then each actor's state
depth first (rings, cursors, per-Poly ``(hist, taps)``, source and sink
slabs with their indices, the configuration index) — so the reference's
``jax.tree.leaves(state)``, converted to numpy, and :func:`state_to_numpy`
of the port line up one to one.  Host ints flatten to 0-d int32 arrays, as
the reference's int32 scalars do.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from repro_torch.core.network import Network, NetworkState


def state_to_numpy(state: NetworkState) -> List[np.ndarray]:
    """Every leaf of ``state`` as a numpy array, in reference leaf order."""
    out = []
    for leaf in state.leaves():
        if isinstance(leaf, torch.Tensor):
            out.append(leaf.detach().cpu().numpy().copy())
        else:
            out.append(np.asarray(leaf, np.int32))
    return out


def state_from_numpy(net: Network, leaves: Sequence[Any]) -> NetworkState:
    """The port's state of ``net`` holding ``leaves`` (numpy arrays in
    reference leaf order, e.g. a reference ``NetworkState`` flattened).

    Tensors land where :meth:`Network.init_state` puts them — data rings
    and actor tensors on the network's device, control rings in host
    memory — with the template's dtype; int leaves become host ints.
    Shapes and the leaf count must match the network exactly.
    """
    template = net.init_state()
    n = len(template.leaves())
    if len(leaves) != n:
        raise ValueError(f"state_from_numpy: {len(leaves)} leaves given, the "
                         f"network's state has {n}")
    it = iter(leaves)

    def convert(tmpl: Any) -> Any:
        arr = np.asarray(next(it))
        if isinstance(tmpl, torch.Tensor):
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"state_from_numpy: leaf shape {arr.shape} != "
                                 f"{tuple(tmpl.shape)}")
            return torch.tensor(arr, dtype=tmpl.dtype, device=tmpl.device)
        if arr.shape != ():
            raise ValueError(f"state_from_numpy: scalar leaf expected, got "
                             f"shape {arr.shape}")
        return int(arr)

    return template.map_leaves(convert)
