"""Carry network state between the port and numpy.

A state flattens to a list of numpy arrays in the JAX reference's pytree
leaf order — per channel ``buf, rd, wr, occ``, then each actor's state
depth first (rings, cursors, per-Poly ``(hist, taps)``, source and sink
slabs with their indices, the configuration index) — so the reference's
``jax.tree.leaves(state)``, converted to numpy, and :func:`state_to_numpy`
of the port line up one to one.  Host ints flatten to 0-d int32 arrays, as
the reference's int32 scalars do.

The LM's weights and serving state cross too: :func:`lm_params_from_numpy`
turns the JAX package's ``init_params`` pytree (as numpy arrays) into an
:class:`~repro_torch.models.LM` state dict (the whisper encoder's blocks,
stacked on a leading axis there, become ``encoder.blocks.<j>``), and
:func:`serve_state_from_numpy` / :func:`serve_state_to_numpy` carry the
serving caches between the JAX package's grouped layout
(``{"groups": {"c<i>": leaves stacked over groups}, "rest": (...)}``) and
the port's list of one dict per layer (nested for the whisper decoder's
``{"kv", "cross"}``; the int8 cache's scales are leaves like the rest).
bf16 arrays reach numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses; they cross as their 16-bit patterns.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.network import Network, NetworkState
from repro_torch.models.lm import layer_plan


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


# ---------------------------------------------------------------------- #
# LM weights and serving state.
# ---------------------------------------------------------------------- #
def tensor_from_numpy(arr: Any, device=None) -> torch.Tensor:
    """A numpy array as a tensor of the same type, bf16 included."""
    arr = np.array(arr)   # a writable copy that the tensor owns
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 becomes ``ml_dtypes.bfloat16`` (the type the
    JAX package's arrays have in numpy)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _flatten(tree: Mapping, prefix: str, out: Dict[str, Any]) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = v


def lm_params_from_numpy(cfg: ArchConfig, params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's LM params of ``cfg`` (a pytree of numpy arrays) as
    the port's ``LM`` state dict (CPU tensors; ``load_state_dict`` copies
    them to the model's device).  Group-stacked leaves are split into the
    port's per-layer blocks: layer ``g * len(cycle) + i`` is group ``g``'s
    ``c<i>``, the remainder follows."""
    cycle, n_groups, rest = layer_plan(cfg)
    flat: Dict[str, Any] = {}
    _flatten({k: v for k, v in params.items() if k not in ("groups", "rest", "encoder")},
             "", flat)

    def unstack(tree: Mapping, n: int, name_of) -> None:
        block: Dict[str, Any] = {}
        _flatten(tree, "", block)
        for g in range(n):
            for name, leaf in block.items():
                flat[f"{name_of(g)}.{name}"] = np.asarray(leaf)[g]

    for i in range(len(cycle)):
        unstack(params["groups"][f"c{i}"], n_groups,
                lambda g, i=i: f"layers.{g * len(cycle) + i}")
    if "encoder" in params:
        unstack(params["encoder"]["blocks"], cfg.encoder.n_layers,
                lambda j: f"encoder.blocks.{j}")
        _flatten(params["encoder"]["norm"], "encoder.norm.", flat)
    for j, bp in enumerate(params["rest"]):
        _flatten(bp, f"layers.{n_groups * len(cycle) + j}.", flat)
    return {k: tensor_from_numpy(v) for k, v in flat.items()}


def moe_params_from_numpy(params: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """One MoE layer's params (``moe_init``'s: ``router``, ``we_gate``,
    ``we_up``, ``we_down``, numpy arrays) as bf16 tensors on ``device``."""
    return {k: tensor_from_numpy(np.asarray(params[k]), device)
            for k in ("router", "we_gate", "we_up", "we_down")}


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees: Sequence[Any]) -> Any:
    """Per-layer states (nested dicts of tensors) stacked leaf by leaf into
    numpy arrays with a leading layer axis."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([tensor_to_numpy(t) for t in trees])


def serve_state_from_numpy(cfg: ArchConfig, caches: Mapping, device=None
                           ) -> List[Dict[str, Any]]:
    """The JAX package's serving state (grouped as its ``serve_state`` and
    ``prefill`` group it, as numpy arrays) as the port's list of one dict
    per layer, on ``device``."""
    cycle, n_groups, rest = layer_plan(cfg)
    layers: List[Dict[str, Any]] = []
    for g in range(n_groups):
        for i in range(len(cycle)):
            layers.append(_tree_map(lambda v: tensor_from_numpy(np.asarray(v)[g], device),
                                    caches["groups"][f"c{i}"]))
    for c in caches["rest"]:
        layers.append(_tree_map(lambda v: tensor_from_numpy(v, device), c))
    return layers


def serve_state_to_numpy(cfg: ArchConfig, layers: Sequence[Mapping[str, Any]]
                         ) -> Dict[str, Any]:
    """The port's per-layer serving state in the JAX package's grouped
    layout, as numpy arrays (the inverse of :func:`serve_state_from_numpy`)."""
    cycle, n_groups, rest = layer_plan(cfg)
    groups = {}
    for i in range(len(cycle)):
        per = [layers[g * len(cycle) + i] for g in range(n_groups)]
        groups[f"c{i}"] = _stack(per) if per else {}
    tail = layers[n_groups * len(cycle):]
    return {"groups": groups, "rest": tuple(_tree_map(tensor_to_numpy, c) for c in tail)}


def opt_state_from_numpy(cfg: ArchConfig, opt: Mapping) -> Dict[str, Any]:
    """The JAX package's AdamW state of ``cfg`` (``init_opt_state``'s tree
    as numpy arrays: ``m``, ``v``, ``count`` and an optional ``feedback``)
    as the port's: each moment tree through :func:`lm_params_from_numpy`,
    ``count`` a 0-d int32 tensor (CPU tensors)."""
    out: Dict[str, Any] = {k: lm_params_from_numpy(cfg, opt[k])
                           for k in ("m", "v", "feedback") if k in opt}
    out["count"] = torch.tensor(np.asarray(opt["count"]), dtype=torch.int32)
    return out
