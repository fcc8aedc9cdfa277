"""Shared paper-graph factories with reproducible staged data; every
factory returns ``(network, n_iterations)``."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.network import Network, NetworkState
from repro_torch.device import DeviceLike

#: Active-filter counts exercising rate-0 firings on most branches
#: (2..10 active of 10) — the equivalence suites' DPD schedule.
DPD_SCHEDULE = np.array([2, 10, 5, 7, 3, 9], np.int32)


def states_equal(a: NetworkState, b: NetworkState) -> bool:
    """Exact equality of two states: names, every tensor (shape, dtype,
    values) and every host int."""
    if (a.fifo_names, a.actor_names) != (b.fifo_names, b.actor_names):
        return False
    la, lb = a.leaves(), b.leaves()
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
                return False
        elif x != y:
            return False
    return True


def make_dpd(n_firings: int = 6, block_l: int = 256, seed: int = 0,
             active_schedule: Optional[np.ndarray] = None,
             device: DeviceLike = None, **build_kw) -> Tuple[Network, int]:
    """DPD (paper §4.2) with a seeded ``numpy`` normal signal staged.

    Defaults to :data:`DPD_SCHEDULE` cut to ``n_firings`` so rate-0
    firings hit most branches.
    """
    from repro_torch.graphs.dpd import build_dpd
    if active_schedule is None:
        active_schedule = DPD_SCHEDULE[:n_firings]
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(2, n_firings * block_l)).astype(np.float32)
    return build_dpd(n_firings, active_schedule=active_schedule,
                     block_l=block_l, signal=sig, device=device,
                     **build_kw), n_firings


def make_motion_detection(n_frames: int = 12, rate: int = 4,
                          frame_hw: Tuple[int, int] = (240, 320),
                          seed: int = 1, device: DeviceLike = None
                          ) -> Tuple[Network, int]:
    """Motion detection (paper §4.1) with a seeded ``numpy`` uniform video
    staged — the delay-channel (Fig. 4 dotted edge) workload."""
    from repro_torch.graphs.motion_detection import build_motion_detection
    rng = np.random.default_rng(seed)
    video = rng.uniform(0, 255, (n_frames,) + tuple(frame_hw)).astype(np.float32)
    return build_motion_detection(n_frames, rate=rate, frame_hw=frame_hw,
                                  video=video, device=device), n_frames // rate


def make_moe(n_firings: int = 3, n_tokens: int = 16, d_model: int = 32,
             n_experts: int = 4, top_k: int = 2, d_ff: int = 64,
             capacity_factor: float = 2.0, seed: int = 0,
             device: DeviceLike = None) -> Tuple[Network, int]:
    """The MoE layer as actors (idle experts fire at rate 0), with the
    reference's defaults: ``moe_init`` weights from a ``torch.Generator``
    seeded with ``seed`` and a seeded ``numpy`` normal token stream."""
    from repro_torch.graphs.moe_as_actors import build_moe_network
    from repro_torch.models.moe import moe_init
    gen = torch.Generator().manual_seed(seed)
    params = moe_init(d_model, n_experts, d_ff, gen)
    xs = np.random.default_rng(seed).normal(
        size=(n_firings * n_tokens, d_model)).astype(np.float32)
    return build_moe_network(params, n_tokens, d_model, top_k, capacity_factor,
                             n_firings, torch.from_numpy(xs), device=device), n_firings
