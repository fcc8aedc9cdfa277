"""Scheduling utilities for the MoC (the port's copy of what it needs).

Every channel has one rate shared by both ports, so the SDF repetition
vector is all-ones and a valid static schedule is a topological order with
delay edges broken.  The host executors need no phase unroll (eager cursor
offsets are host ints already); :func:`phase_unroll_period` is kept for the
megakernel lowering, which records it as the reference does.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence


def validate_single_appearance(order: List[str], names: Sequence[str]) -> None:
    if sorted(order) != sorted(names):
        raise ValueError(
            f"schedule must contain every actor exactly once; got {order} "
            f"for {list(names)}")


def phase_unroll_period(phase_counts: Iterable[int], bound: int = 6) -> int:
    """Unroll period that phase-specializes every channel's cursor: the LCM
    of the channels' ``n_write_phases`` when it is at most ``bound``, else
    the period <= ``bound`` covering the most channels (ties to the
    smaller)."""
    counts = list(phase_counts)
    period = 1
    for c in counts:
        if c < 1:
            raise ValueError(f"phase count must be >= 1, got {c}")
        period = period * c // math.gcd(period, c)
    if period <= bound:
        return period
    best, best_cover = 1, -1
    for p in range(1, bound + 1):
        cover = sum(1 for c in counts if p % c == 0)
        if cover > best_cover:
            best, best_cover = p, cover
    return best
