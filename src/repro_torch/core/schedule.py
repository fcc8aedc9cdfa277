"""Scheduling utilities for the MoC (the port's copy of what it needs).

Every channel has one rate shared by both ports, so the SDF repetition
vector is all-ones and a valid static schedule is a topological order with
delay edges broken.  The reference's phase-unroll period has no
counterpart here: eager cursor offsets are host ints already.
"""
from __future__ import annotations

from typing import List, Sequence


def validate_single_appearance(order: List[str], names: Sequence[str]) -> None:
    if sorted(order) != sorted(names):
        raise ValueError(
            f"schedule must contain every actor exactly once; got {order} "
            f"for {list(names)}")
