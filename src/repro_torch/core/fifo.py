"""FIFO communication channels — paper §3.2, Eq. 1.

Channel capacity law (Eq. 1):

    C_f = S_f * (3r + 1)   if f carries a delay (initial) token
    C_f = S_f * (2r)       otherwise

The delay-free channel is a double buffer; the delay channel is the
paper's Fig. 2 triple buffer whose copy-back (slot ``3r`` -> slot ``0``)
keeps every read and write window contiguous.

State in the port differs from the JAX reference in two ways:

* rings are tensors updated **in place**: the reference's functional
  ``dynamic_update_slice`` becomes slice assignment, and ``read`` returns
  a *view* of the ring, valid until the writer next fills those slots;
* cursors (``rd``, ``wr``, ``occ``) are host Python ints, because the
  scheduler reads them on every firing attempt and a 0-d CUDA tensor would
  cost a device round trip per predicate.

Control channels (rate 1, scalar tokens) keep their ring in host memory:
their tokens are the scheduler's bookkeeping, read on every attempt.  Data
channels keep their ring on the network's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass
class FifoState:
    """Mutable state of one channel.

    Attributes:
      buf: ``(capacity_tokens, *token_shape)`` ring, updated in place.
      rd:  read phase counter (monotonically increasing host int).
      wr:  write phase counter (monotonically increasing host int).
      occ: occupancy in tokens (host int).
    """

    buf: torch.Tensor
    rd: int
    wr: int
    occ: int


@dataclasses.dataclass(frozen=True)
class FifoSpec:
    """Static description of a channel (paper §2.2, §3.2).

    ``rate`` is the single token rate ``r`` of both ports; ``delay`` the
    number of initial tokens (0 or 1).  ``domain=(lo, hi)`` declares the
    value range of every token element; the builder enumerates it to prove
    that two control-driven ports are enabled together.  ``matched_rates``
    declares (or, from the builder, records the proof) that the producing
    and consuming ports are always enabled together, which makes a
    delay-free channel transient in the static schedule.  ``row_id_col``
    names the column of record-row tokens (a row per slot, as serving's
    slot table) that holds the row's id, so a fault report can name the
    offending row's request.
    """

    name: str
    rate: int
    token_shape: Tuple[int, ...]
    dtype: Any = torch.float32
    delay: int = 0
    is_control: bool = False
    domain: Optional[Tuple[float, float]] = None
    matched_rates: bool = False
    row_id_col: Optional[int] = None

    def __post_init__(self) -> None:
        if self.rate < 1:
            raise ValueError(f"fifo {self.name}: rate must be >= 1, got {self.rate}")
        if self.matched_rates and self.delay:
            raise ValueError(
                f"fifo {self.name}: matched_rates is a transient-channel "
                "declaration; a delay channel carries tokens across "
                "iterations and can never be register-allocated")
        if self.delay not in (0, 1):
            raise ValueError(
                f"fifo {self.name}: the MoC allows 0 or 1 initial tokens, "
                f"got {self.delay}")
        if self.is_control and self.rate != 1:
            raise ValueError(
                f"fifo {self.name}: control channels must have token rate 1 "
                f"(paper §2.2), got {self.rate}")
        if self.is_control and self.delay:
            raise ValueError(
                f"fifo {self.name}: control channels cannot carry delay tokens")
        if self.domain is not None:
            lo, hi = self.domain
            if not float(lo) <= float(hi):
                raise ValueError(
                    f"fifo {self.name}: domain=({lo}, {hi}) is empty; "
                    "declare (lo, hi) with lo <= hi")
            object.__setattr__(self, "domain", (float(lo), float(hi)))
        if self.row_id_col is not None:
            if len(self.token_shape) < 2:
                raise ValueError(
                    f"fifo {self.name}: row_id_col names a column of "
                    "record-row tokens, so the token shape must be >= 2-D, "
                    f"got {self.token_shape}")
            if not 0 <= int(self.row_id_col) < self.token_shape[-1]:
                raise ValueError(
                    f"fifo {self.name}: row_id_col={self.row_id_col} is "
                    f"outside the token row width {self.token_shape[-1]}")

    # -- capacity law (Eq. 1) ------------------------------------------- #
    @property
    def capacity_tokens(self) -> int:
        """Channel capacity in tokens: ``3r + 1`` with delay, ``2r`` without."""
        return 3 * self.rate + 1 if self.delay else 2 * self.rate

    @property
    def token_size_bytes(self) -> int:
        """S_f — size of one token in bytes."""
        n = 1
        for d in self.token_shape:
            n *= int(d)
        return n * self.dtype.itemsize

    @property
    def capacity_bytes(self) -> int:
        """C_f of Eq. 1, in bytes."""
        return self.capacity_tokens * self.token_size_bytes

    @property
    def n_write_phases(self) -> int:
        return 3 if self.delay else 2

    @property
    def writable_occupancy_bound(self) -> int:
        """Maximum occupancy after a write: ``2r`` for the double buffer,
        ``2r + 1`` for the delay triple buffer (the writer runs at most one
        window ahead; the unread span then straddles three phase windows,
        which is why Eq. 1 allocates ``3r + 1`` slots)."""
        return 2 * self.rate + 1 if self.delay else 2 * self.rate

    # -- state construction --------------------------------------------- #
    def ring_device(self, device: torch.device) -> torch.device:
        """Where the ring lives: host memory for control channels, else
        ``device``."""
        return torch.device("cpu") if self.is_control else device

    def init_state(self, device: torch.device,
                   initial_token: Optional[Any] = None) -> FifoState:
        """Allocate the channel; a delay token (zeros by default) goes to
        slot 0 and occupancy starts at 1 (paper Fig. 2)."""
        buf = torch.zeros((self.capacity_tokens,) + tuple(self.token_shape),
                          dtype=self.dtype, device=self.ring_device(device))
        if self.delay:
            if initial_token is not None:
                tok = torch.as_tensor(initial_token, dtype=self.dtype)
                if tuple(tok.shape) != tuple(self.token_shape):
                    raise ValueError(
                        f"fifo {self.name}: initial token shape "
                        f"{tuple(tok.shape)} != token shape {self.token_shape}")
                buf[0] = tok
        elif initial_token is not None:
            raise ValueError(f"fifo {self.name}: initial token on a delay-free channel")
        return FifoState(buf=buf, rd=0, wr=0, occ=self.delay)

    # -- cursor arithmetic ---------------------------------------------- #
    def _read_offset(self, rd: int) -> int:
        """First slot of read phase ``rd``: 0, r (, 2r) cyclically."""
        return (rd % self.n_write_phases) * self.rate

    def _write_offset(self, wr: int) -> int:
        """First slot of write phase ``wr``; delay channels are offset by
        one because slot 0 holds the copied-back delay token."""
        return (wr % self.n_write_phases) * self.rate + (1 if self.delay else 0)

    # -- blocking predicates -------------------------------------------- #
    def can_read(self, st: FifoState) -> bool:
        return st.occ >= self.rate

    def can_write(self, st: FifoState) -> bool:
        return st.occ + self.rate <= self.writable_occupancy_bound

    def can_peek(self, st: FifoState) -> bool:
        return st.occ >= 1

    # -- in-place read / write / peek ------------------------------------ #
    def write(self, st: FifoState, tokens: torch.Tensor) -> None:
        """Append one ``(r, *token_shape)`` window; caller guarantees
        ``can_write``.  Delay channels copy slot ``3r`` back to slot 0
        right after the phase-2 write (paper Fig. 2 timing)."""
        off = self._write_offset(st.wr)
        st.buf[off:off + self.rate] = tokens
        if self.delay and st.wr % self.n_write_phases == 2:
            st.buf[0] = st.buf[3 * self.rate]
        st.wr += 1
        st.occ += self.rate

    def read(self, st: FifoState) -> torch.Tensor:
        """Consume one window (a view of the ring); caller guarantees
        ``can_read``."""
        off = self._read_offset(st.rd)
        window = st.buf[off:off + self.rate]
        st.rd += 1
        st.occ -= self.rate
        return window

    def peek(self, st: FifoState) -> torch.Tensor:
        """The next single token, not consumed (the scheduler evaluates a
        dynamic actor's control function on it before committing)."""
        return st.buf[self._read_offset(st.rd)]

    def read_masked(self, st: FifoState, enabled: int) -> torch.Tensor:
        """Rate-0/r read (paper §2.2 dynamic ports): the window at the read
        cursor is returned either way, the cursor advances only when
        ``enabled``."""
        off = self._read_offset(st.rd)
        window = st.buf[off:off + self.rate]
        if enabled:
            st.rd += 1
            st.occ -= self.rate
        return window

    def write_masked(self, st: FifoState, tokens: Optional[torch.Tensor],
                     enabled: int) -> None:
        """Rate-0/r write: commit the window (and the Fig. 2 copy-back of an
        enabled phase-2 write) only when ``enabled``; a disabled write
        leaves the ring and cursors untouched."""
        if enabled:
            self.write(st, tokens)


def total_buffer_bytes(specs) -> int:
    """Sum of Eq. 1 capacities — the accounting of paper Table 1."""
    return sum(s.capacity_bytes for s in specs)
