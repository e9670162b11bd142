"""Atomic primitives for the host-thread lock implementations.

CPython has no user-level CAS/XADD; a hardware fetch-and-add is emulated with a
micro-mutex per cell.  This preserves the *semantics* the paper's algorithms
require (atomicity + total order of RMWs per location); the performance model
of the memory system itself lives in :mod:`repro_torch.sim`, not here.
"""

from __future__ import annotations

import threading


class AtomicU64:
    """64-bit atomic cell (paper uses u64 waiting-array slots so rollover
    "never occurs in practice")."""

    __slots__ = ("_value", "_mutex")

    MASK = (1 << 64) - 1

    def __init__(self, value: int = 0) -> None:
        self._value = value & self.MASK
        self._mutex = threading.Lock()

    def load(self) -> int:
        # Reads of a machine word are atomic on the modeled hardware; the GIL
        # gives us the same guarantee for a single attribute read.
        return self._value

    def store(self, value: int) -> None:
        with self._mutex:
            self._value = value & self.MASK

    def fetch_add(self, delta: int = 1) -> int:
        """Atomic fetch-and-add; returns the *previous* value (LOCK:XADD)."""
        with self._mutex:
            old = self._value
            self._value = (old + delta) & self.MASK
            return old

    def compare_and_swap(self, expected: int, new: int) -> int:
        """CAS; returns the value observed (== expected on success)."""
        with self._mutex:
            old = self._value
            if old == expected:
                self._value = new & self.MASK
            return old

    def swap(self, new: int) -> int:
        """Atomic exchange (SWAP/XCHG); returns the previous value."""
        with self._mutex:
            old = self._value
            self._value = new & self.MASK
            return old
