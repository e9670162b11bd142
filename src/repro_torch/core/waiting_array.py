"""The process-global waiting array (paper §2).

One array of 4096 u64 slots shared by **all** TWA locks and threads in the
address space — a one-time space cost, independent of the number of locks.
Slot values carry no meaning beyond "changed ⇒ recheck grant"; hash collisions
between locks are benign (spurious rechecks, never lost wakeups, because the
slot update in release uses an atomic increment and waiters re-validate grant).
"""

from __future__ import annotations

import threading

from .atomics import AtomicU64
from .hashing import DEFAULT_ARRAY_SIZE, twa_hash


class WaitingArray:
    """Shared long-term waiting array."""

    def __init__(self, size: int = DEFAULT_ARRAY_SIZE) -> None:
        assert size & (size - 1) == 0, "size must be a power of two"
        self.size = size
        self._slots = [AtomicU64(0) for _ in range(size)]
        # Telemetry: how many notifications landed on each slot (collision study).
        self.notify_count = 0

    def index_for(self, lock_id: int, ticket: int) -> int:
        return twa_hash(lock_id, ticket, self.size)

    def load(self, index: int) -> int:
        return self._slots[index].load()

    def notify(self, lock_id: int, ticket: int) -> int:
        """Atomically bump the slot for (lock, ticket); returns the slot index.

        Atomic because the slot may be shared between locks (inter-lock hash
        collisions) — a plain increment could lose a notification.
        """
        idx = self.index_for(lock_id, ticket)
        self._slots[idx].fetch_add(1)
        self.notify_count += 1
        return idx


_GLOBAL_LOCK = threading.Lock()
_GLOBAL_ARRAY: WaitingArray | None = None


def global_waiting_array() -> WaitingArray:
    """The address-space-wide array all TWA locks share by default."""
    global _GLOBAL_ARRAY
    if _GLOBAL_ARRAY is None:
        with _GLOBAL_LOCK:
            if _GLOBAL_ARRAY is None:
                _GLOBAL_ARRAY = WaitingArray()
    return _GLOBAL_ARRAY
