"""TWA — Ticket lock augmented with a waiting array (paper Listing 1, 20-71).

Mirrors the paper's pseudo-code:

* acquire fast path: ``FetchAdd(ticket)``; ``dx == 0`` ⇒ enter immediately.
* ``dx > LongTermThreshold`` ⇒ long-term waiting: hash (lock, tx) into the
  shared waiting array, read the slot, **recheck grant** (futex-style, avoids
  the lost-wakeup race with a concurrent release), spin on the slot until it
  changes, re-evaluate; when near the front, fall through to short-term.
* short-term waiting: classic spin on ``grant``.
* release: ``k = ++grant`` (the handover store, FIRST — off the array, at most
  ``LongTermThreshold`` spinners to invalidate), then atomic increment of
  ``WaitArray[Hash(lock, k + LongTermThreshold)]`` to promote the next
  long-term waiter — *after* handover, outside the critical path.

Deviation from C++ (documented): CPython offers no true hardware spinning, so
long-term spins recheck ``grant`` every ``RECHECK_EVERY`` iterations as a
belt-and-braces guard (real TWA needs no such guard; emulated atomics make the
defensive recheck cheap and it never changes admission order).
"""

from __future__ import annotations

from .atomics import AtomicU64
from .ticket import TicketLock, pause
from .waiting_array import WaitingArray, global_waiting_array

LONG_TERM_THRESHOLD = 1
RECHECK_EVERY = 1024


class TWALock(TicketLock):
    """Ticket lock + shared waiting array for long-term waiters."""

    name = "twa"

    def __init__(
        self,
        waiting_array: WaitingArray | None = None,
        long_term_threshold: int = LONG_TERM_THRESHOLD,
    ) -> None:
        super().__init__()
        self.array = waiting_array if waiting_array is not None else global_waiting_array()
        self.threshold = long_term_threshold
        # Telemetry (not part of the algorithm).
        self.long_term_entries = 0
        self.short_term_entries = 0

    # -- acquire -----------------------------------------------------------
    def acquire(self) -> int:
        tx = self.ticket.fetch_add(1)
        dx = tx - self.grant.load()
        if dx == 0:
            return tx  # fast path — uncontended acquisition

        if dx > self.threshold:
            self._long_term_wait(tx)
        else:
            self.short_term_entries += 1

        # classic short-term waiting on grant
        it = 0
        while self.grant.load() != tx:
            pause(it)
            it += 1
        return tx

    def _long_term_wait(self, tx: int) -> None:
        """Paper lines 45-57: park on a hashed slot until notified."""
        self.long_term_entries += 1
        at = self.array.index_for(self.lock_id, tx)
        while True:
            u = self.array.load(at)
            dx = tx - self.grant.load()  # recheck grant (race with release)
            assert dx >= 0
            if dx <= self.threshold:
                break
            it = 0
            while self.array.load(at) == u:
                pause(it)
                it += 1
                if it % RECHECK_EVERY == 0 and tx - self.grant.load() <= self.threshold:
                    break  # defensive recheck (CPython emulation only)

    # -- release -----------------------------------------------------------
    def release(self) -> None:
        # Handover store FIRST: at most `threshold` short-term spinners see it.
        k = self.grant.load() + 1
        self.grant.store(k)
        # Notify long-term waiters — after handover, outside the critical path.
        # Atomic: the slot may be shared with other locks (hash collisions).
        self.array.notify(self.lock_id, k + self.threshold)
