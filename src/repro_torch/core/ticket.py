"""Classic ticket lock (paper Listing 1, lines 1-16).

Acquire: one atomic fetch-and-add on ``ticket`` (wait-free doorway), then spin
until ``grant`` equals the assigned ticket.  Release: plain increment of
``grant`` — no atomics.  Strict FIFO.  All waiters spin on the single ``grant``
word: *global spinning*, the scalability impediment TWA removes.
"""

from __future__ import annotations

import itertools
import time

from .atomics import AtomicU64

_lock_ids = itertools.count(1)


def pause(iteration: int) -> None:
    """Polite waiting (the paper's PAUSE).  Yields the GIL so sibling threads
    can run; backs off to a real sleep for very long waits."""
    if iteration < 64:
        time.sleep(0)
    else:
        time.sleep(0.000001 * min(iteration // 64, 50))


class TicketLock:
    """Classic ticket lock."""

    name = "ticket"

    def __init__(self) -> None:
        self.lock_id = next(_lock_ids) << 7  # pseudo "address", sector aligned
        self.ticket = AtomicU64(0)
        self.grant = AtomicU64(0)

    # -- core protocol ----------------------------------------------------
    def acquire(self) -> int:
        tx = self.ticket.fetch_add(1)
        it = 0
        while self.grant.load() != tx:
            pause(it)
            it += 1
        return tx

    def release(self) -> None:
        # Non-atomic increment in the paper; the owner is the only writer.
        self.grant.store(self.grant.load() + 1)

    # -- introspection ----------------------------------------------------
    def waiters(self) -> int:
        """ticket - grant - 1 when held (paper §1)."""
        return max(0, self.ticket.load() - self.grant.load() - 1)

    def locked(self) -> bool:
        return self.ticket.load() != self.grant.load()

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> "TicketLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
