"""Algorithmic variations (paper Appendix 6 + related-work baselines).

* :class:`TKTDualLock` — TKT-Dual: two grant fields (short-/long-term) instead
  of a waiting array; long-term spinners share a *different* line than the one
  stored during handover.
* :class:`TWAIDLock` — TWA-ID: waiting-array slots hold waiter identities; the
  release path uses a plain store of 0 instead of an atomic increment, trading
  more write traffic on arrival for a cheaper unlock.
* :class:`AndersonLock` — Anderson's array-based queue lock: per-lock array,
  one slot per potential waiter, size fixed at init (the footprint/sizing
  drawback the paper contrasts TWA against).
* :class:`PartitionedTicketLock` — Dice's Partitioned Ticket Lock: per-lock
  constant-length array of grant slots (semi-local waiting, larger per-lock
  footprint, no inter-lock sharing).
"""

from __future__ import annotations

import threading

from .atomics import AtomicU64
from .ticket import TicketLock, pause
from .twa import LONG_TERM_THRESHOLD, RECHECK_EVERY
from .waiting_array import WaitingArray, global_waiting_array


class TKTDualLock(TicketLock):
    """Ticket lock with dual (short-term / long-term) grant fields."""

    name = "tkt-dual"

    def __init__(self, long_term_threshold: int = LONG_TERM_THRESHOLD) -> None:
        super().__init__()
        self.threshold = long_term_threshold
        self.lgrant = AtomicU64(0)  # long-term grant; its own cache sector

    def acquire(self) -> int:
        tx = self.ticket.fetch_add(1)
        dx = tx - self.grant.load()
        if dx == 0:
            return tx
        if dx > self.threshold:
            it = 0
            while tx - self.lgrant.load() > self.threshold:
                pause(it)
                it += 1
        it = 0
        while self.grant.load() != tx:
            pause(it)
            it += 1
        return tx

    def release(self) -> None:
        k = self.grant.load() + 1
        self.grant.store(k)   # handover store first (short-term spinners only)
        self.lgrant.store(k)  # then shift long-term waiters (different line)


class TWAIDLock(TicketLock):
    """TWA with identity slots: release stores 0, arrival stores thread id."""

    name = "twa-id"

    def __init__(
        self,
        waiting_array: WaitingArray | None = None,
        long_term_threshold: int = LONG_TERM_THRESHOLD,
    ) -> None:
        super().__init__()
        self.array = waiting_array if waiting_array is not None else global_waiting_array()
        self.threshold = long_term_threshold

    def acquire(self) -> int:
        tx = self.ticket.fetch_add(1)
        dx = tx - self.grant.load()
        if dx == 0:
            return tx
        if dx > self.threshold:
            my_id = threading.get_ident() | 1  # temporally-unique, non-zero
            at = self.array.index_for(self.lock_id, tx)
            while True:
                self.array._slots[at].store(my_id)  # more write traffic (paper)
                if tx - self.grant.load() <= self.threshold:
                    break
                it = 0
                while self.array.load(at) == my_id:
                    pause(it)
                    it += 1
                    if it % RECHECK_EVERY == 0 and tx - self.grant.load() <= self.threshold:
                        break
                if tx - self.grant.load() <= self.threshold:
                    break
        it = 0
        while self.grant.load() != tx:
            pause(it)
            it += 1
        return tx

    def release(self) -> None:
        k = self.grant.load() + 1
        self.grant.store(k)
        at = self.array.index_for(self.lock_id, k + self.threshold)
        self.array._slots[at].store(0)  # plain store — no atomic RMW


class TWAStagedLock(TicketLock):
    """TWA-Staged (paper Appendix 6): waiting threads split into three
    groups — (A) ≥2 from the head: parked on the waiting array; (B) exactly
    2 away: busy-waits on grant and, on observing handover, *itself*
    promotes the next (A) thread by bumping its slot before shifting to (C);
    (C) the immediate successor: classic spin on grant.

    The payoff: the unlock operator is a bare ``grant++`` — it never touches
    the waiting array (uncontended lock/unlock paths identical to classic
    ticket locks); the promotion work is pushed onto waiting threads, which
    had nothing better to do.  The cost: two threads (B and C) spin on grant
    instead of one.
    """

    name = "twa-staged"

    STAGE_THRESHOLD = 2   # (B) boundary: dx == 2

    def __init__(self, waiting_array: WaitingArray | None = None) -> None:
        super().__init__()
        self.array = (waiting_array if waiting_array is not None
                      else global_waiting_array())
        self.long_term_entries = 0

    def acquire(self) -> int:
        tx = self.ticket.fetch_add(1)
        dx = tx - self.grant.load()
        if dx == 0:
            return tx                       # fast path, as classic ticket
        if dx >= self.STAGE_THRESHOLD:
            # (A)/(B) entrants carry the promotion duty.  Liveness (beyond
            # the appendix's sketch): a waiter can skip straight past the
            # (B) observation window if two handovers land between notify
            # and recheck, so EVERY dx >= 2 entrant promotes its successor
            # exactly once when it first reaches dx <= 1 — over-notification
            # is a benign spurious recheck, a lost promotion deadlocks.
            if dx > self.STAGE_THRESHOLD:
                self._long_term_wait(tx)    # (A): park on the hashed slot
            it = 0
            while tx - self.grant.load() > 1:   # (B): watch grant
                pause(it)
                it += 1
            self.array.notify(self.lock_id, tx + 1)
        it = 0
        while self.grant.load() != tx:       # (C): classic short-term spin
            pause(it)
            it += 1
        return tx

    def _long_term_wait(self, tx: int) -> None:
        self.long_term_entries += 1
        at = self.array.index_for(self.lock_id, tx)
        while True:
            u = self.array.load(at)
            if tx - self.grant.load() <= self.STAGE_THRESHOLD:  # recheck
                return
            it = 0
            while self.array.load(at) == u:
                pause(it)
                it += 1
                if (it % RECHECK_EVERY == 0
                        and tx - self.grant.load() <= self.STAGE_THRESHOLD):
                    return

    def release(self) -> None:
        # the entire unlock: no waiting-array access (appendix's key point)
        self.grant.store(self.grant.load() + 1)


class AndersonLock:
    """Anderson's array-based queueing lock (one slot per potential waiter)."""

    name = "anderson"

    def __init__(self, max_threads: int = 256) -> None:
        self.size = max_threads
        self.ticket = AtomicU64(0)
        self.flags = [AtomicU64(0) for _ in range(max_threads)]
        self.flags[0].store(1)
        self._slot = threading.local()

    def acquire(self) -> int:
        tx = self.ticket.fetch_add(1)
        at = tx % self.size
        it = 0
        while self.flags[at].load() == 0:
            pause(it)
            it += 1
        self.flags[at].store(0)
        self._slot.mine = at
        return tx

    def release(self) -> None:
        at = self._slot.mine
        self.flags[(at + 1) % self.size].store(1)

    def locked(self) -> bool:  # approximation for tests
        return all(f.load() == 0 for f in self.flags)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class PartitionedTicketLock(TicketLock):
    """Partitioned Ticket Lock: per-lock array of grant slots (semi-local)."""

    name = "partitioned"

    SLOTS = 16  # constant-length private array (per-lock footprint cost)

    def __init__(self) -> None:
        super().__init__()
        self.grants = [AtomicU64(0) for _ in range(self.SLOTS)]
        # grants[i] holds the most recent grant value g with g % SLOTS == i.

    def acquire(self) -> int:
        tx = self.ticket.fetch_add(1)
        at = tx % self.SLOTS
        it = 0
        while self.grants[at].load() != tx:
            pause(it)
            it += 1
        return tx

    def release(self) -> None:
        k = self.grant.load() + 1
        self.grant.store(k)  # canonical copy (not spun upon)
        self.grants[k % self.SLOTS].store(k)
