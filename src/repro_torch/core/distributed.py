"""Distributed TWA — the paper's insight applied at coordination-service scale.

At 1000+ nodes, workers waiting their turn for a shared resource (checkpoint
writer slots, elastic barriers, rollout admission) poll keys on a coordination
service.  A plain distributed ticket lock has every waiter polling the single
``grant`` key — the service-side hot key is the exact analogue of the paper's
globally-spun cache line, and its QPS grows linearly with the number of
waiters.  :class:`DistributedTWALock` bounds the ``grant`` key's poll rate to
O(threshold) pollers: everyone else parks on a hashed slot key of a shared
notification array and is promoted FIFO, exactly as in the paper.

Poll-rate telemetry (``store.read_counts``) lets benchmarks measure hot-key
load directly — the cluster equivalent of Figure 1.
"""

from __future__ import annotations

import threading
import time

from .hashing import DEFAULT_ARRAY_SIZE, twa_hash

SHORT_POLL_S = 0.0002   # immediate-successor poll cadence ("spin")
LONG_POLL_S = 0.002     # parked-waiter cadence (10x colder)
ARRAY_NAMESPACE = "twa/wa"


class DistributedTicketLock:
    """Baseline: distributed ticket lock — every waiter polls ``grant``."""

    name = "dist-ticket"

    def __init__(self, store, name: str) -> None:
        self.store = store
        self.key_ticket = f"{name}/ticket"
        self.key_grant = f"{name}/grant"
        self.lock_id = (hash(name) & 0x7FFFFFFF) << 7

    def acquire(self) -> int:
        tx = self.store.fetch_add(self.key_ticket, 1)
        while self.store.get(self.key_grant) != tx:
            time.sleep(SHORT_POLL_S)
        return tx

    def release(self) -> None:
        self.store.fetch_add(self.key_grant, 1)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class DistributedTWALock(DistributedTicketLock):
    """TWA over a KV store: two-tier waiting bounds the hot key's poll rate."""

    name = "dist-twa"

    def __init__(
        self,
        store,
        name: str,
        long_term_threshold: int = 1,
        array_size: int = DEFAULT_ARRAY_SIZE,
    ) -> None:
        super().__init__(store, name)
        self.threshold = long_term_threshold
        self.array_size = array_size

    def _slot_key(self, ticket: int) -> str:
        idx = twa_hash(self.lock_id, ticket, self.array_size)
        return f"{ARRAY_NAMESPACE}/{idx}"

    def acquire(self) -> int:
        tx = self.store.fetch_add(self.key_ticket, 1)
        dx = tx - self.store.get(self.key_grant)
        if dx == 0:
            return tx
        if dx > self.threshold:
            slot = self._slot_key(tx)
            while True:
                u = self.store.get(slot)
                dx = tx - self.store.get(self.key_grant)  # recheck (lost wakeup)
                if dx <= self.threshold:
                    break
                while self.store.get(slot) == u:
                    time.sleep(LONG_POLL_S)  # cold polling on the hashed slot
        while self.store.get(self.key_grant) != tx:
            time.sleep(SHORT_POLL_S)
        return tx

    def release(self) -> None:
        k = self.store.fetch_add(self.key_grant, 1) + 1
        # Notify after handover, off the critical path (paper §2).
        self.store.fetch_add(self._slot_key(k + self.threshold), 1)


class LeaseGuard:
    """Failure containment for distributed locks: the holder renews a lease;
    a monitor can revoke a dead holder by advancing grant on its behalf.

    This is the piece the paper does not need (threads don't die holding a
    spinlock) but a 1000-node deployment does: without it, one crashed holder
    wedges the FIFO queue forever.
    """

    def __init__(self, store, name: str, ttl_s: float = 2.0) -> None:
        self.store = store
        self.key = f"{name}/lease"
        self.ttl_s = ttl_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _now_ms(self) -> int:
        return int(time.time() * 1000)

    def start(self) -> None:
        self._stop.clear()
        self.store.set(self.key, self._now_ms())

        def renew() -> None:
            while not self._stop.wait(self.ttl_s / 4):
                self.store.set(self.key, self._now_ms())

        self._thread = threading.Thread(target=renew, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def expired(self) -> bool:
        return self._now_ms() - self.store.get(self.key) > self.ttl_s * 1000


def recover_dead_holder(store, name: str, lease: LeaseGuard, lock: DistributedTWALock) -> bool:
    """Monitor-side recovery: if the holder's lease expired, advance grant for
    it (skipping the dead ticket) and notify the waiting array.  Returns True
    if a recovery was performed."""
    if not lease.expired():
        return False
    lock.release()  # advance grant past the dead holder's ticket + notify
    return True
