"""Background prefetcher — framework-internal concurrency guarded by the
paper's lock.

The producer thread generates upcoming batches while the accelerator step
runs; the shared ring buffer is protected by a ``core.make_lock()`` instance
(TWA by default, swappable via $REPRO_LOCK) — one of the places the lock
algorithms are *deployed*, not just benchmarked.
"""

from __future__ import annotations

import threading
from collections import deque

from ..core import make_lock


class Prefetcher:
    def __init__(self, source, *, start_step: int = 0, depth: int = 2,
                 lock_kind: str | None = None) -> None:
        self.source = source
        self.depth = depth
        self._lock = make_lock(lock_kind)
        self._buf: deque = deque()        # (step, batch) pairs, ascending
        self._next_produce = start_step
        self._next_consume = start_step
        self._stop = threading.Event()
        self._space = threading.Semaphore(depth)
        self._avail = threading.Semaphore(0)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while not self._stop.is_set():
            if not self._space.acquire(timeout=0.1):
                continue
            step = self._next_produce
            batch = self.source.batch_at(step)
            self._lock.acquire()
            try:
                self._buf.append((step, batch))
                self._next_produce = step + 1
            finally:
                self._lock.release()
            self._avail.release()

    def get(self, timeout: float = 30.0):
        """Next (step, batch) in order."""
        if not self._avail.acquire(timeout=timeout):
            raise TimeoutError("prefetcher starved")
        self._lock.acquire()
        try:
            step, batch = self._buf.popleft()
            assert step == self._next_consume, "out-of-order batch"
            self._next_consume += 1
        finally:
            self._lock.release()
        self._space.release()
        return step, batch

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
