"""Heartbeat monitoring over the coordination store."""

from __future__ import annotations

import time


class HeartbeatMonitor:
    """Workers `beat(worker)`; anyone can ask `alive()` / `dead()`.

    Timestamps live in the coordination KV store, so the monitor survives the
    death of any single worker (including itself — it is stateless)."""

    def __init__(self, store, *, ttl_s: float = 5.0,
                 namespace: str = "hb") -> None:
        self.store = store
        self.ttl_s = ttl_s
        self.ns = namespace

    def _key(self, worker: int) -> str:
        return f"{self.ns}/{worker}"

    def beat(self, worker: int, now: float | None = None) -> None:
        t = now if now is not None else time.time()
        self.store.set(self._key(worker), int(t * 1000))

    def last_beat(self, worker: int) -> float | None:
        v = self.store.get(self._key(worker), default=-1)
        return None if v < 0 else v / 1000.0

    def alive(self, worker: int, now: float | None = None) -> bool:
        t = now if now is not None else time.time()
        last = self.last_beat(worker)
        return last is not None and (t - last) <= self.ttl_s

    def dead(self, workers, now: float | None = None) -> list:
        return [w for w in workers if not self.alive(w, now)]
