"""Ticket-age straggler detection.

Every worker FetchAdds a per-step arrival ticket when it reaches the step
barrier — the paper's wait-free doorway.  A worker's *age* is
``max_arrival_step - its_last_step``: the exact ``dx = tx - grant`` queue
depth the paper uses to split short-term from long-term waiters, reused here
to split "on pace" from "straggling".  Workers more than ``threshold`` steps
behind the front are flagged; the elastic planner can then evict them at the
next checkpoint boundary instead of letting the whole pod spin-wait (global
spinning at cluster scale).
"""

from __future__ import annotations


class StepTickets:
    def __init__(self, store, *, threshold: int = 2,
                 namespace: str = "step") -> None:
        self.store = store
        self.threshold = threshold
        self.ns = namespace

    def _wkey(self, worker: int) -> str:
        return f"{self.ns}/w{worker}"

    def arrive(self, worker: int, step: int) -> int:
        """Worker reached `step`; returns its arrival ticket within the step
        (0 = led the step)."""
        self.store.set(self._wkey(worker), step)
        while True:  # CAS-advance the front (monotone max)
            front = self.store.get(f"{self.ns}/front", default=0)
            if step <= front:
                break
            if self.store.compare_and_swap(f"{self.ns}/front", front,
                                           step) == front:
                break
        return self.store.fetch_add(f"{self.ns}/s{step}/arrivals", 1)

    def age(self, worker: int) -> int:
        front = self.store.get(f"{self.ns}/front", default=0)
        return front - self.store.get(self._wkey(worker), default=0)

    def stragglers(self, workers) -> list:
        return [w for w in workers if self.age(w) > self.threshold]

    def front(self) -> int:
        return self.store.get(f"{self.ns}/front", default=0)
