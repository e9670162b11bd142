"""LockGate — pluggable FIFO admission locks with TWA waiting (paper §2,
applied to request admission).

All gates share one counting-semaphore ticket doorway: up to ``lanes``
tickets are admitted concurrently (``tx - grant < lanes``); the rest queue
in strict FIFO order.  What a gate *chooses* is its waiting policy — the
axis the simulator sweeps as ``SIM_LOCKS`` — so ``ServeEngine(lock=...)``
is a real choice backed by measured sweeps:

* :class:`TicketGate` — classic global spinning: every waiter polls the hot
  ``grant`` counter (``two_tier=False``), or TWA two-tier waiting
  (``two_tier=True``, the historical default) where only the next
  ``threshold`` tickets past the admitted window poll ``grant`` and
  everyone further back parks on a hashed slot of the shared
  :class:`~repro_torch.core.waiting_array.WaitingArray`, 10x colder.
* :class:`TWAGate` — two-tier waiting pinned on (the paper's algorithm).
* :class:`FissileTWAGate` — Fissile-style composition: a bounded fast-spin
  window on the hot grant word first, then the TWA slow path.  Under light
  contention waiters never touch the waiting array at all.
* :class:`RWTWAGate` — the read-mostly composition ``twa-rw`` models:
  admission *metadata reads* (queue depth, stats snapshots) register in a
  reader count and never touch the ticket doorway, so the hot counters see
  writers only.

``advance()`` (called when a lane frees) increments ``grant`` first — the
handover — and *then* notifies the slot of the ticket that just became a
short-term waiter, off the admission critical path.  Poll telemetry
(``grant_polls`` vs ``slot_polls``, plus ``slot_hashes``) exposes the
hot-counter load that the paper's Figure 1 measures as the invalidation
diameter — and pins that the waiting-array slot is hashed exactly once per
long-term entry, never once per poll.
"""

from __future__ import annotations

import threading
import time

from ..core.atomics import AtomicU64
from ..core.waiting_array import WaitingArray, global_waiting_array

SHORT_POLL_S = 0.0001
LONG_POLL_S = 0.001


class LockGate:
    """Base gate: the shared ticket/grant/waiting-array machinery.

    Subclasses override the waiting policy (``wait`` / ``_long_term_wait``)
    and the metadata-read path (``read_metadata``); the doorway
    (``draw``), the admitted-window predicate and the handover
    (``advance``) are common to every algorithm the serve layer offers.
    """

    kind = "lockgate"

    def __init__(self, lanes: int, *, threshold: int = 1,
                 waiting_array: WaitingArray | None = None,
                 name: str = "serve", two_tier: bool = True) -> None:
        assert lanes >= 1
        self.lanes = lanes
        self.threshold = threshold
        self.two_tier = two_tier
        self.tickets = AtomicU64(0)
        self.grant = AtomicU64(0)
        self.array = (waiting_array if waiting_array is not None
                      else global_waiting_array())
        self.lock_id = (hash(name) & 0x7FFFFFFF) << 7
        # telemetry
        self._tel = threading.Lock()
        self.grant_polls = 0
        self.slot_polls = 0
        self.slot_hashes = 0        # index_for calls: one per long-term entry
        self.long_term_entries = 0
        self.metadata_reads = 0

    # -- doorway (wait-free FetchAdd, paper line 35) -------------------------
    def draw(self) -> int:
        return self.tickets.fetch_add(1)

    def admitted(self, tx: int) -> bool:
        return tx - self.grant.load() < self.lanes

    def queue_depth(self) -> int:
        """dx analogue: drawn-but-unadmitted tickets."""
        return max(0, self.tickets.load() - self.grant.load() - self.lanes)

    # -- waiting (two-tier, paper lines 41-61) --------------------------------
    def _dx(self, tx: int) -> int:
        """Distance to admission: 0 ⇒ admitted."""
        return max(0, tx - self.grant.load() - (self.lanes - 1))

    def wait(self, tx: int, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        dx = self._poll_grant(tx)
        if dx == 0:
            return
        if self.two_tier and dx > self.threshold:
            self._long_term_wait(tx, deadline)
        while self._poll_grant(tx) > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ticket {tx} not admitted in {timeout_s}s")
            time.sleep(SHORT_POLL_S)

    def _poll_grant(self, tx: int) -> int:
        with self._tel:
            self.grant_polls += 1
        return self._dx(tx)

    def _slot_for(self, tx: int) -> int:
        """The waiting-array slot for (lock, ticket) — counted, so tests can
        pin that the hash runs once per long-term entry, not once per poll."""
        with self._tel:
            self.slot_hashes += 1
        return self.array.index_for(self.lock_id, tx)

    def _long_term_wait(self, tx: int, deadline: float) -> None:
        with self._tel:
            self.long_term_entries += 1
        # Hash the slot ONCE per long-term entry, outside both poll loops:
        # (lock_id, tx) is loop-invariant, and re-deriving it per poll would
        # put a multiply+xor on the cold path the paper keeps trivial.
        at = self._slot_for(tx)
        while True:
            u = self.array.load(at)
            if self._poll_grant(tx) <= self.threshold:  # recheck (lost wakeup)
                return
            while self.array.load(at) == u:
                with self._tel:
                    self.slot_polls += 1
                if time.monotonic() > deadline:
                    return  # fall back to short-term; wait() re-checks
                time.sleep(LONG_POLL_S)

    # -- handover (paper lines 63-71) -----------------------------------------
    def advance(self) -> int:
        """A lane freed: admit the next ticket, then notify the long-term
        waiter that just became a short-term one (after handover, off the
        critical path)."""
        k = self.grant.fetch_add(1) + 1
        self.array.notify(self.lock_id, k + self.lanes - 1 + self.threshold)
        return k

    # -- metadata reads --------------------------------------------------------
    def read_metadata(self, fn):
        """Run ``fn()`` as an admission-metadata read.

        The base gates read in place (the read shares whatever counters the
        waiters are polling); :class:`RWTWAGate` overrides this with the
        read-registration path ``twa-rw`` models.
        """
        with self._tel:
            self.metadata_reads += 1
        return fn()

    # -- telemetry -------------------------------------------------------------
    def poll_stats(self) -> dict:
        with self._tel:
            return {"grant_polls": self.grant_polls,
                    "slot_polls": self.slot_polls,
                    "slot_hashes": self.slot_hashes,
                    "long_term_entries": self.long_term_entries,
                    "metadata_reads": self.metadata_reads}


class TicketGate(LockGate):
    """The historical gate: plain ticket admission.

    ``two_tier=True`` (the default, kept for backward compatibility) is TWA
    waiting; ``two_tier=False`` is the classic globally-spinning ticket
    lock every waiter of which polls the hot grant counter.
    """

    kind = "ticket"


class TWAGate(TicketGate):
    """Ticket admission with TWA two-tier waiting pinned on (paper §2)."""

    kind = "twa"

    def __init__(self, lanes: int, **kw) -> None:
        kw["two_tier"] = True
        super().__init__(lanes, **kw)


class FissileTWAGate(TWAGate):
    """Fissile composition: bounded grant-word fast spin, then TWA.

    A waiter first polls the hot grant counter up to ``fast_window`` times
    (the TAS-like barging window of Fissile Locks, minus the barging — the
    FIFO doorway is kept); only if admission is still distant does it fall
    back to the two-tier TWA slow path.  ``fast_grants`` counts waits the
    fast window resolved without ever touching the waiting array.
    """

    kind = "fissile-twa"

    def __init__(self, lanes: int, *, fast_window: int = 8, **kw) -> None:
        super().__init__(lanes, **kw)
        self.fast_window = fast_window
        self.fast_grants = 0

    def wait(self, tx: int, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        for _ in range(self.fast_window):
            if self._poll_grant(tx) == 0:
                with self._tel:
                    self.fast_grants += 1
                return
            time.sleep(SHORT_POLL_S)
            if time.monotonic() > deadline:
                break
        if self.two_tier and self._poll_grant(tx) > self.threshold:
            self._long_term_wait(tx, deadline)
        while self._poll_grant(tx) > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ticket {tx} not admitted in {timeout_s}s")
            time.sleep(SHORT_POLL_S)

    def poll_stats(self) -> dict:
        st = super().poll_stats()
        with self._tel:
            st["fast_grants"] = self.fast_grants
        return st


class RWTWAGate(TWAGate):
    """The ``twa-rw`` composition: metadata reads never touch the doorway.

    Reads register in a side reader count (concurrent among themselves,
    like ``twa-rw`` readers sharing the critical section) and observe the
    admission state without polling the hot ticket/grant counters in the
    waiter path.  ``reader_overlap_max`` witnesses that reads actually
    overlapped — the reachability signal ``build_rw_probe`` checks in-VM.
    """

    kind = "twa-rw"

    def __init__(self, lanes: int, **kw) -> None:
        super().__init__(lanes, **kw)
        self._readers = AtomicU64(0)
        self.reader_overlap_max = 0

    def read_metadata(self, fn):
        depth = self._readers.fetch_add(1) + 1
        with self._tel:
            self.metadata_reads += 1
            if depth > self.reader_overlap_max:
                self.reader_overlap_max = depth
        try:
            return fn()
        finally:
            self._readers.fetch_add(-1)

    def poll_stats(self) -> dict:
        st = super().poll_stats()
        with self._tel:
            st["reader_overlap_max"] = self.reader_overlap_max
        return st


# Gate registry: the serve layer's admission-lock menu.  "ticket" is the
# single-tier baseline (global spinning) so the choice vs "twa" is real.
GATES = {
    "ticket": lambda lanes, **kw: TicketGate(lanes,
                                             **{"two_tier": False, **kw}),
    "twa": TWAGate,
    "fissile-twa": FissileTWAGate,
    "twa-rw": RWTWAGate,
}

# recommend_lock answers in SIM_LOCKS names (14 algorithms); the serve
# layer offers four waiting policies.  Map each simulated lock to the gate
# that implements its waiting policy at request granularity: the queue
# locks (mcs/clh/hemlock/anderson/partitioned) and plain ticket all poll a
# dedicated word per waiter or the grant word — the single-tier gate — and
# every TWA-family variant maps to its composition or the plain TWA gate.
_GATE_FOR_SIM_LOCK = {
    "fissile-twa": "fissile-twa",
    "twa-rw": "twa-rw",
    "ticket": "ticket",
    "mcs": "ticket",
    "clh": "ticket",
    "hemlock": "ticket",
    "anderson": "ticket",
    "partitioned": "ticket",
}


def gate_kind_for_lock(lock: str) -> str:
    """The serve-layer gate kind implementing simulated lock ``lock``."""
    return _GATE_FOR_SIM_LOCK.get(lock, "twa")


def make_gate(kind: str, lanes: int, **kw) -> LockGate:
    """Instantiate a registered gate (``GATES``) or map a ``SIM_LOCKS``
    name onto the gate implementing its waiting policy."""
    if kind not in GATES:
        mapped = gate_kind_for_lock(kind)
        if kind not in _GATE_FOR_SIM_LOCK and kind not in ("twa", "twa-id",
                                                           "twa-staged",
                                                           "twa-sem",
                                                           "twa-timo",
                                                           "tkt-dual"):
            raise ValueError(f"unknown gate {kind!r}; registered: "
                             f"{sorted(GATES)} (or any SIM_LOCKS name)")
        kind = mapped
    return GATES[kind](lanes, **kw)
