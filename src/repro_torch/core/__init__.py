"""Core: the paper's lock algorithms, faithful and deployable.

Copies of the reference's ``repro.core`` modules (the port imports nothing
of it): the atomic cell, the waiting-array hash and the shared waiting
array, the host-side locks (ticket, TWA, MCS and the variants), their
complexity measure (paper Table 1), the coordination key-value stores and
the distributed locks over them.  The locks keep the reference's control
flow line for line, so that :func:`complexity.table1` measures the same
numbers on the port's classes.

``make_lock`` is the interposition point (the paper uses LD_PRELOAD; we use a
factory) — every framework subsystem that needs host-side mutual exclusion
requests its lock here, so the algorithm is swappable via config/env.
"""

from __future__ import annotations

import os

from .atomics import AtomicU64
from .hashing import DEFAULT_ARRAY_SIZE, twa_hash, sector_of
from .mcs import MCSLock
from .ticket import TicketLock
from .twa import LONG_TERM_THRESHOLD, TWALock
from .variants import (AndersonLock, PartitionedTicketLock, TKTDualLock,
                       TWAIDLock, TWAStagedLock)
from .waiting_array import WaitingArray, global_waiting_array
from .kvstore import FileKVStore, InMemoryKVStore
from .distributed import (
    DistributedTicketLock,
    DistributedTWALock,
    LeaseGuard,
    recover_dead_holder,
)

LOCK_CLASSES = {
    "ticket": TicketLock,
    "twa": TWALock,
    "mcs": MCSLock,
    "tkt-dual": TKTDualLock,
    "twa-id": TWAIDLock,
    "twa-staged": TWAStagedLock,
    "anderson": AndersonLock,
    "partitioned": PartitionedTicketLock,
}


def make_lock(kind: str | None = None, **kwargs):
    """Create a lock instance; kind defaults to $REPRO_LOCK or 'twa'."""
    kind = kind or os.environ.get("REPRO_LOCK", "twa")
    try:
        return LOCK_CLASSES[kind](**kwargs)
    except KeyError:
        raise ValueError(f"unknown lock kind {kind!r}; options: {sorted(LOCK_CLASSES)}")


__all__ = [
    "AtomicU64", "twa_hash", "sector_of", "DEFAULT_ARRAY_SIZE",
    "TicketLock", "TWALock", "MCSLock", "TKTDualLock", "TWAIDLock",
    "TWAStagedLock",
    "AndersonLock", "PartitionedTicketLock", "LONG_TERM_THRESHOLD",
    "WaitingArray", "global_waiting_array", "make_lock", "LOCK_CLASSES",
    "InMemoryKVStore", "FileKVStore",
    "DistributedTicketLock", "DistributedTWALock", "LeaseGuard",
    "recover_dead_holder",
]
