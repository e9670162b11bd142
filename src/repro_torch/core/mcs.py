"""MCS queue lock (Mellor-Crummey & Scott 1991) — the paper's main baseline.

Arriving threads atomically SWAP a queue node onto the tail and spin *locally*
on their own node's flag; release follows the ``next`` pointer and stores into
the successor's flag.  Under no contention release needs a CAS to detach the
owner's node.  Strict FIFO, local spinning, but: longer handover path (two
cache lines + a dependent access), and per-(thread × held-lock) queue nodes
that cannot live on the stack under a POSIX interface (paper §1) — here they
come from thread-local free lists, as production implementations do.
"""

from __future__ import annotations

import itertools
import threading

from .ticket import pause

_lock_ids = itertools.count(1)


class _QNode:
    __slots__ = ("locked", "next")

    def __init__(self) -> None:
        self.locked = False
        self.next: "_QNode | None" = None


_tls = threading.local()


def _node_freelist() -> list:
    fl = getattr(_tls, "freelist", None)
    if fl is None:
        fl = _tls.freelist = []
    return fl


class MCSLock:
    """Classic MCS list-based queue lock."""

    name = "mcs"

    def __init__(self) -> None:
        self.lock_id = next(_lock_ids) << 7
        self._tail: _QNode | None = None
        self._tail_mutex = threading.Lock()  # emulates atomic SWAP/CAS on tail
        # POSIX-style: owner's node recorded in the lock instance (paper §1).
        self._owner_node: _QNode | None = None

    # -- emulated atomics on the tail pointer ------------------------------
    def _swap_tail(self, node: "_QNode") -> "_QNode | None":
        with self._tail_mutex:
            old = self._tail
            self._tail = node
            return old

    def _cas_tail(self, expected: "_QNode | None", new: "_QNode | None") -> bool:
        with self._tail_mutex:
            if self._tail is expected:
                self._tail = new
                return True
            return False

    # -- protocol -----------------------------------------------------------
    def acquire(self) -> None:
        fl = _node_freelist()
        node = fl.pop() if fl else _QNode()
        node.locked = True
        node.next = None
        pred = self._swap_tail(node)
        if pred is not None:
            pred.next = node
            it = 0
            while node.locked:  # local spinning on our own node
                pause(it)
                it += 1
        self._owner_node = node

    def release(self) -> None:
        node = self._owner_node
        assert node is not None, "release of an unheld MCS lock"
        self._owner_node = None
        if node.next is None:
            # No visible successor: try to detach our node (CAS).
            if self._cas_tail(node, None):
                _node_freelist().append(node)
                return
            it = 0
            while node.next is None:  # successor mid-enqueue; wait for link
                pause(it)
                it += 1
        node.next.locked = False  # handover: store into successor's flag
        _node_freelist().append(node)

    def locked(self) -> bool:
        return self._tail is not None

    def __enter__(self) -> "MCSLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
