"""The port's host-side locks (``repro_torch.core``) against the reference's
tests of them and against the reference itself.

The reference's ``tests/test_locks_threads.py``, ``test_locks_properties.py``
(hypothesis) and ``test_complexity.py`` run here against the port's copies,
every thread joined with a timeout (a wedged lock fails the test, never
hangs it).  Table 1's rows from the port's classes must equal the
reference's ``table1()`` row for row (the copies keep the reference's
control flow; the measure reads each method's AST), and ``make_lock``
must honour ``$REPRO_LOCK`` and refuse unknown kinds as the reference's
does.  Tolerance: exact.
"""

import dataclasses
import threading
import time

import pytest

pytest.importorskip("torch")

import repro.core as ref_core
from repro.core.complexity import table1 as ref_table1
from repro_torch.core import (LOCK_CLASSES, AndersonLock, MCSLock,
                              TicketLock, TWALock, TWAStagedLock,
                              WaitingArray, make_lock)
from repro_torch.core import complexity
from repro_torch.core.complexity import cyclomatic, npath, table1

N_THREADS = 8
ITERS = 200
JOIN_S = 30.0
ALL_KINDS = sorted(LOCK_CLASSES)


def _run_threads(target, n: int) -> None:
    """Start ``n`` threads of ``target`` and join each within JOIN_S; a
    thread still running then is a wedged lock."""
    threads = [threading.Thread(target=target, daemon=True)
               for _ in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = sum(t.is_alive() for t in threads)
    assert not alive, f"{alive} of {n} threads still waiting after {JOIN_S} s"


def _hammer(lock, n_threads=N_THREADS, iters=ITERS):
    """n_threads × iters lock-protected increments; returns (counter, orders)."""
    counter = {"v": 0}
    admit_order = []
    errors = []

    def body():
        try:
            for _ in range(iters):
                lock.acquire()
                v = counter["v"]
                # A data race here is what mutual exclusion must prevent.
                counter["v"] = v + 1
                admit_order.append(threading.get_ident())
                lock.release()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    _run_threads(body, n_threads)
    assert not errors, errors
    return counter["v"], admit_order


def test_lock_classes_are_the_references():
    assert {k: v.__name__ for k, v in LOCK_CLASSES.items()} == \
        {k: v.__name__ for k, v in ref_core.LOCK_CLASSES.items()}
    assert all(v.__module__.startswith("repro_torch.core.")
               for v in LOCK_CLASSES.values())
    import repro_torch.core as port_core
    assert sorted(port_core.__all__) == sorted(ref_core.__all__)


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_mutual_exclusion(kind):
    lock = make_lock(kind)
    total, _ = _hammer(lock)
    assert total == N_THREADS * ITERS


@pytest.mark.parametrize("cls", [TicketLock, TWALock])
def test_fifo_admission_order(cls):
    """Ticket-based locks admit strictly in assigned-ticket order."""
    lock = cls()
    order = []
    barrier = threading.Barrier(N_THREADS)

    def body():
        barrier.wait()
        for _ in range(ITERS // 4):
            tx = lock.acquire()
            order.append(tx)
            lock.release()

    _run_threads(body, N_THREADS)
    assert order == sorted(order), "admission must follow ticket order"
    assert order == list(range(len(order)))


def test_twa_uses_long_term_waiting_under_contention():
    """Deterministic pile-up: hold the lock while N waiters arrive; all but
    the immediate successor must take the long-term (waiting-array) path."""
    lock = TWALock(waiting_array=WaitingArray(256))
    lock.acquire()  # owner
    n_waiters = 6
    done = []

    def waiter():
        lock.acquire()
        done.append(1)
        lock.release()

    threads = [threading.Thread(target=waiter, daemon=True)
               for _ in range(n_waiters)]
    for t in threads:
        t.start()
    # Wait until every waiter has taken its ticket.
    deadline = time.monotonic() + JOIN_S
    while lock.ticket.load() < n_waiters + 1:
        assert time.monotonic() < deadline, "waiters never drew tickets"
        time.sleep(0.001)
    lock.release()
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads)
    assert len(done) == n_waiters
    # With threshold=1: exactly one short-term successor at arrival time,
    # the rest saw dx > 1 and entered long-term waiting.
    assert lock.long_term_entries >= n_waiters - 2
    assert lock.array.notify_count == n_waiters + 1  # one notify per release


def test_twa_fast_path_no_array_traffic():
    """Uncontended TWA never touches the waiting array on acquire."""
    arr = WaitingArray(256)
    lock = TWALock(waiting_array=arr)
    for _ in range(50):
        lock.acquire()
        lock.release()
    assert lock.long_term_entries == 0
    assert lock.short_term_entries == 0


@pytest.mark.parametrize("cls", [TWALock, TWAStagedLock])
def test_twa_shared_array_between_locks(cls):
    """Locks sharing one array (the paper's design) stay correct."""
    arr = WaitingArray(64)  # tiny array -> frequent inter-lock collisions
    locks = [cls(waiting_array=arr) for _ in range(4)]
    counters = [0] * 4

    def body():
        for i in range(100):
            k = i % 4
            locks[k].acquire()
            counters[k] += 1
            locks[k].release()

    _run_threads(body, 6)
    assert counters == [150] * 4


def test_mcs_queue_node_reuse():
    lock = MCSLock()
    for _ in range(10):
        with lock:
            pass
    assert not lock.locked()


def test_anderson_bounded_threads():
    lock = AndersonLock(max_threads=16)
    total, _ = _hammer(lock, n_threads=4, iters=50)
    assert total == 200


def test_ticket_waiters_metric():
    lock = TicketLock()
    lock.acquire()
    assert lock.waiters() == 0
    assert lock.locked()
    lock.release()
    assert not lock.locked()


# ---------------------------------------------------------------------------
# make_lock and $REPRO_LOCK, against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("env", [None, *ALL_KINDS])
def test_make_lock_honours_env(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("REPRO_LOCK", raising=False)
    else:
        monkeypatch.setenv("REPRO_LOCK", env)
    port, ref = make_lock(), ref_core.make_lock()
    assert type(port).__name__ == type(ref).__name__
    assert port.name == ref.name == (env or "twa")
    # an explicit kind wins over the environment
    assert make_lock("mcs").name == "mcs"


@pytest.mark.parametrize("kind", ["", "spin", "TWA"])
def test_make_lock_rejects_unknown_kinds_alike(monkeypatch, kind):
    monkeypatch.setenv("REPRO_LOCK", kind or "nope")
    with pytest.raises(ValueError) as ref_err:
        ref_core.make_lock(kind or None)
    with pytest.raises(ValueError) as port_err:
        make_lock(kind or None)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# Table 1 (the reference's test_complexity.py, and row-for-row equality)
# ---------------------------------------------------------------------------
def test_table1_equals_the_references_row_for_row():
    port, ref = table1(), ref_table1()
    assert [dataclasses.asdict(r) for r in port] == \
        [dataclasses.asdict(r) for r in ref]
    # the port's rows measure the port's classes, not the reference's
    src = complexity.inspect.getsourcefile(TWALock.acquire)
    assert "repro_torch" in src


def test_complexity_table_matches_paper_ordering():
    """Table 1's *ordering* claim: unlock complexity is 1 for all; TWA's lock
    path is more complex than ticket but of the same small order (the paper's
    contrast is TWA=6 vs qspinlock=18 cyclomatic)."""
    rows = {r.algorithm: r for r in table1()}
    for name in ("ticket", "twa"):
        assert rows[name].cyclomatic_unlock == 1
        assert rows[name].npath_unlock == 1
    assert rows["ticket"].cyclomatic_lock == 2  # exactly the paper's value
    assert rows["ticket"].cyclomatic_lock < rows["twa"].cyclomatic_lock <= 10
    assert rows["ticket"].npath_lock < rows["twa"].npath_lock


def test_cyclomatic_counts_decisions():
    def f(x):
        if x > 0:
            while x:
                x -= 1
        return x

    assert cyclomatic(f) == 3
    assert npath(f) >= 3


# ---------------------------------------------------------------------------
# The coordination stores and the distributed locks over them
# ---------------------------------------------------------------------------
from repro_torch.core import (DistributedTicketLock,  # noqa: E402
                              DistributedTWALock, InMemoryKVStore,
                              LeaseGuard, recover_dead_holder)


def _store(kind, tmp_path, ref=False):
    mod = ref_core if ref else __import__("repro_torch.core",
                                          fromlist=["core"])
    if kind == "memory":
        return mod.InMemoryKVStore()
    return mod.FileKVStore(str(tmp_path / ("ref" if ref else "port")))


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_kv_store_ops_equal_the_references(kind, tmp_path):
    """One sequence of gets, sets, fetch-adds and CASes: the answers of the
    reference's in-memory store (and, in memory, the same per-key read and
    write counts).  The reference's file store is not run: its
    ``compare_and_swap`` waits forever on its own key lock when the swap
    succeeds (ROADMAP §3), which the port's copy repairs."""
    ops = [("get", "a", 5), ("set", "a", 3), ("fetch_add", "a", 4),
           ("get", "a", 0), ("compare_and_swap", "a", 7, 9),
           ("get", "a", 0), ("compare_and_swap", "a", 1, 2),
           ("fetch_add", "b/c", -2), ("get", "b/c", 0), ("set", "b/c", 11),
           ("get", "b/c", 0), ("get", "missing", -1)]
    port, ref = _store(kind, tmp_path), _store("memory", tmp_path, ref=True)
    for op, *args in ops:
        assert getattr(port, op)(*args) == getattr(ref, op)(*args), op
    if kind == "memory":
        assert dict(port.read_counts) == dict(ref.read_counts)
        assert dict(port.write_counts) == dict(ref.write_counts)
        assert port.hot_keys(2) == ref.hot_keys(2)
        port.reset_counts()
        assert not port.read_counts and not port.write_counts


@pytest.mark.parametrize("kind", ["memory", "file"])
@pytest.mark.parametrize("cls", [DistributedTicketLock, DistributedTWALock])
def test_distributed_lock_mutual_exclusion_and_fifo(cls, kind, tmp_path):
    store = _store(kind, tmp_path)
    lock = cls(store, "job")
    counter, order = [0], []

    def body():
        for _ in range(5):
            tx = lock.acquire()
            v = counter[0]
            time.sleep(0.0005)
            counter[0] = v + 1
            order.append(tx)
            lock.release()

    _run_threads(body, 6)
    assert counter[0] == 30
    assert order == list(range(30))
    assert store.get("job/ticket") == store.get("job/grant") == 30


def test_distributed_twa_parks_waiters_off_the_grant_key():
    """Waiters queued behind a held lock poll their hashed slot keys, and
    the grant key's reads stay below the ticket lock's under the same
    queue (the hot-key bound the admission suite reports)."""
    reads = {}
    for cls in (DistributedTicketLock, DistributedTWALock):
        store = InMemoryKVStore()
        lock = cls(store, "q")
        lock.acquire()
        done = []

        def waiter():
            lock.acquire()
            done.append(1)
            lock.release()

        threads = [threading.Thread(target=waiter, daemon=True)
                   for _ in range(6)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + JOIN_S
        while store.get("q/ticket") < 7:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        time.sleep(0.05)            # the queue polls while the lock is held
        lock.release()
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        assert len(done) == 6
        reads[cls.name] = (store.read_counts["q/grant"], sum(
            v for k, v in store.read_counts.items()
            if k.startswith("twa/wa/")))
    assert reads["dist-twa"][1] > 0 and reads["dist-ticket"][1] == 0
    assert reads["dist-ticket"][0] > reads["dist-twa"][0]


def test_lease_guard_and_dead_holder_recovery():
    store = InMemoryKVStore()
    lock = DistributedTWALock(store, "ck")
    lease = LeaseGuard(store, "ck", ttl_s=0.5)
    lock.acquire()                       # the holder, about to die
    lease.start()
    assert not lease.expired()
    assert recover_dead_holder(store, "ck", lease, lock) is False
    lease.stop()                         # the holder dies: no more renewals
    time.sleep(1.1)
    assert lease.expired()
    got = []
    t = threading.Thread(target=lambda: got.append(lock.acquire()),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + JOIN_S
    while store.get("ck/ticket") < 2:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    assert recover_dead_holder(store, "ck", lease, lock) is True
    t.join(JOIN_S)
    assert got == [1] and store.get("ck/grant") == 1
