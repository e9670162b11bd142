"""Property-based tests (hypothesis) of the port's waiting-array hash and
atomic cell: the reference's ``tests/test_locks_properties.py`` run against
``repro_torch.core``, each hash also equal to the reference's.

Skipped wholesale when hypothesis is not installed; the deterministic
lock tests live in ``test_torch_locks.py``."""

import pytest

pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro_torch.core import DEFAULT_ARRAY_SIZE, twa_hash  # noqa: E402
from repro_torch.core.atomics import AtomicU64  # noqa: E402
from repro_torch.core.hashing import sector_of  # noqa: E402


@given(lock_id=st.integers(0, 2**48), ticket=st.integers(0, 2**32),
       log_size=st.integers(4, 16))
def test_hash_in_range_and_deterministic(lock_id, ticket, log_size):
    size = 1 << log_size
    h1 = twa_hash(lock_id, ticket, size)
    h2 = twa_hash(lock_id, ticket, size)
    assert h1 == h2 == ref_core.twa_hash(lock_id, ticket, size)
    assert 0 <= h1 < size


@given(lock_id=st.integers(0, 2**48), ticket=st.integers(0, 2**32 - 2))
def test_hash_adjacent_tickets_different_sectors(lock_id, ticket):
    a = twa_hash(lock_id, ticket, DEFAULT_ARRAY_SIZE)
    b = twa_hash(lock_id, ticket + 1, DEFAULT_ARRAY_SIZE)
    assert sector_of(a) != sector_of(b)


@given(lock_id=st.integers(0, 2**48))
@settings(max_examples=25)
def test_hash_equidistribution_over_window(lock_id):
    hits = {twa_hash(lock_id, t, DEFAULT_ARRAY_SIZE)
            for t in range(DEFAULT_ARRAY_SIZE)}
    assert len(hits) == DEFAULT_ARRAY_SIZE


@given(lock_a=st.integers(0, 2**24), lock_b=st.integers(0, 2**24))
@settings(max_examples=50)
def test_hash_decorrelates_entrained_locks(lock_a, lock_b):
    la, lb = lock_a << 7, lock_b << 7  # sector-aligned pseudo-addresses
    if (la ^ lb) & (DEFAULT_ARRAY_SIZE - 1) == 0:
        return  # masked-equal addresses entrain by construction
    collisions = sum(
        twa_hash(la, t, DEFAULT_ARRAY_SIZE) == twa_hash(lb, t, DEFAULT_ARRAY_SIZE)
        for t in range(256)
    )
    assert collisions < 256


@given(start=st.integers(0, 2**64 - 1),
       deltas=st.lists(st.integers(0, 2**16), max_size=50))
def test_atomic_fetch_add_sequential_semantics(start, deltas):
    cell = AtomicU64(start)
    acc = start
    for d in deltas:
        old = cell.fetch_add(d)
        assert old == acc & AtomicU64.MASK
        acc += d
    assert cell.load() == acc & AtomicU64.MASK


@given(v=st.integers(0, 2**64 - 1), e=st.integers(0, 2**64 - 1),
       n=st.integers(0, 2**64 - 1))
def test_cas_semantics(v, e, n):
    cell = AtomicU64(v)
    observed = cell.compare_and_swap(e, n)
    assert observed == v
    assert cell.load() == (n if v == e else v)
