"""The TWA waiting-array hash (paper §2).

``index = ((ticket * 127) XOR lock_id) & (ArraySize - 1)``

* P = 127 is a small prime giving Weyl-sequence equidistribution and defeating
  stride-based hardware prefetch (paper: "thwart the automatic stride-based
  hardware prefetch mechanism").  ``x * 127`` strength-reduces to
  ``(x << 7) - x``.
* XOR-ing the lock id decorrelates locks whose ticket/grant advance in unison
  ("entrained" locks), reducing inter-lock collisions.
* Adjacent tickets land in different 128-byte sectors: with 8-byte slots a
  sector holds 16 slots, and stride 127 ≡ 15 (mod 16) walks sectors.
"""

from __future__ import annotations

DEFAULT_ARRAY_SIZE = 4096
WEYL_PRIME = 127
SECTOR_BYTES = 128
SLOT_BYTES = 8
SLOTS_PER_SECTOR = SECTOR_BYTES // SLOT_BYTES  # 16


def twa_hash(lock_id: int, ticket: int, array_size: int = DEFAULT_ARRAY_SIZE) -> int:
    """Map a (lock, ticket) pair to a waiting-array slot index.

    ``array_size`` must be a power of two (masked, not modded, as in the paper).
    """
    assert array_size & (array_size - 1) == 0, "array_size must be a power of two"
    return ((ticket * WEYL_PRIME) ^ lock_id) & (array_size - 1)


def sector_of(index: int) -> int:
    """128-byte sector number of a slot index (false-sharing granularity)."""
    return index // SLOTS_PER_SECTOR
