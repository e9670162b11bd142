"""The paper's host-side pieces the serve path needs: the atomic cell, the
waiting-array hash and the shared waiting array (copies of the reference's
``repro.core`` modules of the same names; the port imports nothing of it).
"""

from .atomics import AtomicU64
from .hashing import DEFAULT_ARRAY_SIZE, sector_of, twa_hash
from .waiting_array import WaitingArray, global_waiting_array

__all__ = ["AtomicU64", "DEFAULT_ARRAY_SIZE", "WaitingArray",
           "global_waiting_array", "sector_of", "twa_hash"]
