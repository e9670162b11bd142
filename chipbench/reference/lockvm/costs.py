"""Coherence cost model for the lockVM (cycles).

A frozen copy of the program's ``repro_torch.sim`` module of this name,
kept beside the benchmark as its yardstick.

The single load-bearing term is ``C_INV``: a store to a line cached by ``k``
remote sharers costs ``C_STORE_SHARED + k * C_INV`` — the *invalidation
diameter* effect of the paper's Figure 1.  The remaining constants are set to
plausible x86 ratios (L1 hit ≈ 2 cy, cross-socket transfer ≈ 90 cy, locked RMW
≈ +30 cy); the validation targets are the *curve shapes and crossovers* of the
paper's figures, not the X5-2's absolute ops/s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Costs:
    C_LOCAL: int = 1        # register op / branch
    C_HIT: int = 2          # load, line already cached
    C_MISS: int = 60        # load, line in memory / clean remote
    C_XFER: int = 90        # load, dirty line in a remote cache
    C_STORE_OWNED: int = 3  # store, line exclusively owned
    C_STORE_SHARED: int = 20  # store needing ownership (RFO), before invals
    C_INV: int = 12         # per remote sharer invalidated  <-- Figure 1
    C_ATOMIC: int = 30      # extra for LOCK'd RMW
    C_WAKE: int = 4         # restart latency after a watched line changes
    # (the refill itself is charged when the woken SPIN re-executes: the line
    #  is then dirty in the storer's cache -> C_XFER, or C_MISS thereafter)

    def to_array(self) -> np.ndarray:
        return np.asarray(
            [self.C_LOCAL, self.C_HIT, self.C_MISS, self.C_XFER,
             self.C_STORE_OWNED, self.C_STORE_SHARED, self.C_INV,
             self.C_ATOMIC, self.C_WAKE],
            dtype=np.int32,
        )


# indices into the cost array (engine-side)
I_LOCAL, I_HIT, I_MISS, I_XFER, I_ST_OWNED, I_ST_SHARED, I_INV, I_ATOMIC, I_WAKE = range(9)

DEFAULT_COSTS = Costs()
